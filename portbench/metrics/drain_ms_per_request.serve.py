"""The deploy loop's drain a request, in ms, in the serving cells that
report `latency_p95_ms`
(`readers.drain_ms_per_request`)."""
from portbench.readers import drain_ms_per_request as read  # noqa: F401
