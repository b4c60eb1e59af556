"""Importing this package fills the 'transform' registry (the config's
`dependencies` import it as the counterpart of `sc2bench_tpu.transforms`)."""
from . import codec, misc  # noqa: F401
