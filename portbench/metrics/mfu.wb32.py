"""The served model step's share of the chip's float32 peak, in %, in the
serving cells that report `images_per_s.wb32`
(`readers.serve_mfu`)."""
from portbench.readers import serve_mfu as read  # noqa: F401
