"""Share of the traced window in which no operation ran on the device, in
%, in the serving cells that report `images_per_s`
(`readers.idle_share`)."""
from portbench.readers import idle_share as read  # noqa: F401
