"""Share of the traced training window in which no operation ran on the
device, in %
(`readers.idle_share`)."""
from portbench.readers import idle_share as read  # noqa: F401
