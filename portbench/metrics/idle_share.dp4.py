"""Share of rank 0's traced training window in which no operation ran on
its device, in %, in the data-parallel training cells
(`readers.idle_share`)."""
from portbench.readers import idle_share as read  # noqa: F401
