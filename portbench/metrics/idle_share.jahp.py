"""Share of the traced window in which no operation ran on the device, in
%, in the cells that serve the joint autoregressive codec; the idle gaps
in the result's breakdown are named by the program's `codec.*` spans
(`readers.idle_share`)."""
from portbench.readers import idle_share as read  # noqa: F401
