"""The rANS coder's share of its roofline, in %, in the serving cells that
report `images_per_s`
(`readers.rans_roofline`)."""
from portbench.readers import rans_roofline as read  # noqa: F401
