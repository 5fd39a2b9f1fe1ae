"""``k1_roofline.fleet`` (kernels layer), in the fleet cell, a tick counting its vehicles' scans:
``portbench.readers.k1_roofline``."""

from portbench.readers import k1_roofline as read  # noqa: F401
