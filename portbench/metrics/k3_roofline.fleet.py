"""``k3_roofline.fleet`` (kernels layer), in the fleet cell, a tick counting its vehicles' scans:
``portbench.readers.k3_roofline``."""

from portbench.readers import k3_roofline as read  # noqa: F401
