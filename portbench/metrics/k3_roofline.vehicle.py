"""``k3_roofline.vehicle`` (kernels layer), in the single-vehicle cells:
``portbench.readers.k3_roofline``."""

from portbench.readers import k3_roofline as read  # noqa: F401
