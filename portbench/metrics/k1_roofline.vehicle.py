"""``k1_roofline.vehicle`` (kernels layer), in the single-vehicle cells:
``portbench.readers.k1_roofline``."""

from portbench.readers import k1_roofline as read  # noqa: F401
