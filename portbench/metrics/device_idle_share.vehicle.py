"""``device_idle_share.vehicle`` (device layer), in the single-vehicle cells:
``portbench.readers.device_idle_share``."""

from portbench.readers import device_idle_share as read  # noqa: F401
