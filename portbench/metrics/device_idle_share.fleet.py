"""``device_idle_share.fleet`` (device layer), in
the fleet cell, a tick counting its vehicles' scans:
``portbench.readers.device_idle_share``."""

from portbench.readers import device_idle_share as read  # noqa: F401
