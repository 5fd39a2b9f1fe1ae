"""``device_idle_share.fleet`` (device layer), in
the fleet cells, a tick counting its vehicles' scans; on several cards,
the mean of the cards' idle shares:
``portbench.readers.device_idle_share``."""

from portbench.readers import device_idle_share as read  # noqa: F401
