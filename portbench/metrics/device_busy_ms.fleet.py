"""``device_busy_ms.fleet`` (pipeline layer), in
the fleet cells, a tick counting its vehicles' scans; on several cards,
each card's own busy time summed over the cards:
``portbench.readers.device_busy_ms``."""

from portbench.readers import device_busy_ms as read  # noqa: F401
