"""``device_busy_ms.fleet`` (pipeline layer), in
the fleet cell, a tick counting its vehicles' scans:
``portbench.readers.device_busy_ms``."""

from portbench.readers import device_busy_ms as read  # noqa: F401
