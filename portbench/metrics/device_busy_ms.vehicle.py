"""``device_busy_ms.vehicle`` (pipeline layer), in the single-vehicle cells:
``portbench.readers.device_busy_ms``."""

from portbench.readers import device_busy_ms as read  # noqa: F401
