"""``activities_per_scan.vehicle`` (pipeline layer), in the single-vehicle cells:
``portbench.readers.activities_per_scan``."""

from portbench.readers import activities_per_scan as read  # noqa: F401
