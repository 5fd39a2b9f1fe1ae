"""``activities_per_scan.fleet`` (pipeline layer), in
the fleet cell, a tick counting its vehicles' scans:
``portbench.readers.activities_per_scan``."""

from portbench.readers import activities_per_scan as read  # noqa: F401
