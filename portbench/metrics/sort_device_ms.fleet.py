"""``sort_device_ms.fleet`` (pipeline layer): device milliseconds a scan of
the step's ``raster.sort`` and ``raster.check`` stages summed (the stable
sort of the cell ids, and in sorted-scan mode the sortedness check and its
fallback count), a tick's over its vehicles, from the captured step's
stage stamps in the traced stretch: ``portbench.program_trace.device_ms``.
An unsorted step runs no check: its sort alone."""

from portbench.program_trace import device_ms


def read(cx):
    parts = [device_ms(cx, stage) for stage in ("raster.sort", "raster.check")]
    found = [ms for ms in parts if ms is not None]
    return sum(found) if found else None
