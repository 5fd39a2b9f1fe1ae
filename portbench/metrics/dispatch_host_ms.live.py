"""``dispatch_host_ms.live`` (runtime layer): mean host milliseconds of the
benchmark's span around ``StreamingDriver.dispatch`` a scan over the window:
the pose check, host prep through ``pad_scan``, the scan scalars, the copy
and the replay's enqueue."""

from portbench.readers import host_span_ms


def read(cx):
    return host_span_ms(cx, "dispatch")
