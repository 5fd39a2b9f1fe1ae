"""``fetch_wait_ms.vehicle`` (runtime layer): host milliseconds a scan of
the program's span ``runtime.fetch.wait`` (``StreamingDriver._finalize``'s
first copy of the labels to the host, which waits until the scan's outputs
are there), in the traced stretch of ``portbench.program_trace``."""

from portbench.program_trace import host_ms


def read(cx):
    return host_ms(cx, "runtime.fetch.wait")
