"""``prep_host_ms.live`` (runtime layer): host milliseconds a scan of the
program's span ``runtime.prep`` (``StreamingDriver.dispatch``'s host prep
of the record: the pose, the center tracker, the padded scan and its copy),
in the traced stretch of ``portbench.program_trace``."""

from portbench.program_trace import host_ms


def read(cx):
    return host_ms(cx, "runtime.prep")
