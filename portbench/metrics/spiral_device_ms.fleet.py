"""``spiral_device_ms.fleet`` (pipeline layer): device milliseconds a
scan of the step's ``spiral`` stage (K3), a tick's over its vehicles, from
the captured step's stage stamps in the traced stretch:
``portbench.program_trace.device_ms``."""

from portbench.program_trace import device_ms


def read(cx):
    return device_ms(cx, "spiral")
