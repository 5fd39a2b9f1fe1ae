"""``fleet_scalars_host_ms.fleet`` (parallel fleet layer): host
milliseconds a tick of the program's span ``fleet.scalars`` (``FleetStep``'s
per-vehicle loop: the centers to NumPy, the vehicle's scan, its scan
scalars), in the traced stretch of ``portbench.program_trace``."""

from portbench.program_trace import host_ms


def read(cx):
    return host_ms(cx, "fleet.scalars", per="fleet.tick")
