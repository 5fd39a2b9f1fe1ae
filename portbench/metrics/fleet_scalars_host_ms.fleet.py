"""``fleet_scalars_host_ms.fleet`` (parallel fleet layer): host
milliseconds a tick of the program's span ``fleet.scalars`` (``FleetStep``'s
one ``scan_scalars`` pass over a block's stacked centers and scan, one
span a block, one block a card), summed over the tick's blocks, in the
traced stretch of ``portbench.program_trace``."""

from portbench.program_trace import host_ms


def read(cx):
    return host_ms(cx, "fleet.scalars", per="fleet.tick")
