"""``dispatch_host_ms.fleet`` (parallel fleet layer): mean host milliseconds
of the benchmark's span around the ``FleetStep`` call a tick over the
window: every vehicle's scan scalars, their copy, the batched replay's
enqueue and the summary's sums."""

from portbench.readers import host_span_ms


def read(cx):
    return host_span_ms(cx, "fleet.step")
