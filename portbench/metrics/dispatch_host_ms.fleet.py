"""``dispatch_host_ms.fleet`` (parallel fleet layer): mean host milliseconds
of the benchmark's span around the ``FleetStep`` call a tick over the
window: for each block in turn, one a card, its vehicles' scan scalars,
their copy and the batched replay's enqueue; then the summary's sums."""

from portbench.readers import host_span_ms


def read(cx):
    return host_span_ms(cx, "fleet.step")
