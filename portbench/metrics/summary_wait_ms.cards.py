"""``summary_wait_ms.cards`` (parallel fleet layer): mean host milliseconds
of the benchmark's span ``fleet.summary`` a tick over the window, the
tick's one host read of the fleet summary: the wait for the last card's
block and the sum of the cards' counts on the first card."""

from portbench.readers import host_span_ms


def read(cx):
    return host_span_ms(cx, "fleet.summary")
