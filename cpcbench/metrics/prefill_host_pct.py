"""``prefill_host_pct``: the host's time over the stream's, summed over
the traced batches' prefill spans, in percent.  Far below 100 the card
paces the prefill with the host idle; near 100 either the host paces it
or the launch queue is full and holds the host to the card's pace.
Nothing where the program records no such spans or lost any
(:mod:`cpcbench.spans`)."""

from cpcbench import spans


def read(run):
    return spans.host_pct(run, spans.PREFILL)
