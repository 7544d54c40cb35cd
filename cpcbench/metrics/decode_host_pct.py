"""``decode_host_pct``: the host's time over the stream's, summed over
the traced batches' decode-step spans, in percent, read as
``prefill_host_pct`` is.  Above 100 by the prefill's backlog: the first
step's stream time starts once the kernels the prefill left queued have
run.  Nothing where the program records no such spans or lost any
(:mod:`cpcbench.spans`)."""

from cpcbench import spans


def read(run):
    return spans.host_pct(run, spans.DECODE)
