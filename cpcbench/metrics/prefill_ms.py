"""``prefill_ms``: the mean stream time of the traced batches' prefills
(the port's ``repro_torch.serve.prefill`` spans), in ms.  Nothing where
the program records no such spans or lost any (:mod:`cpcbench.spans`)."""

from statistics import fmean

from cpcbench import spans


def read(run):
    found = spans.named(run, spans.PREFILL)
    return fmean(s.ms for s in found) if found else None
