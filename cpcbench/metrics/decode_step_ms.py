"""``decode_step_ms``: the median stream time of the traced batches'
decode steps (the port's ``repro_torch.serve.decode_step`` spans: one
forward over one token a request and its greedy argmax), in ms.  Nothing
where the program records no such spans or lost any
(:mod:`cpcbench.spans`)."""

from statistics import median

from cpcbench import spans


def read(run):
    found = spans.named(run, spans.DECODE)
    return median(s.ms for s in found) if found else None
