"""``decode_graph_pct``: the share of the traced batches' decode steps that
a replay of a captured CUDA graph served (the port's counter
``repro_torch.serve.decode_replays`` over the decode steps the traced
rounds hold), in percent.  Nothing where the program records no such
counter or lost a span (:mod:`cpcbench.spans`)."""

from cpcbench import spans

REPLAYS = "repro_torch.serve.decode_replays"


def read(run):
    steps = sum(s - 1 for _, _, s in run.batches)
    trace = spans.trace(run)
    if trace is None or not steps:
        return None
    replays = trace.counters.get(REPLAYS)
    return None if replays is None else 100.0 * replays / steps
