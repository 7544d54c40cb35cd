"""``moe_kept_pct``: the (token, expert) pairs the MoE layers kept within
their experts' capacity over those routed, every layer of every forward
of the traced rounds, in percent (the port's counters
``repro_torch.moe.pairs_kept`` and ``.pairs_routed``).  Nothing for a
model without experts, or where the program records no such counters or
lost a span (:mod:`cpcbench.spans`)."""

from cpcbench import spans


def read(run):
    if run.model["family"] != "moe":
        return None
    trace = spans.trace(run)
    if trace is None:
        return None
    routed = trace.counters.get("repro_torch.moe.pairs_routed")
    kept = trace.counters.get("repro_torch.moe.pairs_kept")
    return 100.0 * kept / routed if routed and kept is not None else None
