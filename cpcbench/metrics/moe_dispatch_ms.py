"""``moe_dispatch_ms``: the stream time of the MoE layer's routing,
dispatch and combine (the port's ``repro_torch.moe.route``, ``.dispatch``
and ``.combine`` spans; the expert FFN on K7 left out), summed over the
traced rounds, per batch, in ms.  Nothing for a model without experts, or
where the program records no such spans or lost any
(:mod:`cpcbench.spans`)."""

from cpcbench import spans


def read(run):
    if run.model["family"] != "moe" or not run.batches:
        return None
    route, dispatch, _, combine = spans.MOE_PHASES
    found = spans.named(run, route, dispatch, combine)
    return sum(s.ms for s in found) / len(run.batches) if found else None
