"""``mfu_pct``: the model FLOPs of the traced rounds' batches
(:func:`cpcbench.counts.model_flops`, from the shapes whatever implements
them) over their wall times the card's published bf16 peak, in percent."""

from cpcbench import counts


def read(run):
    flops = sum(counts.model_flops(run.model, b) for b in run.batches)
    if not flops:
        return None
    return 100.0 * flops / (run.wall_s * counts.PEAKS["bf16_flops_per_s"])
