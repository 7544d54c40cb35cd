"""Entitlement waterfill: reservation/limit/shares divvy.

A VM's allocation is at least its floor, at most its ceiling, with the
slack divided in proportion to shares (weighted max-min fairness).  Two
layouts, each with a kernel on the GPU and its plain version on the CPU
(:mod:`repro_torch.kernels.powercap.ops`):

* :func:`waterfill_dense` -- dense ``(..., H, J)`` slot columns, kernel K1:
  the batched engine's tick delivery;
* :func:`batched_waterfill` -- flat item columns grouped by ``seg_ids``,
  kernel K3 over their CSR layout: the vector engine's tick delivery and
  the object plane's entitlement sums.

:func:`waterfill_core` is the reference's segment form written out with
per-segment scatter sums; it is an oracle for the tests, not a path of the
engines (on CUDA its float scatter-adds would run in no fixed order).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels import clip
from repro_torch.kernels.powercap.ops import (waterfill_dense,
                                              waterfill_segmented)

__all__ = ["batched_waterfill", "waterfill_core", "waterfill_dense"]


def waterfill_core(capacity, floors, ceilings, weights, seg_ids,
                   n_segs: int, iters: int = 200):
    """Lockstep waterfill of items grouped by ``seg_ids`` (``(n,)`` int64
    in ``[0, n_segs)``) against ``capacity (n_segs,)``: every segment
    bisects its water level for ``iters`` trips, then a pro-rata residual
    bump; segments whose floors reach the capacity get pro-rata floors.
    ``weights`` must be bounded away from zero."""
    def seg_sum(x):
        return torch.zeros(n_segs, dtype=x.dtype,
                           device=x.device).index_add_(0, seg_ids, x)

    ceilings = torch.maximum(ceilings, floors)
    total_floor = seg_sum(floors)
    degenerate = total_floor >= capacity
    target = torch.minimum(capacity, seg_sum(ceilings))
    hi = torch.zeros(n_segs, dtype=floors.dtype,
                     device=floors.device).scatter_reduce(
        0, seg_ids, ceilings / weights, "amax") + 1.0
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        under = seg_sum(clip(weights * mid[seg_ids], floors,
                             ceilings)) < target
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    out = clip(weights * hi[seg_ids], floors, ceilings)

    gap = target - seg_sum(out)
    w_room = weights * ((ceilings - out) > 1e-12)
    w_room_sum = seg_sum(w_room)
    adjust = (gap > 1e-12) & (w_room_sum > 0.0)
    bump = torch.where(adjust[seg_ids],
                       gap[seg_ids] * w_room
                       / torch.clamp_min(w_room_sum[seg_ids], 1e-300), 0.0)
    out = clip(out + bump, floors, ceilings)

    scale = capacity / torch.clamp_min(total_floor, 1e-12)
    return torch.where(degenerate[seg_ids], floors * scale[seg_ids], out)


def batched_waterfill(capacity, floors, ceilings, weights, seg_ids=None,
                      n_segs=None, iters: int = 200, *, layout=None,
                      device=None):
    """Weighted max-min allocation over many independent hosts at once:
    item columns ``(n,)`` grouped by ``seg_ids`` (or a prebuilt ``layout``
    of them), returned in item order.  Weights are floored at 1e-12, as
    the reference does before its segmented kernel."""
    if isinstance(weights, torch.Tensor):
        weights = torch.clamp_min(weights, 1e-12)
    else:
        weights = np.maximum(np.asarray(weights, dtype=np.float64), 1e-12)
    return waterfill_segmented(capacity, floors, ceilings, weights, seg_ids,
                               n_segs, iters, layout=layout, device=device)
