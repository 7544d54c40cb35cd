"""Entitlement waterfill: reservation/limit/shares divvy.

A VM's allocation is at least its floor, at most its ceiling, with the
slack divided in proportion to shares (weighted max-min fairness).  Two
layouts, each with a kernel on the GPU and its plain version on the CPU
(:mod:`repro_torch.kernels.powercap.ops`):

* :func:`waterfill_dense` -- dense ``(..., H, J)`` slot columns, kernel K1:
  the batched engine's tick delivery;
* :func:`batched_waterfill` -- flat item columns grouped by ``seg_ids``,
  kernel K3 over their CSR layout: the vector engine's tick delivery and
  the object plane's entitlement sums; :func:`deliver_hosts` is the
  delivery over VM objects on many hosts, the legacy engine's tick, and
  :func:`deliver` its one-host case;
* :func:`waterfill` -- one host's items, K3 with one segment and the
  reference's 200 trips; :func:`divvy` is the entitlement over a host's
  VM objects.

:func:`waterfill_core` is the reference's segment form written out with
per-segment scatter sums; it is an oracle for the tests, not a path of the
engines (on CUDA its float scatter-adds would run in no fixed order).
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Sequence

from repro_torch.backend import resolve_device
from repro_torch.core.kernels import clip
from repro_torch.kernels.powercap.ops import (waterfill_dense,
                                              waterfill_segmented)

__all__ = ["batched_waterfill", "deliver", "deliver_hosts", "divvy",
           "waterfill", "waterfill_core", "waterfill_dense"]


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


def waterfill(capacity: float, floors, ceilings, weights, device=None):
    """Weighted max-min allocation of one host's ``capacity`` to its items:
    ``x_i = clip(weights_i * level, floors_i, ceilings_i)`` with ``sum(x)
    == min(capacity, sum(ceilings))``, or pro-rata floors when the floors
    alone reach the capacity.  The reference's scalar primitive
    (``repro.drs.entitlement.waterfill``, 200 bisection trips and a
    pro-rata residual bump), run as K3 over one segment on ``device``
    (``None``: the GPU; tensors run where they lie).  Returns a float64
    NumPy array in item order."""
    dev = (floors.device if isinstance(floors, torch.Tensor)
           else resolve_device(device))

    def col(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)
                               if not isinstance(x, torch.Tensor) else x,
                               dtype=torch.float64, device=dev).reshape(-1)

    fl, ce, w = col(floors), col(ceilings), col(weights)
    if fl.numel() == 0:
        return np.zeros(0)
    seg = np.zeros(fl.numel(), dtype=np.int64)
    out = batched_waterfill(col([float(capacity)]), fl, ce, w, seg, 1,
                            iters=200, device=dev)
    return out.cpu().numpy()


def divvy(capacity: float, vms: Sequence, device=None) -> dict[str, float]:
    """Per-VM entitlements on one host: floor ``min(reservation, limit)``
    (guaranteed even when idle), ceiling the effective demand, weight the
    shares."""
    if not vms:
        return {}
    x = waterfill(capacity, [min(v.reservation, v.limit) for v in vms],
                  [v.effective_demand for v in vms],
                  [v.shares for v in vms], device)
    return {v.vm_id: float(xi) for v, xi in zip(vms, x)}


def deliver_hosts(capacity, vms: Sequence, layout=None, weights=None,
                  device=None) -> dict[str, float]:
    """What each VM receives this tick, on many hosts at once: ``vms`` in
    item order, one segment a host by ``layout`` (a
    :func:`~repro_torch.kernels.powercap.segments.segment_layout`;
    ``None``: all on one host), ``capacity`` one a host.  Unlike an
    entitlement, never above instantaneous demand (a reserved but idle VM
    burns no cycles); reservations are honored when demanded.
    ``weights``: the VMs' shares as a column already on the layout's
    device (``None``: read from ``vms``).  One waterfill over every host,
    on the layout's device (``None``: ``device``, the GPU by default)."""
    if not vms:
        return {}
    dev = layout.device if layout is not None else resolve_device(device)
    seg = None if layout is not None else np.zeros(len(vms), dtype=np.int64)
    dem = np.array([min(v.demand, v.limit) for v in vms])
    floors = np.minimum(np.array([v.reservation for v in vms]), dem)
    if weights is None:
        weights = np.array([v.shares for v in vms], dtype=np.float64)
    x = batched_waterfill(
        torch.as_tensor(np.atleast_1d(np.asarray(capacity, dtype=np.float64)),
                        device=dev),
        torch.as_tensor(floors, device=dev), torch.as_tensor(dem, device=dev),
        weights, seg, 1, layout=layout, device=dev).cpu().numpy()
    return {v.vm_id: float(xi) for v, xi in zip(vms, x)}


def deliver(capacity: float, vms: Sequence, device=None) -> dict[str, float]:
    """What each VM on one host receives this tick: :func:`deliver_hosts`
    for one host."""
    return deliver_hosts([capacity], vms, device=device)
