"""Plain PyTorch versions of the powercap kernels.

They run on any device.  The wrappers in ``ops.py`` take them for tensors
on the CPU; on the card they are the oracles the kernels are held against
(``chip_smoke.py``).  The arithmetic follows the reference
(``repro.drs.entitlement.waterfill_dense_math``,
``repro.core.kernels.balance_caps``) op for op; only the order of sums
differs.
"""

from __future__ import annotations

import torch

from repro_torch.core import kernels as core_kernels


def waterfill_dense_ref(capacity, floors, ceilings, weights,
                        iters: int = 200, active=None):
    """Dense weighted max-min waterfill, one segment per ``(..., H)`` row.

    Finds ``x = clip(w * level, floor, ceil)`` per row with
    ``sum(x) == min(capacity, sum(ceil))`` by ``iters`` lockstep bisection
    trips on the water level, then a pro-rata residual bump among slots not
    pinned at their ceiling; rows whose floors alone reach the capacity get
    pro-rata floors.  ``active`` masks live slots inside the primitive, so
    stale values in inactive slots cannot widen the bisection bracket.
    """
    if active is not None:
        floors = torch.where(active, floors, 0.0)
        ceilings = torch.where(active, ceilings, 0.0)
        weights = torch.where(active, weights, 1e-12)
    ceilings = torch.maximum(ceilings, floors)
    total_floor = floors.sum(-1)
    degenerate = total_floor >= capacity
    target = torch.minimum(capacity, ceilings.sum(-1))

    hi = (ceilings / weights).amax(-1) + 1.0
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        alloc = core_kernels.clip(weights * mid[..., None], floors,
                                   ceilings)
        under = alloc.sum(-1) < target
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    out = core_kernels.clip(weights * hi[..., None], floors, ceilings)

    gap = target - out.sum(-1)
    room = (ceilings - out) > 1e-12
    w_room = weights * room
    w_room_sum = w_room.sum(-1)
    adjust = (gap > 1e-12) & (w_room_sum > 0.0)
    bump = torch.where(adjust[..., None],
                       gap[..., None] * w_room
                       / torch.clamp_min(w_room_sum, 1e-300)[..., None],
                       0.0)
    out = core_kernels.clip(out + bump, floors, ceilings)

    scale = (capacity / torch.clamp_min(total_floor, 1e-12))[..., None]
    return torch.where(degenerate[..., None], floors * scale, out)


def balance_caps_ref(hosts, caps, dense, cpu_reserved, budget, enabled,
                     params):
    """The BalancePowerCap loop over dense slot columns.

    Returns ``(caps, did, rounds)``; ``rounds`` (``int32`` per cell) counts
    the rounds each cell entered before it was done.  Rounds run until
    every cell is done or ``params.max_iters`` is reached; a done cell
    never commits again, so stopping each cell at its own ``done`` (as the
    kernel does) gives the same caps.
    """
    ck = core_kernels
    on = hosts.on
    n_on = on.sum(-1)
    peak_managed = ck.peak_managed_capacity(hosts)

    def ents_at(c):
        alloc = waterfill_dense_ref(ck.managed_capacity(hosts, c),
                                    dense.floors, dense.ceils, dense.weights,
                                    dense.iters, dense.active)
        return alloc.sum(-1)

    managed = ck.managed_capacity(hosts, caps)
    ents = ents_at(caps)
    ns = torch.where(managed > 0.0,
                     ents / torch.clamp_min(managed, 1e-300), 0.0)
    done = ~enabled | (n_on < 2)
    did = torch.zeros_like(done)
    rounds = torch.zeros(done.shape, dtype=torch.int32, device=done.device)
    for _ in range(params.max_iters):
        if bool(done.all()):
            break
        rounds += (~done).to(torch.int32)
        caps, managed, ents, ns, done, did = ck.balance_round(
            hosts, caps, managed, ents, ns, done, did, ents_at, cpu_reserved,
            budget, n_on, peak_managed, params)
    return caps, did, rounds
