"""Greedy hill-climbing entitlement balancing by migration (paper
Sec. IV-A): its configuration, and the search's stopping test.

The reference's search (``repro.core.kernels.balance_migrations``, through
``MigrationCore.balance``) stops before it scores any candidate when

* fewer than two hosts are on, or no host's normalized entitlement
  exceeds ``contention_threshold`` (``core/kernels.py:1270-1272``), or
* in its first round, the imbalance is at or under
  ``imbalance_threshold``, or the hottest host is not above the mean
  (``:1317-1330``).

:func:`balance` runs that test on the same entitlements (the dense
waterfill with :data:`MIGRATION_WATERFILL_ITERS` trips, kernel K1 on the
GPU) and returns ``[]`` where the reference stops.  The candidate search
itself is a later slice of the port (ROADMAP queue 1, item 6): where it
would run, :func:`balance` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels
from repro_torch.drs.arrays import dense_slot_assignment
from repro_torch.drs.entitlement import waterfill_dense

#: Bisection trips of the balancer's entitlement waterfill (the
#: reference's ``core/kernels.py:MIGRATION_WATERFILL_ITERS``).
MIGRATION_WATERFILL_ITERS = 100


@dataclasses.dataclass
class BalancerConfig:
    imbalance_threshold: float = 0.05   # target stddev of N_h
    max_moves: int = 16                 # per invocation (paper: 5-min budget)
    min_goodness: float = 1e-3          # minimum imbalance reduction per move
    # Risk-cost-benefit: a move must reduce imbalance by at least
    # cost_per_gb * mem_demand_gb to be worth the vMotion.
    cost_per_gb: float = 2e-4
    # Migrations only pay off when some host strains against its capacity.
    contention_threshold: float = 0.9


def normalized_entitlements(snapshot, device=None) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """``(ns (H,), on (H,))``: each host's entitlement sum over its managed
    capacity as the reference's balancer computes it (one ``(1, H, J)``
    dense waterfill of the resident VMs, 0 where the capacity is 0), and
    the power-state mask, as float64 and bool tensors on ``device``."""
    dev = resolve_device(device)
    av = snapshot.as_arrays(dev)
    h = av.n_hosts
    _, order, hj, slot, counts = dense_slot_assignment(snapshot, h)
    j = max(int(counts.max()) if counts.size else 0, 1)
    res = np.zeros((1, h, j))
    lim = np.full((1, h, j), np.inf)
    cpu = np.zeros((1, h, j))
    w = np.full((1, h, j), 1e-12)
    act = np.zeros((1, h, j), dtype=bool)
    res[0, hj, slot] = av.reservation[order]
    lim[0, hj, slot] = av.limit[order]
    cpu[0, hj, slot] = av.demand[order]
    w[0, hj, slot] = np.maximum(av.shares[order], 1e-12)
    act[0, hj, slot] = av.host_on[hj]
    eff = np.where(act, np.clip(cpu, res, lim), 0.0)
    floors = np.where(act, np.minimum(res, lim), 0.0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    hosts = av.host_cols(dev)
    managed = kernels.managed_capacity(hosts, t(av.power_cap[None]))
    alloc = waterfill_dense(managed, t(floors), t(eff), t(w),
                            MIGRATION_WATERFILL_ITERS, active=t(act))
    ents = torch.where(t(act), alloc, 0.0).sum(-1)
    ns = torch.where(managed > 0.0,
                     ents / torch.clamp_min(managed, 1e-300), 0.0)
    return ns[0], hosts.on[0]


def stops_in_first_round(snapshot, config: BalancerConfig,
                         device=None) -> bool:
    """True where the reference's search ends before scoring a move."""
    ns, on = normalized_entitlements(snapshot, device)
    n_on = on.sum()
    strained = torch.where(on, ns, 0.0).max()
    if int(n_on) < 2 or float(strained) <= config.contention_threshold:
        return True
    onf = on.to(ns.dtype)
    imb = kernels._masked_std(ns, onf, n_on)
    mean_n = (ns * onf).sum() / torch.clamp_min(n_on, 1)
    ns_hot = ns[torch.argmax(torch.where(on, ns, -torch.inf))]
    return bool((imb <= config.imbalance_threshold) | (ns_hot <= mean_n))


def balance(snapshot, config: Optional[BalancerConfig] = None,
            budget=None, device=None) -> list[tuple[str, str]]:
    """The moves that balance ``snapshot``: none when ``max_moves <= 0`` or
    where the reference's search stops in its first round; raises where a
    candidate search would run.  The waterfill runs on ``device``
    (``None``: the GPU)."""
    config = config or BalancerConfig()
    if config.max_moves <= 0:
        return []
    if budget is not None:
        raise NotImplementedError(
            "gated migration launches are not ported yet (ROADMAP queue 1, "
            "item 6)")
    if stops_in_first_round(snapshot, config, device):
        return []
    raise NotImplementedError(
        "migration balancing (a candidate search) is not ported yet "
        "(ROADMAP queue 1, item 6)")
