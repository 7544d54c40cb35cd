"""CloudPowerCap's cap allocation math on ``(S, H)`` tensors.

Plain functions on ``float64`` tensors with a leading cell axis: host
columns are ``(S, H)``, per-cell scalars ``(S,)``, dense slot columns
``(S, H, J)``.  Padded hosts have ``on == False`` and a nonzero
``power_peak - power_idle`` range, so the Eq. 3 division stays finite.

The operation order follows the reference (``repro.core.kernels``) wherever
it decides a result: the engines must agree on exact cap-change counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

#: Minimum cap delta that counts as a change (the object plane's
#: ``order_cap_changes`` emission threshold).
CAP_CHANGE_EPS = 1e-9


class HostCols(NamedTuple):
    """Static host columns, ``(S, H)`` each."""

    on: torch.Tensor               # bool: powered on
    power_idle: torch.Tensor       # Watts at 0% utilization
    power_peak: torch.Tensor       # Watts at 100% utilization
    capacity_peak: torch.Tensor    # capacity at 100% utilization, uncapped
    hyp_overhead: torch.Tensor     # Eq. 4's C_H


class BalanceParams(NamedTuple):
    """Configuration of the BalancePowerCap loop."""

    imbalance_threshold: float = 0.01
    max_iters: int = 64
    min_transfer: float = 1e-3


class DenseCols(NamedTuple):
    """Dense-slot VM entitlement columns, ``(S, H, J)`` each: the
    entitlement problem BalancePowerCap waterfills every round."""

    floors: torch.Tensor
    ceils: torch.Tensor
    weights: torch.Tensor
    active: torch.Tensor           # bool live-slot mask
    iters: int = 200


def clip(x, lo, hi):
    """``jnp.clip`` order: ``min(max(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ------------------------------------------------------------ power model
def capped_capacity(hosts: HostCols, caps):
    """Eq. 3 per host; 0 for powered-off hosts."""
    c = clip(caps, hosts.power_idle, hosts.power_peak)
    frac = (c - hosts.power_idle) / (hosts.power_peak - hosts.power_idle)
    return torch.where(hosts.on, hosts.capacity_peak * frac, 0.0)


def managed_capacity(hosts: HostCols, caps):
    """Eq. 4 per host; 0 for powered-off hosts."""
    return torch.where(
        hosts.on,
        torch.clamp_min(capped_capacity(hosts, caps) - hosts.hyp_overhead,
                        0.0),
        0.0)


def peak_managed_capacity(hosts: HostCols):
    return torch.clamp_min(hosts.capacity_peak - hosts.hyp_overhead, 0.0)


def cap_for_managed_capacity(hosts: HostCols, capacities):
    """Inverse of Eq. 4."""
    c = clip(capacities + hosts.hyp_overhead,
              torch.zeros_like(hosts.capacity_peak), hosts.capacity_peak)
    return hosts.power_idle + (hosts.power_peak - hosts.power_idle) * (
        c / hosts.capacity_peak)


def power_consumed(hosts: HostCols, utilization):
    """Eq. 1: utilization -> consumed Watts (0 when powered off)."""
    u = torch.clamp(utilization, 0.0, 1.0)
    return torch.where(hosts.on,
                       hosts.power_idle
                       + (hosts.power_peak - hosts.power_idle) * u,
                       0.0)


def reserved_floor_caps(hosts: HostCols, cpu_reserved):
    """Per-host minimum cap honoring resident reservations (paper Fig. 3
    step 1); never below idle, 0 for powered-off hosts."""
    floor = torch.maximum(cap_for_managed_capacity(hosts, cpu_reserved),
                          hosts.power_idle)
    return torch.where(hosts.on, floor, 0.0)


# ---------------------------------------------------------------- redivvy
def redivvy_caps(on, caps_start, caps_floor):
    """Algorithm 1 (RedivvyPowerCap), conserving form: hosts whose floor
    grew keep it; hosts whose floor shrank surrender the fraction ``r`` of
    their excess that funds the growth.  Powered-off hosts keep
    ``caps_start``."""
    delta = torch.where(on, caps_floor - caps_start, 0.0)
    needed = torch.where(delta > 0.0, delta, 0.0).sum(-1)
    excess = torch.where(delta > 0.0, 0.0, -delta).sum(-1)
    r = torch.clamp_max(needed / torch.clamp_min(excess, 1e-300),
                        1.0)[..., None]
    shrunk = caps_floor + (1.0 - r) * (caps_start - caps_floor)
    new = torch.where(delta > 0.0, caps_floor, shrunk)
    # Nothing grew -> every host keeps its cap; growth with no excess ->
    # every host sits at its floor.
    new = torch.where((excess > 0.0)[..., None], new, caps_floor)
    new = torch.where((needed > 0.0)[..., None], new, caps_start)
    return torch.where(on, new, caps_start)


def count_cap_changes(on, before, after):
    """Per-cell count of hosts whose cap change emits a SetPowerCap action,
    as ``int32``."""
    changed = on & ((after - before).abs() > CAP_CHANGE_EPS)
    return changed.sum(-1, dtype=torch.int32)


def entitlement_sums(hosts: HostCols, caps, vm_floors, vm_ceils,
                     vm_weights, vm_seg, iters: int = 200):
    """Per-host VM-entitlement sums at the given caps: one segmented
    waterfill over every (cell, host) at once (kernel K3 on the GPU).

    VM columns are ``(S, V)`` tensors on the device of ``caps``, with
    ``vm_seg`` (host-side, array or tensor) the resident host index.
    Segments are flattened to ``S * H``; the per-host sums are trailing-axis
    sums over the layout's rows, so they do not depend on an atomic order.
    """
    from repro_torch.drs.entitlement import batched_waterfill
    from repro_torch.kernels.powercap.segments import (row_sums,
                                                       segment_layout)
    s, h = caps.shape
    if isinstance(vm_seg, torch.Tensor):
        vm_seg = vm_seg.cpu().numpy()
    seg = (np.asarray(vm_seg, dtype=np.int64)
           + np.arange(s, dtype=np.int64)[:, None] * h).reshape(-1)
    layout = segment_layout(seg, s * h, caps.device)
    alloc = batched_waterfill(
        managed_capacity(hosts, caps).reshape(s * h),
        vm_floors.reshape(-1), vm_ceils.reshape(-1), vm_weights.reshape(-1),
        iters=iters, layout=layout)
    return row_sums(layout, alloc).reshape(s, h)


# ---------------------------------------------------------------- balance
def _masked_std(values, mask, count):
    """Population stddev of ``values`` where ``mask`` (count = mask sum)."""
    safe = torch.clamp_min(count, 1)
    mean = (values * mask).sum(-1) / safe
    d = values - mean[..., None]
    var = (mask * (d * d)).sum(-1) / safe
    return torch.sqrt(var)


def balance_round(hosts: HostCols, caps, managed, ents, ns, done, did,
                  ents_at: Callable, cpu_reserved, budget, n_on,
                  peak_managed, params: BalanceParams):
    """One BalancePowerCap progressive-filling round.

    Takes and returns the loop state ``(caps, managed, ents, ns, done,
    did)``; ``ents_at(caps) -> (S, H)`` gives per-host VM-entitlement sums
    at candidate caps.  Cells commit only where ``~done``.
    """
    on = hosts.on
    imbalance = _masked_std(ns, on, n_on)
    total_cap = (managed * on).sum(-1)
    # Cluster-average normalized entitlement.
    n_avg = (ents * on).sum(-1) / torch.clamp_min(total_cap, 1e-300)
    halt = ((imbalance <= params.imbalance_threshold)
            | (total_cap <= 0.0) | (n_avg <= 1e-12))

    # Hosts above the average level receive (up to their peak), hosts below
    # donate (down to the average level and their reservations).
    cbar = ents / torch.clamp_min(n_avg, 1e-300)[..., None]
    recipients = on & (ns > n_avg[..., None])
    donors = on & (ns < n_avg[..., None])
    need = torch.where(
        recipients,
        torch.clamp_min(torch.minimum(peak_managed, cbar) - managed, 0.0),
        0.0)
    avail = torch.where(
        donors,
        torch.clamp_min(managed - torch.maximum(cbar, cpu_reserved), 0.0),
        0.0)
    total_need = need.sum(-1)
    total_avail = avail.sum(-1)
    transfer = torch.minimum(total_need, total_avail)
    halt = halt | (transfer <= params.min_transfer)

    grow = recipients & (need > 0.0)
    new_caps = torch.where(grow, cap_for_managed_capacity(
        hosts,
        managed + transfer[..., None] * need
        / torch.clamp_min(total_need, 1e-300)[..., None]), caps)
    shrink = donors & (avail > 0.0)
    new_caps = torch.where(shrink, cap_for_managed_capacity(
        hosts,
        managed - transfer[..., None] * avail
        / torch.clamp_min(total_avail, 1e-300)[..., None]), new_caps)
    # Watts conservation under heterogeneous specs: trim recipients if the
    # budget would be exceeded.
    over = (new_caps * on).sum(-1) - budget
    n_rec = recipients.sum(-1)
    trim = (over > 1e-6)[..., None] & recipients
    new_caps = torch.where(
        trim,
        torch.maximum(new_caps
                      - (over / torch.clamp_min(n_rec, 1))[..., None],
                      hosts.power_idle),
        new_caps)

    new_managed = managed_capacity(hosts, new_caps)
    new_ents = ents_at(new_caps)
    new_ns = torch.where(new_managed > 0.0,
                         new_ents / torch.clamp_min(new_managed, 1e-300), 0.0)
    # A non-improving round (heterogeneous maps, the trim) stops the cell.
    worse = _masked_std(new_ns, on, n_on) > imbalance + 1e-12
    commit = ~done & ~halt & ~worse
    cm = commit[..., None]
    return (torch.where(cm, new_caps, caps),
            torch.where(cm, new_managed, managed),
            torch.where(cm, new_ents, ents),
            torch.where(cm, new_ns, ns),
            done | halt | worse,
            did | commit)


def balance_caps(hosts: HostCols, caps, dense: DenseCols, cpu_reserved,
                 budget, enabled, params: BalanceParams = BalanceParams()):
    """Algorithm 2 (BalancePowerCap): progressive filling toward max-min
    fairness on normalized entitlements, moving Watts instead of VMs.

    Returns ``(caps, did)``.  Cells with ``enabled == False`` or fewer than
    two powered-on hosts pass through unchanged.  On CUDA tensors the whole
    loop runs as one launch of the balance kernel; on CPU tensors as its
    plain version (:func:`repro_torch.kernels.powercap.ref.balance_caps_ref`).
    """
    # Imported here: the plain version builds on this module's round.
    from repro_torch.kernels.powercap import ops
    caps, did, _ = ops.balance_caps(hosts, caps, dense, cpu_reserved,
                                    budget, enabled, params)
    return caps, did
