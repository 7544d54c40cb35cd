"""CloudPowerCap's cap allocation math on ``(S, H)`` tensors.

Plain functions on ``float64`` tensors with a leading cell axis: host
columns are ``(S, H)``, per-cell scalars ``(S,)``, dense slot columns
``(S, H, J)``.  Padded hosts have ``on == False`` and a nonzero
``power_peak - power_idle`` range, so the Eq. 3 division stays finite.

The operation order follows the reference (``repro.core.kernels``) wherever
it decides a result: the engines must agree on exact cap-change counts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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


class MigrationParams(NamedTuple):
    """Configuration of the migration balancer
    (:class:`repro_torch.drs.balancer.BalancerConfig`'s)."""

    imbalance_threshold: float = 0.05
    max_moves: int = 16
    min_goodness: float = 1e-3
    cost_per_gb: float = 2e-4
    contention_threshold: float = 0.9


class MigrationLimits(NamedTuple):
    """Per-invocation launch gates on the manager's migrations.

    A host may be an endpoint (source or destination) of at most
    ``slots_per_host`` launches an invocation, and the cluster may launch
    at most ``bandwidth``; ``None`` means ungated, ``0`` none at all.  A
    gated move is not emitted, and the next invocation scores it again.
    Evacuations are exempt: a power-off is all or nothing.
    """

    slots_per_host: int | None = None
    bandwidth: int | None = None

    @property
    def gated(self) -> bool:
        return self.slots_per_host is not None or self.bandwidth is not None


class RulesMeta(NamedTuple):
    """The static shape of a grid's rule set: the correction loops'
    bounds."""

    n_groups: int = 0              # merged affinity groups
    n_anti: int = 0                # anti-affinity rules
    n_vmhost: int = 0              # VM-host rules
    max_group_members: int = 0     # largest affinity group
    max_anti_members: int = 0      # total anti-rule members

    @property
    def move_bound(self) -> int:
        """Most constraint-correction moves one invocation can make."""
        return (self.n_groups * self.max_group_members + self.n_vmhost
                + self.max_anti_members)

    @property
    def any(self) -> bool:
        return (self.n_groups + self.n_anti + self.n_vmhost) > 0


#: Bisection trips of the migration layer's waterfills, in every engine, so
#: that their entitlement scores (and the argmax decisions on them) agree.
MIGRATION_WATERFILL_ITERS = 100


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
                 budget, enabled, params: BalanceParams = BalanceParams(),
                 plan_cells: Optional[int] = None):
    """Algorithm 2 (BalancePowerCap): progressive filling toward max-min
    fairness on normalized entitlements, moving Watts instead of VMs.

    Returns ``(caps, did)``.  Cells with ``enabled == False`` or fewer than
    two powered-on hosts pass through unchanged.  On CUDA tensors the whole
    loop runs as one launch of the balance kernel, planned for
    ``plan_cells`` cells (:func:`repro_torch.kernels.powercap.ops.
    balance_caps`); on CPU tensors as its plain version
    (:func:`repro_torch.kernels.powercap.ref.balance_caps_ref`).
    """
    # Imported here: the plain version builds on this module's round.
    from repro_torch.kernels.powercap import ops
    caps, did, _ = ops.balance_caps(hosts, caps, dense, cpu_reserved,
                                    budget, enabled, params,
                                    plan_cells=plan_cells)
    return caps, did


# ------------------------------------------------------------ budget tree
#
# A hierarchy of budgets (host -> rack -> row -> room) arrives flattened as
# an ancestor incidence matrix (:class:`repro_torch.core.budget_tree.
# BudgetTree`), so every tree question is a masked reduction over the node
# axis: subtree cap-sums up the tree, per-host slack a masked min down,
# over-limit repair a per-node proportional scale.

#: A node binds for projection only past this overshoot, so kernels whose
#: totals drift by float-summation ULPs pass through bitwise untouched.
TREE_PROJECT_EPS = 1e-9

#: Headroom below this counts a node as saturated for evacuation scoping.
TREE_BIND_EPS = 1e-6


class TreeCols(NamedTuple):
    """Budget-tree columns: ``anc[s, h, m]`` says node ``m`` lies on host
    ``h``'s root path.  Padded hosts have an all-False row; padded nodes an
    all-False column with ``limit == inf`` and ``depth == -1``."""

    anc: torch.Tensor              # (S, H, N) bool
    limit: torch.Tensor            # (S, N) Watts
    depth: torch.Tensor            # (S, N) int64, root 0


def tree_anc_at(tree: TreeCols, host):
    """Ancestor row of the per-cell host index ``host``: ``(S,) -> (S, N)``."""
    n = tree.anc.shape[-1]
    return torch.gather(tree.anc, 1,
                        host[:, None, None].expand(-1, 1, n))[:, 0, :]


def tree_node_sums(tree: TreeCols, on, caps):
    """Per-node subtree sum of the powered-on caps: ``(S, H) -> (S, N)``."""
    caps_on = torch.where(on, caps, 0.0)
    return torch.where(tree.anc, caps_on[..., None], 0.0).sum(-2)


def tree_headroom(tree: TreeCols, on, caps):
    """Per-node Watts left under the node limit (may be < 0)."""
    return tree.limit - tree_node_sums(tree, on, caps)


def tree_host_slack(tree: TreeCols, headroom):
    """Per-host tightest headroom along the root path (``inf`` for hosts
    outside the tree, i.e. padding)."""
    return torch.where(tree.anc, headroom[..., None, :],
                       torch.inf).amin(-1)


def tree_project_caps(tree: TreeCols, on, caps, floors, xp=torch):
    """Scale caps down until every node limit holds, never below floors.

    Each node whose subtree sum passes its limit by more than
    :data:`TREE_PROJECT_EPS` scales its hosts' excess over their floors to
    land on the limit; each host takes the tightest scale on its root path.
    Nodes that do not bind leave caps bitwise untouched.  ``xp`` is the
    array module: ``torch`` for the engines' tensors, ``numpy`` for
    :meth:`repro_torch.core.budget_tree.BudgetTree.project`, whose sums
    must add in the reference's NumPy order.
    """
    fl = xp.where(on, xp.minimum(floors, caps), 0.0)
    ex = xp.where(on, caps, 0.0) - fl
    node_fl = xp.where(tree.anc, fl[..., None], 0.0).sum(-2)
    node_ex = xp.where(tree.anc, ex[..., None], 0.0).sum(-2)
    binding = node_fl + node_ex > tree.limit + TREE_PROJECT_EPS
    scale = (tree.limit - node_fl) / xp.where(node_ex > 1e-300, node_ex,
                                              1e-300)
    scale = xp.where(scale < 0.0, 0.0, xp.where(scale > 1.0, 1.0, scale))
    s_node = xp.where(binding, scale, 1.0)
    s_host = xp.amin(xp.where(tree.anc, s_node[..., None, :], xp.inf), -1)
    return xp.where(on & (s_host < 1.0), fl + s_host * ex, caps)


def tree_evac_scope(tree: TreeCols, on, caps, victim):
    """Destinations for evacuating ``victim``: the subtree of its deepest
    saturated ancestor (headroom below :data:`TREE_BIND_EPS`), or every
    host when no ancestor is saturated."""
    s, h, _ = tree.anc.shape
    head = tree_headroom(tree, on, caps)
    saturated = tree_anc_at(tree, victim) & (head < TREE_BIND_EPS)
    key = torch.where(saturated, tree.depth, -1)
    node = key.argmax(-1)                                    # deepest
    scope = torch.gather(tree.anc, 2,
                         node[:, None, None].expand(s, h, 1))[..., 0]
    return torch.where(saturated.any(-1)[:, None], scope,
                       torch.ones_like(scope))


# -------------------------------------------------- DPM + redistribution
class DPMParams(NamedTuple):
    """DPM thresholds (:class:`repro_torch.drs.dpm.DPMConfig`'s)."""

    high_util: float = 0.81        # power-on trigger
    low_util: float = 0.45         # power-off consideration band
    target_util: float = 0.45      # post-consolidation ceiling on targets
    stable_window_s: float = 300.0 # utilization must be low this long


#: Utilizations are ranked at this resolution (2^-30, about 9.3e-10):
#: hosts that agree to it rank as equal, the lower index first.
UTIL_TIE_QUANTUM = 2.0 ** -30


def util_rank_key(util):
    """The key DPM ranks hosts by: ``util`` rounded down to
    :data:`UTIL_TIE_QUANTUM` (exact in float64, so bitwise the same on any
    device).  BalancePowerCap equalizes utilizations, so raw values tie
    to within rounding (a spread of about 1e-15), and which host ranks
    first would follow each device's and engine's rounding; the reference's
    own engines split on such ties (ROADMAP trap T5).  Values further apart
    than the quantum keep their order."""
    return torch.floor(util / UTIL_TIE_QUANTUM)


def nearest_rank_key(x):
    """The key the migration balancer ranks by: ``x`` rounded to the
    nearest multiple of :data:`UTIL_TIE_QUANTUM` (exact in float64, so
    bitwise the same on any device; infinities pass).  Its normalized
    entitlements and gains tie to within rounding where hosts saturate
    (entitlement sums equal to capacity, so ``N_h`` is 1 up to the order of
    a sum); to the nearest, not down, so that values a rounding away from
    1.0 on either side rank together.  Values further apart than the
    quantum keep their order; ties go to the lower index (ROADMAP trap
    T5)."""
    return torch.round(x / UTIL_TIE_QUANTUM)


def stable_argsort(x, dim: int = -1):
    """Argsort that keeps ties in index order, as NumPy's and JAX's do
    (``torch.argsort`` is not stable unless asked)."""
    return torch.argsort(x, dim=dim, stable=True)


def sequential_cumsum(x):
    """Inclusive prefix sum over the last axis, added left to right on any
    device (``torch.cumsum`` promises no order on CUDA, and the order
    decides the 1e-9 residue test of :func:`power_on_funding_caps`)."""
    acc = torch.zeros_like(x[..., 0])
    out = []
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out.append(acc)
    return torch.stack(out, -1) if out else torch.zeros_like(x)


def host_utilizations(hosts: HostCols, caps, eff_demand_h, mem_demand_h,
                      host_mem):
    """Per-host (cpu, mem) utilizations: zero for powered-off hosts and
    hosts with no capacity."""
    managed = managed_capacity(hosts, caps)
    cpu = torch.where(managed > 0.0,
                      eff_demand_h / torch.clamp_min(managed, 1e-300), 0.0)
    ok = hosts.on & (host_mem > 0.0)
    mem = torch.where(ok, mem_demand_h / torch.clamp_min(host_mem, 1e-300),
                      0.0)
    return cpu, mem


def dpm_hot_mask(on, cpu_util, mem_util, high_util: float):
    """DPM's power-on trigger: powered-on hosts hot on CPU or memory."""
    return on & ((cpu_util > high_util) | (mem_util > high_util))


def dpm_all_low(on, cpu_util, mem_util, low_util: float):
    """DPM's power-off consideration: every powered-on host below the low
    band on CPU and memory (per cell; true with no host on)."""
    low = (cpu_util < low_util) & (mem_util < low_util)
    return (~on | low).all(-1)


def _at(col, idx):
    """``col[s, idx[s]]`` for an ``(S, H)`` column and ``(S,)`` indices."""
    return torch.gather(col, -1, idx[:, None])[:, 0]


def power_on_funding_caps(hosts: HostCols, caps, cand, cpu_util,
                          host_demand, cpu_reserved, budget,
                          high_util: float, tree: TreeCols | None = None):
    """Algorithm 3's power-on funding (paper Fig. 5) for host ``cand``
    (``(S,)``): unallocated budget first, then low-utilization donors,
    coolest first, drained down to the capacity at which DPM's power-on
    trigger would fire, never below their reservations or idle power.

    With a ``tree`` the pool is clipped to the candidate's tightest
    ancestor headroom, and each donation is capped by the headroom of the
    nodes it crosses (ancestors of the candidate but not of the donor),
    which it then debits.  Returns ``(new_caps, granted)``: donors drained
    and the candidate at ``min(granted, peak)``.
    """
    on = hosts.on
    s, h = caps.shape
    h_idx = torch.arange(h, device=caps.device)
    peak_c = _at(hosts.power_peak, cand)
    granted0 = torch.where(_at(on, cand), _at(caps, cand), 0.0)
    needed = torch.clamp_min(peak_c - granted0, 0.0)

    # Step 1: unallocated budget (within the candidate's ancestor headroom
    # when a tree is live).
    pool = torch.clamp_min(budget - torch.where(on, caps, 0.0).sum(-1), 0.0)
    if tree is not None:
        head = tree_headroom(tree, on, caps)
        anc_c = tree_anc_at(tree, cand)
        pool_c = torch.where(anc_c, head, torch.inf).amin(-1)
        pool = torch.minimum(pool, torch.clamp_min(pool_c, 0.0))
    take0 = torch.minimum(pool, needed)
    needed = needed - take0

    # Step 2: the greedy drain as a sorted prefix sum: the k-th coolest
    # donor gives clip(needed - taken so far, 0, avail_k), nothing once the
    # residue is 1e-9 or less (the object plane's early break).
    is_cand = h_idx == cand[:, None]
    donor = on & ~is_cand & (cpu_util < high_util)
    floor_capacity = torch.maximum(host_demand / high_util, cpu_reserved)
    floor_cap = torch.maximum(cap_for_managed_capacity(hosts, floor_capacity),
                              hosts.power_idle)
    avail = torch.where(donor, torch.clamp_min(caps - floor_cap, 0.0), 0.0)
    order = stable_argsort(torch.where(donor, util_rank_key(cpu_util),
                                       torch.inf))
    sorted_avail = torch.gather(avail, -1, order)
    cum_before = sequential_cumsum(sorted_avail) - sorted_avail
    residue = needed[:, None] - cum_before
    take = torch.where(residue > 1e-9,
                       torch.minimum(torch.clamp_min(residue, 0.0),
                                     sorted_avail), 0.0)
    if tree is not None:
        # Each sorted donation is capped by the headroom of the nodes it
        # crosses, which it debits; with no crossed node binding the flat
        # ``take`` passes bitwise.
        head = head - torch.where(anc_c, take0[:, None], 0.0)
        anc_sorted = torch.gather(
            tree.anc, 1, order[..., None].expand(-1, -1, tree.anc.shape[-1]))
        for k in range(h):
            crossed = anc_c & ~anc_sorted[:, k, :]
            room = torch.where(crossed, head, torch.inf).amin(-1)
            t = torch.minimum(take[:, k], torch.clamp_min(room, 0.0))
            head = head - torch.where(crossed, t[:, None], 0.0)
            take = torch.where(h_idx[None, :] == k, t[:, None], take)
    taken = torch.gather(take, -1, stable_argsort(order))

    granted = torch.minimum(granted0 + take0 + take.sum(-1), peak_c)
    new_caps = torch.where(is_cand, granted[:, None], caps - taken)
    return new_caps, granted


def power_off_reabsorb_caps(hosts: HostCols, caps, off_idx, budget,
                            tree: TreeCols | None = None):
    """Algorithm 3's power-off reabsorption: the victim's cap returns to
    the pool, spread over the remaining powered-on hosts in proportion to
    their headroom to peak (victim at 0).  With a ``tree`` the growth is
    projected back under every node limit (floors at the pre-growth
    caps)."""
    h_idx = torch.arange(caps.shape[-1], device=caps.device)
    is_off = h_idx == off_idx[:, None]
    on_after = hosts.on & ~is_off
    caps0 = torch.where(is_off, 0.0, caps)
    pool = torch.clamp_min(
        budget - torch.where(on_after, caps0, 0.0).sum(-1), 0.0)
    recipients = on_after & (caps0 < hosts.power_peak - 1e-9)
    headroom = torch.where(recipients, hosts.power_peak - caps0, 0.0)
    total_head = headroom.sum(-1)
    grant_total = torch.minimum(pool, total_head)
    grown = torch.minimum(
        caps0 + grant_total[:, None] * headroom
        / torch.clamp_min(total_head, 1e-300)[:, None],
        hosts.power_peak)
    ok = (total_head > 0.0) & (pool > 0.0)
    result = torch.where(ok[:, None] & recipients, grown, caps0)
    if tree is None:
        return result
    return tree_project_caps(tree, on_after, result, caps0)


def plan_evacuation(hosts: HostCols, caps, victim, occ, eff_slot, mem_slot,
                    res_slot, migratable, host_mem, target_util: float,
                    allowed=None, anti=None, scope=None):
    """DPM's evacuation plan on the dense slot layout ``(S, H, J)``.

    The victim's VMs leave in decreasing memory order (stable on ties),
    each to the fitting powered-on host with the strictly lowest
    utilization after the move (the first on ties), within reservations,
    memory and ``target_util`` on CPU and memory, and inside ``scope``
    (``(S, H)`` bool) when given.  ``allowed`` (``(S, H, J, H)``) and
    ``anti`` (``(S, H, J, R)``) add rule admission: an evacuee lands only
    on a host its VM-host mask allows and where no member of its
    anti-affinity rules lives, counting evacuees placed earlier in the
    plan.  All or nothing: one unplaceable or unmigratable VM cancels the
    plan.  Returns ``(ok, order, dests, n_evac, slot_pressure)``:
    ``dests[:, k]`` is the k-th evacuee's destination (-1 unused), and
    ``slot_pressure`` flags cells where the ``J`` bound turned a fitting
    destination away.
    """
    s, h, j = occ.shape
    dev = caps.device
    on = hosts.on
    h_idx = torch.arange(h, device=dev)
    s_idx = torch.arange(s, device=dev)
    managed = managed_capacity(hosts, caps)
    act = occ & on[..., None]
    eff_h = torch.where(act, eff_slot, 0.0).sum(-1)
    mem_h = torch.where(act, mem_slot, 0.0).sum(-1)
    res_h = torch.where(act, res_slot, 0.0).sum(-1)
    cnt_h = occ.sum(-1)
    is_vic = h_idx == victim[:, None]

    def at_victim(col):
        return col[s_idx, victim]

    vic_occ, vic_eff, vic_mem, vic_res, vic_mig = (
        at_victim(c) for c in (occ, eff_slot, mem_slot, res_slot,
                               migratable))
    order = stable_argsort(torch.where(vic_occ, -vic_mem, torch.inf))
    n_vic = vic_occ.sum(-1)
    base_fit = on & ~is_vic
    if scope is not None:
        base_fit = base_fit & scope
    vic_allowed = None if allowed is None else at_victim(allowed)
    vic_anti = None if anti is None else at_victim(anti)
    if vic_anti is not None:
        anti_cnt = (anti & act[..., None]).sum(2)            # (S, H, R)
    dests = torch.full((s, j), -1, dtype=victim.dtype, device=dev)
    ok = torch.ones(s, dtype=torch.bool, device=dev)
    pressure = torch.zeros(s, dtype=torch.bool, device=dev)
    for k in range(j):
        valid = k < n_vic
        ko = order[:, k]
        e, m, r = vic_eff[s_idx, ko], vic_mem[s_idx, ko], vic_res[s_idx, ko]
        mig = vic_mig[s_idx, ko]
        fit = base_fit & (res_h + r[:, None] <= managed + 1e-9)
        fit = fit & (mem_h + m[:, None] <= host_mem + 1e-9)
        util_after = (eff_h + e[:, None]) / torch.clamp_min(managed, 1e-9)
        mem_after = (mem_h + m[:, None]) / torch.clamp_min(host_mem, 1e-9)
        fit = fit & (util_after <= target_util) & (mem_after <= target_util)
        if vic_allowed is not None:
            fit = fit & vic_allowed[s_idx, ko]
        if vic_anti is not None:
            a_k = vic_anti[s_idx, ko]                          # (S, R)
            fit = fit & ~((anti_cnt > 0) & a_k[:, None, :]).any(-1)
        slot_ok = cnt_h < j
        pressure = pressure | (valid[:, None] & fit & ~slot_ok).any(-1)
        fit = fit & slot_ok
        score = torch.where(fit, util_after, torch.inf)
        best = score.argmin(-1)
        found = torch.isfinite(score.amin(-1))
        ok = ok & (~valid | (mig & found))
        place = valid & ok
        upd = place[:, None] & (h_idx == best[:, None])
        dests[:, k] = torch.where(place, best, dests[:, k])
        eff_h = eff_h + torch.where(upd, e[:, None], 0.0)
        mem_h = mem_h + torch.where(upd, m[:, None], 0.0)
        res_h = res_h + torch.where(upd, r[:, None], 0.0)
        cnt_h = cnt_h + upd.to(cnt_h.dtype)
        if vic_anti is not None:
            anti_cnt = anti_cnt + (upd[..., None]
                                   & a_k[:, None, :]).to(anti_cnt.dtype)
    n_evac = torch.where(ok, n_vic, 0)
    return ok, order, dests, n_evac, pressure


# ------------------------------------------------------- slot moves
#
# The migration layer (constraint correction and DRS's hill-climb) decides
# on the dense slot layout ``(S, H, J)``, in the object plane (one cell,
# :class:`repro_torch.core.migration_core.MigrationCore`) and in the batched
# engine alike.  Rules arrive as slot columns
# (:class:`repro_torch.drs.arrays.RulesPack`): ``aff_group`` ``(S, H, J)``
# int, ``allowed`` ``(S, H, J, H)`` bool, ``anti`` ``(S, H, J, R)`` bool.

#: Pad values restored to a slot when its VM moves away.  Engines carrying
#: more per-slot columns (demand traces, tag masks) extend this mapping.
SLOT_PAD = {"occ": False, "reservation": 0.0, "limit": float("inf"),
            "weights": 1e-12, "migratable": True, "cpu": 0.0, "mem": 0.0,
            "aff_group": -1, "allowed": True, "anti": False}


def move_slot(work: dict, do, src, j, dst, pads=SLOT_PAD):
    """Move slot ``(src, j)`` to ``dst``'s first free slot, per cell.

    ``work`` maps column names to ``(S, H, J, ...)`` tensors (with
    ``"occ"``); every column travels with the VM and the vacated slot takes
    its pad value.  Free slots are found by occupancy, so holes left by
    earlier moves are reused.  Returns ``(work, moved)``, ``moved``
    masking the cells whose destination had a free slot.  The update is a
    two-point copy per column: no accumulation.
    """
    occ = work["occ"]
    s_ax, h_ax, j_ax = occ.shape
    s_idx = torch.arange(s_ax, device=occ.device)
    src_c = torch.clamp(src, 0, h_ax - 1)
    j_c = torch.clamp(j, 0, j_ax - 1)
    dst_c = torch.clamp(dst, 0, h_ax - 1)
    occ_d = occ[s_idx, dst_c]                         # (S, J)
    ns = occ_d.to(torch.uint8).argmin(-1)             # first free slot
    moved = do & ~occ_d[s_idx, ns]
    out = {}
    for key, arr in work.items():
        val = arr[s_idx, src_c, j_c]                  # (S, *trailing)
        m = moved.reshape(moved.shape + (1,) * (val.ndim - 1))
        arr = arr.clone()
        arr[s_idx, dst_c, ns] = torch.where(m, val, arr[s_idx, dst_c, ns])
        pad = pads[key]
        if not isinstance(pad, torch.Tensor):
            pad = torch.tensor(pad, dtype=arr.dtype, device=arr.device)
        arr[s_idx, src_c, j_c] = torch.where(m, pad, arr[s_idx, src_c, j_c])
        out[key] = arr
    return out, moved


def record_move(moves, n_moves, do, src, j, dst):
    """Append ``(src, j, dst)`` at each cell's cursor where ``do``:
    ``moves`` is ``(S, M, 3)`` int (-1 padded), ``n_moves`` the cursor."""
    at = (torch.arange(moves.shape[1], device=moves.device)[None, :]
          == n_moves[:, None])
    triple = torch.stack([src, j, dst], -1).to(moves.dtype)
    upd = (at & do[:, None])[..., None]
    return (torch.where(upd, triple[:, None, :], moves),
            n_moves + do.to(n_moves.dtype))


def _gather_slots(col, srcs, js):
    """Per-slot columns at K ``(host, slot)`` coordinates: ``(S, K, ...)``."""
    s_idx = torch.arange(col.shape[0], device=col.device)[:, None]
    return col[s_idx, srcs, js]


def _affinity_keep_slots(work: dict, act, n_groups: int, srcs, js):
    """``(S, K, H)``: the (gathered slot, destination) moves that create no
    affinity split -- a grouped VM moves only where a group mate lives, or
    when it is its group's only placed member."""
    s_ax, h_ax, _ = act.shape
    if "aff_group" not in work or n_groups == 0:
        return torch.ones((s_ax, srcs.shape[-1], h_ax), dtype=torch.bool,
                          device=act.device)
    grp = work["aff_group"]
    g_idx = torch.arange(n_groups, device=act.device)
    per_host = ((grp[..., None] == g_idx) & act[..., None]).sum(2)  # (S,H,G)
    total = per_host.sum(1)                                         # (S, G)
    g_v = _gather_slots(grp, srcs, js)                              # (S, K)
    g_c = torch.clamp(g_v, 0, max(n_groups - 1, 0))
    tot_v = torch.gather(total, 1, g_c)
    dest_cnt = torch.gather(per_host.transpose(1, 2), 1,
                            g_c[..., None].expand(-1, -1, h_ax))    # (S,K,H)
    return (g_v[..., None] < 0) | (tot_v[..., None] <= 1) | (dest_cnt > 0)


def _admission_slots(on, work: dict, capacity, host_mem, srcs, js,
                     limits: MigrationLimits | None = None, launch=None):
    """Reservation, memory, rule and free-slot admission of K gathered
    candidate slots against every destination, ``(S, K, H)``.

    Returns ``(fit, fit_unbounded, res_h, mem_h)``: ``fit_unbounded``
    ignores the free-slot bound (slot-pressure detection), ``res_h`` and
    ``mem_h`` are the per-host sums at the current placement.
    ``capacity`` is the injected view (current-cap or fundable managed
    capacity, paper Fig. 3), 0 for powered-off hosts.  With gated
    ``limits``, ``launch = (launch_h, launch_n)`` (per-host endpoint counts
    and the cell's total launched this invocation) must leave headroom at
    both endpoints and in the cluster budget; the gate lands before the
    free-slot split, so a deferral it causes is not slot pressure.
    """
    occ = work["occ"]
    act = occ & on[..., None]
    res_h = torch.where(act, work["reservation"], 0.0).sum(-1)
    mem_h = torch.where(act, work["mem"], 0.0).sum(-1)
    h_idx = torch.arange(occ.shape[1], device=occ.device)
    res_v = _gather_slots(work["reservation"], srcs, js)       # (S, K)
    mem_v = _gather_slots(work["mem"], srcs, js)
    fit = on[:, None, :] & (h_idx != srcs[..., None])
    fit = fit & (res_h[:, None, :] + res_v[..., None]
                 <= capacity[:, None, :] + 1e-9)
    fit = fit & (mem_h[:, None, :] + mem_v[..., None]
                 <= host_mem[:, None, :] + 1e-9)
    if "allowed" in work:
        fit = fit & _gather_slots(work["allowed"], srcs, js)
    if "anti" in work and work["anti"].shape[-1] > 0:
        present = (work["anti"] & act[..., None]).any(2)        # (S, H, R)
        a_v = _gather_slots(work["anti"], srcs, js)             # (S, K, R)
        fit = fit & ~(a_v[:, :, None, :] & present[:, None, :, :]).any(-1)
    if limits is not None and limits.gated:
        launch_h, launch_n = launch
        if limits.slots_per_host is not None:
            src_launch = torch.gather(launch_h, -1, srcs)
            fit = fit & (src_launch < limits.slots_per_host)[..., None]
            fit = fit & (launch_h < limits.slots_per_host)[:, None, :]
        if limits.bandwidth is not None:
            fit = fit & (launch_n < limits.bandwidth)[:, None, None]
    free_slot = (~occ).any(-1)                                 # (S, H)
    return fit & free_slot[:, None, :], fit, res_h, mem_h


def _launch_counter(limits: MigrationLimits, h_idx):
    """The launch ledger's update for one committed move a cell (a no-op
    when the launches are not gated)."""
    def count(launch_h, launch_n, moved, src, dst):
        if not limits.gated:
            return launch_h, launch_n
        ep = (h_idx == src[:, None]) | (h_idx == dst[:, None])
        return (launch_h + (moved[:, None] & ep).to(launch_h.dtype),
                launch_n + moved.to(launch_n.dtype))
    return count


def correct_constraints_slots(hosts: HostCols, capacity, work: dict,
                              host_mem, rmeta: RulesMeta, enabled, moves,
                              n_moves, pads=SLOT_PAD,
                              limits: MigrationLimits = MigrationLimits(),
                              launch=None, read=bool):
    """Constraint correction on the dense slot layout (paper Fig. 1a/3).

    1. *Affinity*: each group gathers on one home host, all or nothing --
       the anchor's host (the member with the largest reservation) when it
       admits the group, else the feasible member host with the most free
       capacity; with no feasible home the group stays split.
    2. *VM-host*: each misplaced VM moves to the admissible allowed host
       with the most free capacity.
    3. *Anti-affinity*: while a rule has two members on one host, the first
       surplus member with a feasible destination moves to the admissible
       host with the most free capacity.

    ``capacity`` is the admission view (current-cap managed capacity for
    static policies, fundable capacity during Powercap Allocation).  Moves
    change ``work`` in slot space and are appended to ``moves`` /
    ``n_moves``.  Returns ``(work, moves, n_moves, pressure, launch)``:
    ``pressure`` flags cells whose ``J`` bound blocked a feasible
    correction, ``launch = (launch_h, launch_n)`` the invocation's launch
    counts (shared with the balancer) after every committed move.  Gated
    ``limits`` defer an affinity group whose remaining launch headroom
    cannot cover its whole gather.  The VM-host and anti-affinity loops
    end when no cell still corrects: each round reads one flag through
    ``read``.
    """
    on = hosts.on
    s_ax, h_ax, j_ax = work["occ"].shape
    dev = on.device
    h_idx = torch.arange(h_ax, device=dev)
    s_idx = torch.arange(s_ax, device=dev)
    pressure = torch.zeros(s_ax, dtype=torch.bool, device=dev)
    gated = limits.gated
    if launch is None:
        launch = (torch.zeros((s_ax, h_ax), dtype=n_moves.dtype, device=dev),
                  torch.zeros(s_ax, dtype=n_moves.dtype, device=dev))
    launch_h, launch_n = launch
    count = _launch_counter(limits, h_idx)

    # ---------------------------------------------------- 1. affinity
    for g in range(rmeta.n_groups):
        occ = work["occ"]
        act = occ & on[..., None]
        res = work["reservation"]
        memb = act & (work["aff_group"] == g)
        cnt_h = memb.sum(-1)                                   # (S, H)
        violated = (cnt_h > 0).sum(-1) > 1
        n_movers = cnt_h.sum(-1)[:, None] - cnt_h
        # Every candidate home at once: it hosts a member, admits the other
        # members' reservations and memory under the capacity view, keeps
        # each mover's VM-host mask and anti-affinity rules, and has the
        # free slots.
        nm_h = (memb & ~work["migratable"]).sum(-1)
        ok = (nm_h.sum(-1)[:, None] - nm_h) == 0
        if "allowed" in work:
            bad = memb[..., None] & ~work["allowed"]           # (S,H,J,H)
            bad_on_home = torch.diagonal(bad, 0, 1, 3).sum(1)  # (S, H)
            ok = ok & ((bad.sum((1, 2)) - bad_on_home) == 0)
        if "anti" in work and rmeta.n_anti:
            anti = work["anti"]
            c_rh = (anti & act[..., None]).sum(2)              # (S, H, R)
            g_rh = (anti & memb[..., None]).sum(2)
            m_r = g_rh.sum(1)[:, None, :] - g_rh               # movers in r
            ok = ok & ((m_r == 0) | (c_rh + m_r <= 1)).all(-1)
        res_h = torch.where(act, res, 0.0).sum(-1)
        mem_h = torch.where(act, work["mem"], 0.0).sum(-1)
        memb_res_h = torch.where(memb, res, 0.0).sum(-1)
        memb_mem_h = torch.where(memb, work["mem"], 0.0).sum(-1)
        moving_res = memb_res_h.sum(-1)[:, None] - memb_res_h
        moving_mem = memb_mem_h.sum(-1)[:, None] - memb_mem_h
        ok = ok & (res_h + moving_res <= capacity + 1e-9)
        ok = ok & (mem_h + moving_mem <= host_mem + 1e-9)
        ok = ok & (cnt_h > 0)
        if gated:
            # All or nothing under the gates too: each member host has
            # headroom for its departures, the home for every arrival, the
            # cluster for the whole gather.
            if limits.slots_per_host is not None:
                sl = limits.slots_per_host
                dep_bad = ((cnt_h > 0) & (launch_h + cnt_h > sl)).to(
                    launch_h.dtype)
                ok = ok & ((dep_bad.sum(-1)[:, None] - dep_bad) == 0)
                ok = ok & (launch_h + n_movers <= sl)
            if limits.bandwidth is not None:
                ok = ok & (launch_n[:, None] + n_movers <= limits.bandwidth)
        ok_full = ok & (j_ax - occ.sum(-1) >= n_movers)
        feasible = ok_full.any(-1)
        pressure = pressure | (enabled & violated & ~feasible & ok.any(-1))
        # The anchor's host (its largest-reservation member, the hardest to
        # move) when feasible, else the feasible member host with the most
        # free capacity.
        anchor_home = torch.where(memb, res, -torch.inf).reshape(
            s_ax, -1).argmax(-1) // j_ax
        anchor_ok = ok_full[s_idx, anchor_home]
        best_home = torch.where(ok_full, capacity - res_h,
                                -torch.inf).argmax(-1)
        home = torch.where(anchor_ok, anchor_home, best_home)
        off_home = h_idx[None, :, None] != home[:, None, None]
        do_g = enabled & violated & feasible
        for _ in range(rmeta.max_group_members):
            movers = ((work["occ"] & on[..., None])
                      & (work["aff_group"] == g) & off_home).reshape(s_ax, -1)
            first = movers.to(torch.uint8).argmax(-1)
            src, jj = first // j_ax, first % j_ax
            work, moved = move_slot(work, do_g & movers.any(-1), src, jj,
                                    home, pads)
            moves, n_moves = record_move(moves, n_moves, moved, src, jj,
                                         home)
            launch_h, launch_n = count(launch_h, launch_n, moved, src, home)

    # ------------------------------------ the mover of phases 2 and 3
    def greedy_move(work, moves, n_moves, pressure, launch_h, launch_n,
                    viol, k_bound):
        """Move the first slot of ``viol`` with a feasible destination to
        the admissible host with the most free capacity, scoring only the
        first ``k_bound`` violating slots of a cell (the phase's rule
        bound, so no violator is missed)."""
        big = h_ax * j_ax
        keys = torch.where(viol.reshape(s_ax, -1),
                           torch.arange(big, device=dev), big)
        order = stable_argsort(keys)[:, :k_bound]              # (S, K)
        kvalid = torch.gather(keys, 1, order) < big
        srcs, js = order // j_ax, order % j_ax
        fit, fit_unb, res_h, _ = _admission_slots(
            on, work, capacity, host_mem, srcs, js, limits,
            (launch_h, launch_n))
        ok_v = (kvalid & _gather_slots(work["migratable"], srcs, js))[
            ..., None]
        fit, fit_unb = fit & ok_v, fit_unb & ok_v
        has_dest = fit.any(-1)                                 # (S, K)
        pressure = pressure | (enabled & (fit_unb.any(-1)
                                          & ~has_dest).any(-1))
        found = enabled & has_dest.any(-1)
        first_k = has_dest.to(torch.uint8).argmax(-1)
        src, jj = srcs[s_idx, first_k], js[s_idx, first_k]
        dest = torch.where(fit[s_idx, first_k], capacity - res_h,
                           -torch.inf).argmax(-1)
        work, moved = move_slot(work, found, src, jj, dest, pads)
        moves, n_moves = record_move(moves, n_moves, moved, src, jj, dest)
        launch_h, launch_n = count(launch_h, launch_n, moved, src, dest)
        return work, moves, n_moves, pressure, launch_h, launch_n, found

    def vh_viol(work):
        act = work["occ"] & on[..., None]
        return act & ~torch.diagonal(work["allowed"], 0, 1, 3).transpose(1, 2)

    def anti_extra(work):
        member = work["anti"] & (work["occ"] & on[..., None])[..., None]
        cnt = member.sum(2)                                    # (S, H, R)
        keeper = member.to(torch.uint8).argmax(2)              # (S, H, R)
        j_col = torch.arange(j_ax, device=dev)[None, None, :, None]
        return (member & (j_col != keeper[:, :, None, :])
                & (cnt[:, :, None, :] > 1)).any(-1)            # (S, H, J)

    # 2. VM-host, then 3. anti-affinity: a round a move, while any cell
    # still finds one.
    for bound, viol_of in ((rmeta.n_vmhost, vh_viol),
                           (rmeta.max_anti_members if rmeta.n_anti else 0,
                            anti_extra)):
        if not bound:
            continue
        go = enabled & viol_of(work).reshape(s_ax, -1).any(-1)
        for _ in range(bound):
            if not read(go.any()):
                break
            (work, moves, n_moves, pressure, launch_h, launch_n,
             found) = greedy_move(work, moves, n_moves, pressure, launch_h,
                                  launch_n, viol_of(work), bound)
            go = go & found
    return work, moves, n_moves, pressure, (launch_h, launch_n)


def balance_migrations(hosts: HostCols, caps, work: dict, host_mem,
                       params: MigrationParams, rmeta: RulesMeta, enabled,
                       moves, n_moves, pads=SLOT_PAD,
                       iters: int = MIGRATION_WATERFILL_ITERS,
                       limits: MigrationLimits = MigrationLimits(),
                       launch=None, read=bool):
    """DRS's greedy hill-climb balancer (paper Sec. IV-A), batched.

    A move a round: every (migratable slot on the most-strained host,
    below-average destination) candidate that passes reservation, memory
    and rule admission is scored by the drop in the imbalance (the stddev
    of normalized entitlements, the VM carrying its current entitlement),
    and the best wins if its gain beats the risk-cost-benefit floor
    (``min_goodness`` plus the memory-proportional cost).  Rounds go on
    until the imbalance meets its threshold, no candidate passes, the
    imbalance stops improving, or ``max_moves``; each round reads one flag
    through ``read`` (whether any cell still goes).  The contention gate
    (no strained host: a migration costs more than it brings) is checked
    once, on entry.  Scoring is a closed-form update of the stddev; after
    a move only its two hosts are waterfilled again (the bisection is per
    host, so the result is bitwise a full pass's).  The entitlement
    waterfills are kernel K1 on the GPU: ``(S, H, J)`` on entry, then
    ``(S, 2, J)`` a round.  ``limits`` and ``launch`` gate launches as in
    :func:`correct_constraints_slots`.  Returns ``(work, moves, n_moves,
    pressure, launch)``.
    """
    # Imported here: the wrappers import this module's column types.
    from repro_torch.kernels.powercap.ops import waterfill_dense

    on = hosts.on
    s_ax, h_ax, j_ax = work["occ"].shape
    dev = on.device
    if launch is None:
        launch = (torch.zeros((s_ax, h_ax), dtype=n_moves.dtype, device=dev),
                  torch.zeros(s_ax, dtype=n_moves.dtype, device=dev))
    pressure = torch.zeros(s_ax, dtype=torch.bool, device=dev)
    if params.max_moves <= 0:
        return work, moves, n_moves, pressure, launch
    launch_h, launch_n = launch
    h_idx = torch.arange(h_ax, device=dev)
    s_idx = torch.arange(s_ax, device=dev)
    count = _launch_counter(limits, h_idx)
    n_on = on.sum(-1)
    managed = managed_capacity(hosts, caps)
    js = torch.arange(j_ax, device=dev)[None, :].expand(s_ax, -1)

    def fill(managed_cols, occ, res, lim, cpu, weights, on_cols):
        act = occ & on_cols[..., None]
        eff = torch.where(act, clip(cpu, res, lim), 0.0)
        floors = torch.where(act, torch.minimum(res, lim), 0.0)
        alloc = torch.where(act, waterfill_dense(
            managed_cols, floors, eff, weights, iters, active=act), 0.0)
        ents = alloc.sum(-1)
        ns = torch.where(managed_cols > 0.0,
                         ents / torch.clamp_min(managed_cols, 1e-300), 0.0)
        return alloc, ents, ns

    def refill_pair(work, alloc, ents, ns, moved, src, dest):
        """Waterfill the two hosts of a move again and scatter their rows
        back into the carried entitlements."""
        idx2 = torch.stack([src, dest], -1)                    # (S, 2)
        idx3 = idx2[..., None].expand(-1, -1, j_ax)

        def g3(col):
            return torch.gather(col, 1, idx3)

        alloc2, ents2, ns2 = fill(
            torch.gather(managed, 1, idx2), g3(work["occ"]),
            g3(work["reservation"]), g3(work["limit"]), g3(work["cpu"]),
            g3(work["weights"]), torch.gather(on, 1, idx2))
        for row, half in (((h_idx == src[:, None]) & moved[:, None],
                           slice(0, 1)),
                          ((h_idx == dest[:, None]) & moved[:, None],
                           slice(1, 2))):
            alloc = torch.where(row[..., None], alloc2[:, half], alloc)
            ents = torch.where(row, ents2[:, half], ents)
            ns = torch.where(row, ns2[:, half], ns)
        return alloc, ents, ns

    alloc, ents, ns = fill(managed, work["occ"], work["reservation"],
                           work["limit"], work["cpu"], work["weights"], on)
    strained = torch.where(on, ns, 0.0).amax(-1)
    done = ~enabled | (n_on < 2) | (strained <= params.contention_threshold)
    prev_imb = torch.full((s_ax,), torch.inf, dtype=ns.dtype, device=dev)
    safe_cap = torch.where(managed > 0.0, managed, 1.0)
    # A destination with no managed capacity would pin the mover's
    # normalized entitlement at 0: never a receiver.
    has_cap = on & (managed > 0.0)
    denom = torch.clamp_min(n_on, 1)[:, None, None]
    for _ in range(params.max_moves):
        if read(done.all()):
            break
        act = work["occ"] & on[..., None]
        imb = _masked_std(ns, on, n_on)
        mean_n = (ns * on).sum(-1) / torch.clamp_min(n_on, 1)
        # Candidates come from the most-strained host.
        hot = torch.where(on, nearest_rank_key(ns), -torch.inf).argmax(-1)
        ns_hot = ns[s_idx, hot]
        halt = ((imb <= params.imbalance_threshold) | (imb >= prev_imb)
                | (ns_hot <= mean_n))
        srcs = hot[:, None].expand(-1, j_ax)
        cand = (_gather_slots(act, srcs, js)
                & _gather_slots(work["migratable"], srcs, js))
        recv = has_cap & (ns <= mean_n[:, None])
        fit, fit_unb, _, _ = _admission_slots(
            on, work, managed, host_mem, srcs, js, limits,
            (launch_h, launch_n))
        keep = (_affinity_keep_slots(work, act, rmeta.n_groups, srcs, js)
                & cand[..., None] & recv[:, None, :])
        fit, fit_unb = fit & keep, fit_unb & keep
        live = ~done & ~halt
        pressure = pressure | (live & (fit_unb & ~fit).reshape(
            s_ax, -1).any(-1))

        # The stddev after the move, in closed form: the VM carries its
        # current entitlement e_v from the hot host to the destination.
        e_v = _gather_slots(alloc, srcs, js)                   # (S, J)
        ns_src = ns_hot[:, None]
        ns_d = ns[:, None, :]
        ns_src_new = (ents[s_idx, hot][:, None] - e_v) / safe_cap[
            s_idx, hot][:, None]
        ns_d_new = (ents[:, None, :] + e_v[..., None]) / safe_cap[:, None, :]
        t1 = (ns * on).sum(-1)[:, None, None]
        t2 = (ns * ns * on).sum(-1)[:, None, None]
        t1n = (t1 - ns_src[..., None] - ns_d + ns_src_new[..., None]
               + ns_d_new)
        t2n = (t2 - (ns_src * ns_src)[..., None] - ns_d * ns_d
               + (ns_src_new * ns_src_new)[..., None] + ns_d_new * ns_d_new)
        mean_t = t1n / denom
        var = torch.clamp_min(t2n / denom - mean_t * mean_t, 0.0)
        gain = imb[:, None, None] - torch.sqrt(var)
        cost = (params.min_goodness + params.cost_per_gb
                * _gather_slots(work["mem"], srcs, js) / 1024.0)
        score = torch.where(fit & (gain > cost[..., None]), gain,
                            -torch.inf).reshape(s_ax, -1)      # (S, J*H)
        best = nearest_rank_key(score).argmax(-1)
        found = torch.isfinite(score[s_idx, best])
        jj, dest = best // h_ax, best % h_ax
        work, moved = move_slot(work, live & found, hot, jj, dest, pads)
        moves, n_moves = record_move(moves, n_moves, moved, hot, jj, dest)
        alloc, ents, ns = refill_pair(work, alloc, ents, ns, moved, hot,
                                      dest)
        launch_h, launch_n = count(launch_h, launch_n, moved, hot, dest)
        done = done | halt | ~found
        prev_imb = imb
    return work, moves, n_moves, pressure, (launch_h, launch_n)
