"""Batched multi-cluster engine: a whole scenario grid at once.

``BatchedSimulator`` packs S scenario cells x H hosts x J VM slots per host
into padded ``float64`` tensors and runs the paper's control loop for every
cell at once: each tick looks up demand from the packed step-function
traces, delivers CPU with the dense-slot waterfill (kernel K1 on the GPU),
applies the Eq. 1 power model and adds the tick into the accumulators;
every DRS period the manager runs RedivvyPowerCap and then the
BalancePowerCap loop (kernel K2 on the GPU, one launch per invocation).

Two regimes, chosen at pack time, as in the reference:

* **cap-only** (no cell has DPM or scripted power events): placements and
  host power states are frozen, so the pack is the whole scenario.  The
  DRS schedule is a host array, and the tick loop takes its branches
  without waiting on the device; the harvest is the only synchronisation.
* **churn** (some cell has ``dpm_enabled`` or ``config.power_events``, or
  the grid can migrate a VM: a placement rule violated at the start, a
  live migration balancer, or rules that DPM's evacuations must keep): the
  power states, the slot layout and the DRS schedule are carried state.
  Scripted events flip hosts on schedule; pending power-on and power-off
  timers fire; an invocation runs constraint correction (with the
  fundable-capacity view under cpc, paper Fig. 3), RedivvyPowerCap,
  BalancePowerCap, DRS's hill-climb balancer, then DPM's triggers with
  Powercap Redistribution: a funded power-on, or a rule-aware evacuation
  and a power-off whose reabsorbed caps apply when its timer fires.
  Migrations are atomic slot remaps (``move_slot``) in the object plane's
  ``instant_migrations`` regime; in the gated timed regime
  (``SimConfig.migration_gated``) they go through an in-flight table
  carried per cell: launches bounded by per-host slots and the cluster
  bandwidth, both endpoints burning vMotion overhead during the copy, and
  entries committing FIFO through the same ``move_slot`` the what-if used.
  Whether any cell may invoke depends on device state, so the loop reads
  one flag a tick (``any(can)``), and the migration layer's loops one a
  round; no loop runs over cells on the host.

Placement rules ride along as slot columns (from
:class:`repro_torch.drs.arrays.RulesPack`): affinity groups, anti-affinity
memberships and allowed-host masks, moving with their VM.

A budget tree (``snapshot.budget_tree``) adds ancestor incidence, limit and
depth columns; the caps are projected under every node limit after the
redivvy and the balance, funding, reabsorption and evacuation are scoped
by it, and an ``over_tree`` invariant is checked at the harvest.

Cells the engine cannot replay exactly raise :class:`BatchUnsupported`:
ungated timed migrations (their runtime concurrency gate is
data-dependent), cells disagreeing on the time grid or the migration
model, and budget trees with placement rules.  The reference is
``repro.sim.batch``; results agree with it to float tolerance with exact
counts of cap changes, power-ons, power-offs and vMotions.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels
from repro_torch.drs import rules as rules_mod
from repro_torch.drs.arrays import RulesPack, dense_slot_assignment
from repro_torch.drs.entitlement import waterfill_dense
from repro_torch.drs.snapshot import ClusterSnapshot
from repro_torch.runtime import sharding
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.metrics import Accumulators, fold_timeseries
from repro_torch.sim.workloads import DemandTrace, TraceBank

FIELDS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")

#: The packed arrays: each is bitwise the reference pack's array of the
#: same key (``repro.sim.batch``).  The last eight serve the churn regime.
PACK_KEYS = ("on", "idle", "peak", "cap_peak", "hyp", "host_mem", "caps0",
             "cpu_res", "budget", "enabled", "occ", "reservation", "limit",
             "weights", "tag_masks", "bps", "cpu_vals", "mem_vals", "period",
             "ts", "drs_mask", "win_mask", "exists", "dpm", "bal_on", "vm",
             "migratable", "ev_t", "ev_host", "ev_on")

#: Packed only when a cell has a budget tree that binds.
TREE_KEYS = ("tree_anc", "tree_limit", "tree_depth")

#: The rule columns, each packed only when the migration layer runs and
#: some cell has a rule of its kind.
RULE_KEYS = ("aff_group", "allowed", "anti")

#: Kept on the host: the loop reads them to take its branches.
_HOST_KEYS = ("ts", "drs_mask", "ev_t")

#: Read by the churn regime only.
_CHURN_KEYS = ("exists", "dpm", "bal_on", "vm", "migratable", "ev_host",
               "ev_on")

#: The per-slot columns the churn regime carries, moving with their VM (and
#: the rule columns, when packed).
SLOT_KEYS = ("occ", "reservation", "limit", "weights", "migratable",
             "period", "bps", "cpu_vals", "mem_vals", "tag_masks", "vm")

#: Pads restored behind a moved VM (``bps`` takes its padded breakpoint
#: row, built per program).
_SLOT_PAD = dict(kernels.SLOT_PAD, period=float("inf"), cpu_vals=0.0,
                 mem_vals=0.0, tag_masks=False, vm=-1)

#: The timed regime's in-flight table, its empty rows: ``mig_src`` is -1
#: there, which masks every other column (a committed row keeps its stale
#: values), so these fills decide nothing.
_TABLE_PAD = {"mig_j": -1, "mig_dst": -1, "mig_prev": -1, "mig_end": 0.0}


class Schedule(NamedTuple):
    """The time grid's DRS schedule and power latencies, shared by a
    batch's cells."""

    drs_period_s: float = 300.0
    drs_first_at_s: float = 300.0
    power_on_latency_s: float = 120.0
    power_off_latency_s: float = 30.0


class MigrationModel(NamedTuple):
    """What the churn program runs of the migration layer, shared by a
    batch's cells: the rule set's bounds (``RulesMeta()`` when correction
    does not run), the balancer (``max_moves=0`` when it does not), and the
    execution model -- the timed in-flight table of ``mig_table`` rows, the
    launch gates, the vMotion copy rate and endpoint overhead."""

    rules: kernels.RulesMeta = kernels.RulesMeta()
    balancer: kernels.MigrationParams = kernels.MigrationParams(max_moves=0)
    timed: bool = False
    mig_table: int = 1
    limits: kernels.MigrationLimits = kernels.MigrationLimits()
    vmotion_rate_mb_s: float = 128.0
    vmotion_overhead_mhz: float = 1500.0


class BatchUnsupported(ValueError):
    """A cell requests a regime the batched engine cannot replay exactly."""


@dataclasses.dataclass
class BatchCell:
    """One scenario cell: a cluster, its demand traces, and its policy."""

    name: str
    snapshot: ClusterSnapshot
    traces: dict[str, DemandTrace]
    config: SimConfig
    powercap_enabled: bool = True            # False => Static/StaticHigh
    window: Optional[tuple[float, float]] = None
    dpm_enabled: bool = False
    # Whether the hill-climb balancer runs for this cell, when the batch
    # has a balancer with ``max_moves > 0``.
    balancer_enabled: bool = True
    # Optional pre-packed ``TraceBank`` over ``list(snapshot.vms)``, shared
    # by the cells of one spec; ``None`` packs from ``traces``.
    trace_bank: Optional[TraceBank] = None


@dataclasses.dataclass
class BatchResult:
    """Per-cell accumulators, as arrays over the S cells."""

    names: list
    cpu_payload_mhz_s: np.ndarray
    cpu_demand_mhz_s: np.ndarray
    mem_payload_mb_s: np.ndarray
    mem_demand_mb_s: np.ndarray
    energy_j: np.ndarray
    cap_changes: np.ndarray                  # int32 per cell
    vmotions: np.ndarray                     # int32 per cell (evacuations)
    power_ons: np.ndarray                    # int32 per cell
    power_offs: np.ndarray                   # int32 per cell
    tag_names: list
    tag_payload: np.ndarray                  # (S, G)
    tag_demand: np.ndarray                   # (S, G)
    window_fields: dict                      # field -> (S,) array
    has_window: np.ndarray                   # bool per cell
    final_caps: np.ndarray                   # (S, H)
    final_on: np.ndarray                     # (S, H) power states at the end
    final_occ: np.ndarray                    # (S, H, J) final occupancy
    ticks: int
    device: str = ""                         # where the program ran
    pack_s: float = 0.0                      # host-side packing
    run_s: float = 0.0                       # upload, tick loop, harvest
    compile_s: float = 0.0                   # kernel builds this run paid
    wall_s: float = 0.0                      # compile_s + run_s
    n_devices: int = 1
    # ``keep_timeseries=True`` only: field -> (T, S) per-tick rates and
    # per-tick action counts (end-minus-start deltas of the totals).
    timeseries: Optional[dict] = None
    tick_s: float = 0.0
    over_budget: Optional[np.ndarray] = None  # (S,) worst W over budget
    over_tree: Optional[np.ndarray] = None   # (S,) worst node overshoot

    def reduced_timeseries(self) -> dict:
        """Fold :attr:`timeseries` into run summaries with the tick loop's
        own arithmetic (:func:`repro_torch.sim.metrics.fold_timeseries`)."""
        if self.timeseries is None:
            raise ValueError("run with keep_timeseries=True first")
        return fold_timeseries(self.timeseries, self.tick_s)

    def accumulators(self, i: int) -> Accumulators:
        acc = Accumulators(
            cpu_payload_mhz_s=float(self.cpu_payload_mhz_s[i]),
            cpu_demand_mhz_s=float(self.cpu_demand_mhz_s[i]),
            mem_payload_mb_s=float(self.mem_payload_mb_s[i]),
            mem_demand_mb_s=float(self.mem_demand_mb_s[i]),
            energy_j=float(self.energy_j[i]),
            cap_changes=int(self.cap_changes[i]),
            vmotions=int(self.vmotions[i]),
            power_ons=int(self.power_ons[i]),
            power_offs=int(self.power_offs[i]))
        for g, tag in enumerate(self.tag_names):
            if self.tag_demand[i, g] > 0.0 or self.tag_payload[i, g] > 0.0:
                acc.tag_payload[tag] = float(self.tag_payload[i, g])
                acc.tag_demand[tag] = float(self.tag_demand[i, g])
        return acc

    def window_accumulators(self, i: int) -> Optional[Accumulators]:
        if not bool(self.has_window[i]):
            return None
        w = self.window_fields
        return Accumulators(
            cpu_payload_mhz_s=float(w["cpu_payload_mhz_s"][i]),
            cpu_demand_mhz_s=float(w["cpu_demand_mhz_s"][i]),
            mem_payload_mb_s=float(w["mem_payload_mb_s"][i]),
            mem_demand_mb_s=float(w["mem_demand_mb_s"][i]),
            energy_j=float(w["energy_j"][i]))


def _drs_schedule(cfg: SimConfig) -> tuple[np.ndarray, np.ndarray]:
    """Tick times and manager-invocation mask, mirroring the object
    simulator's loop (cap changes are instantaneous, so no invocation is
    ever deferred)."""
    ts, fire = [], []
    next_drs = cfg.drs_first_at_s
    t = 0.0
    while t < cfg.duration_s:
        hit = t >= next_drs
        if hit:
            next_drs = t + cfg.drs_period_s
        ts.append(t)
        fire.append(hit)
        t += cfg.tick_s
    return np.asarray(ts, dtype=np.float64), np.asarray(fire, dtype=bool)


def _mig_capable(c: BatchCell, balancer: kernels.MigrationParams) -> bool:
    """Whether the cell can move a VM, and so has a migration execution
    model (instant or timed) to agree on."""
    return bool(c.dpm_enabled
                or (balancer.max_moves > 0 and c.balancer_enabled)
                or (c.snapshot.rules
                    and rules_mod.all_violations(c.snapshot)))


def _cell_reason(c: BatchCell, ref: SimConfig, churn: bool,
                 balancer: kernels.MigrationParams,
                 ref_mig: Optional[SimConfig] = None,
                 check_traces: bool = False) -> Optional[str]:
    """Why this cell cannot join a batch anchored on ``ref`` (``churn``:
    the batch runs the churn regime; ``ref_mig``: the config of the first
    migration-capable cell admitted, whose migration model every such cell
    must share)."""
    same = (c.config.duration_s == ref.duration_s
            and c.config.tick_s == ref.tick_s
            and c.config.drs_period_s == ref.drs_period_s
            and c.config.drs_first_at_s == ref.drs_first_at_s)
    if not same:
        return "disagrees on the shared time grid"
    if _mig_capable(c, balancer):
        if (not c.config.instant_migrations
                and not c.config.migration_gated):
            return ("timed migrations in the batched engine need launch "
                    "gating (set migration_slots_per_host and/or "
                    "migration_bandwidth, and use the same on the vector "
                    "engine); ungated timed cells run on the vector engine")
        if ref_mig is not None and _mig_model(c.config) != _mig_model(
                ref_mig):
            return ("disagrees on the migration execution model "
                    "(instant/timed, vMotion rate/overhead, and launch "
                    "gates are shared across a batch)")
    if churn and (c.config.power_on_latency_s != ref.power_on_latency_s
                  or c.config.power_off_latency_s
                  != ref.power_off_latency_s):
        return ("disagrees on power latencies (shared across a "
                "capacity-churn batch)")
    for t, host_id, _ in c.config.power_events:
        if host_id not in c.snapshot.hosts:
            return f"power event at t={t} targets unknown host {host_id!r}"
    if c.snapshot.effective_tree() is not None and c.snapshot.rules:
        return ("budget trees with placement rules cannot be batched "
                "(constraint correction's cap funding is tree-unaware); "
                "such cells run on the vector engine")
    if check_traces:
        bank = c.trace_bank
        if bank is None:
            bank = TraceBank.from_traces(c.traces, list(c.snapshot.vms))
        if bank.fallback:
            return "traces without a declarative spec cannot be batched"
    return None


def _partition(cells: Sequence[BatchCell],
               balancer: kernels.MigrationParams,
               check_traces: bool = False
               ) -> tuple[dict[str, str], Optional[SimConfig]]:
    """``(reasons, ref_mig)``: cell name -> why it cannot join the batch,
    in cell order, anchored on the first supportable cell's time grid;
    and the migration model's anchor, the first supportable cell that can
    move a VM (``None``: none can)."""
    churn = any(c.dpm_enabled or c.config.power_events for c in cells)
    reasons: dict[str, str] = {}
    ref = ref_mig = None
    for c in cells:
        capable = _mig_capable(c, balancer)
        reason = _cell_reason(c, ref or c.config, churn, balancer,
                              ref_mig if capable else None, check_traces)
        if reason is not None:
            reasons[c.name] = reason
            continue
        ref = ref or c.config
        if capable and ref_mig is None:
            ref_mig = c.config
    return reasons, ref_mig


def _mig_model(cfg: SimConfig) -> tuple:
    return (cfg.instant_migrations, cfg.vmotion_rate_mb_s,
            cfg.vmotion_overhead_mhz, cfg.migration_slots_per_host,
            cfg.migration_bandwidth)


def _migration_model(ref_mig: Optional[SimConfig], migration: bool,
                     rmeta: kernels.RulesMeta,
                     balancer: kernels.MigrationParams,
                     n_slots: int) -> MigrationModel:
    """The churn program's migration layer, from the migration-capable
    cells' shared config (``None``: no cell can move a VM).  The timed
    table holds one invocation's worst case: the correction's and the
    balancer's launches (within the bandwidth gate) and a full
    evacuation."""
    if not migration:
        rmeta, balancer = (kernels.RulesMeta(),
                           kernels.MigrationParams(max_moves=0))
    if ref_mig is None:
        return MigrationModel(rules=rmeta, balancer=balancer)
    limits = ref_mig.migration_limits or kernels.MigrationLimits()
    timed = not ref_mig.instant_migrations
    mig_table = 1
    if timed:
        launches = ((rmeta.move_bound if rmeta.any else 0)
                    + max(balancer.max_moves, 0))
        if limits.bandwidth is not None:
            launches = min(launches, limits.bandwidth)
        mig_table = max(launches + n_slots, 1)
    return MigrationModel(rules=rmeta, balancer=balancer, timed=timed,
                          mig_table=mig_table, limits=limits,
                          vmotion_rate_mb_s=ref_mig.vmotion_rate_mb_s,
                          vmotion_overhead_mhz=ref_mig.vmotion_overhead_mhz)


def _pack(cells: Sequence[BatchCell], slot_slack: float = 2.0,
          churn: bool = False, migration: bool = False,
          pad_hosts: int = 0, pad_slots: int = 0
          ) -> tuple[dict, list, kernels.RulesMeta]:
    """The pack: NumPy arrays keyed as :data:`PACK_KEYS` (and
    :data:`TREE_KEYS` when a cell's tree binds, :data:`RULE_KEYS` when the
    ``migration`` layer runs and a cell has rules of the kind), each
    bitwise the reference packer's (``repro.sim.batch``), the sorted tag
    names, and the grid's rule bounds (the fieldwise maximum of the
    cells').  A batch with a DPM cell or the migration layer widens the
    slot axis by ``slot_slack`` for the moves to land in.  ``pad_hosts``
    and ``pad_slots`` force the host axis and the slot axis before the
    slack up to at least those sizes."""
    S = len(cells)
    H = max(max(len(c.snapshot.hosts) for c in cells), int(pad_hosts))
    ts, drs_mask = _drs_schedule(cells[0].config)
    T = ts.shape[0]

    # Pass 1: the dense slot assignment, each cell's trace bank and rules.
    prepped = []
    n_bps = 1
    rmeta = kernels.RulesMeta()
    pack_rules = migration and any(c.snapshot.rules for c in cells)
    for c in cells:
        vms, order, hj, slot, counts = dense_slot_assignment(c.snapshot, H)
        vm_ids = [v.vm_id for v in vms]
        bank = c.trace_bank
        if bank is None:
            bank = TraceBank.from_traces(c.traces, vm_ids)
        if bank.fallback:
            bad = [vm_ids[r] for r, _ in bank.fallback]
            raise BatchUnsupported(
                f"cell {c.name!r}: traces without a declarative spec "
                f"cannot be batched: {bad[:5]}")
        if bank.rows.size:
            n_bps = max(n_bps, bank.bps.shape[1])
        pack = None
        if pack_rules:
            pack = RulesPack.from_rules(
                c.snapshot.rules, {v: i for i, v in enumerate(vm_ids)},
                {hid: j for j, hid in enumerate(c.snapshot.hosts)})
            rmeta = kernels.RulesMeta(
                *(max(x, y) for x, y in zip(rmeta, pack.meta())))
        prepped.append((vms, bank, order, hj, slot, counts, pack))
    J = max(max((int(p[5].max()) for p in prepped if p[5].size),
                default=1), 1, int(pad_slots))
    if (churn and any(c.dpm_enabled for c in cells)) or migration:
        J = int(math.ceil(J * max(slot_slack, 1.0)))
    tag_names = sorted({t for c in cells
                        for v in c.snapshot.vms.values() for t in v.tags})
    G = len(tag_names)
    E = max([len(c.config.power_events) for c in cells] + [1])
    # Trees: every cell padded to the widest; a tree-less cell keeps the
    # pads (no ancestors, infinite limits), under which every tree
    # operation is a no-op.
    trees = [c.snapshot.effective_tree() for c in cells]
    n_tree = max((t.n_nodes for t in trees if t is not None), default=0)

    def host_col(fill=0.0):
        return np.full((S, H), fill, dtype=np.float64)

    a = {
        "on": np.zeros((S, H), dtype=bool),
        "exists": np.zeros((S, H), dtype=bool),
        # Padded hosts keep a nonzero idle->peak range so Eq. 3 stays
        # finite; the `on` and `exists` masks zero everything they
        # produce.
        "idle": host_col(1.0), "peak": host_col(2.0),
        "cap_peak": host_col(1.0), "hyp": host_col(0.0),
        "host_mem": host_col(0.0), "caps0": host_col(0.0),
        "cpu_res": host_col(0.0),
        "budget": np.zeros(S), "enabled": np.zeros(S, dtype=bool),
        "dpm": np.zeros(S, dtype=bool),
        "bal_on": np.zeros(S, dtype=bool),
        "occ": np.zeros((S, H, J), dtype=bool),
        # Each slot's VM index in the cell (-1 when empty): per-host sums
        # that decide DPM's victim add in this order (trap T1).
        "vm": np.full((S, H, J), -1, dtype=np.int64),
        "reservation": np.zeros((S, H, J)),
        "limit": np.full((S, H, J), np.inf),
        "weights": np.full((S, H, J), 1e-12),
        "migratable": np.ones((S, H, J), dtype=bool),
        "tag_masks": np.zeros((S, H, J, G), dtype=bool),
        "bps": np.full((S, H, J, n_bps), np.inf),
        "cpu_vals": np.zeros((S, H, J, n_bps)),
        "mem_vals": np.zeros((S, H, J, n_bps)),
        "period": np.full((S, H, J), np.inf),
        "ev_t": np.full((S, E), np.inf),
        "ev_host": np.zeros((S, E), dtype=np.int64),
        "ev_on": np.zeros((S, E), dtype=bool),
        "ts": ts, "drs_mask": drs_mask,
        "win_mask": np.zeros((T, S), dtype=bool),
    }
    a["bps"][..., 0] = 0.0
    if n_tree:
        a["tree_anc"] = np.zeros((S, H, n_tree), dtype=bool)
        a["tree_limit"] = np.full((S, n_tree), np.inf)
        a["tree_depth"] = np.full((S, n_tree), -1, dtype=np.int64)
    if pack_rules and rmeta.n_groups:
        a["aff_group"] = np.full((S, H, J), -1, dtype=np.int64)
    if pack_rules and rmeta.n_vmhost:
        a["allowed"] = np.ones((S, H, J, H), dtype=bool)
    if pack_rules and rmeta.n_anti:
        a["anti"] = np.zeros((S, H, J, rmeta.n_anti), dtype=bool)

    for i, c in enumerate(cells):
        snap = c.snapshot
        vms, bank, order, hj, slot, counts, pack = prepped[i]
        host_idx = {hid: j for j, hid in enumerate(snap.hosts)}
        for j, h in enumerate(snap.hosts.values()):
            a["on"][i, j] = h.powered_on
            a["exists"][i, j] = True
            a["idle"][i, j] = h.spec.power_idle
            a["peak"][i, j] = h.spec.power_peak
            a["cap_peak"][i, j] = h.spec.capacity_peak
            a["hyp"][i, j] = h.spec.hypervisor_overhead
            a["host_mem"][i, j] = h.spec.memory_mb
            a["caps0"][i, j] = h.power_cap
        n = len(vms)
        res = np.array([v.reservation for v in vms])
        a["occ"][i, hj, slot] = True
        a["vm"][i, hj, slot] = order
        a["reservation"][i, hj, slot] = res[order]
        a["limit"][i, hj, slot] = np.array([v.limit for v in vms])[order]
        a["weights"][i, hj, slot] = np.maximum(
            np.array([v.shares for v in vms]), 1e-12)[order]
        a["migratable"][i, hj, slot] = np.array(
            [v.migratable for v in vms], dtype=bool)[order]
        host_on = np.zeros(H, dtype=bool)
        host_on[:len(snap.hosts)] = [h.powered_on
                                     for h in snap.hosts.values()]
        a["cpu_res"][i, :] = np.where(
            host_on, np.bincount(hj, weights=res[order], minlength=H), 0.0)
        for g, tag in enumerate(tag_names):
            tagged = np.array([tag in v.tags for v in vms], dtype=bool)
            a["tag_masks"][i, hj, slot, g] = tagged[order]
        if "aff_group" in a:
            a["aff_group"][i, hj, slot] = pack.affinity_group[order]
        if "allowed" in a:
            a["allowed"][i, hj, slot, :len(snap.hosts)] = pack.allowed[order]
        if "anti" in a and pack.n_anti:
            a["anti"][i, hj, slot, :pack.n_anti] = pack.anti_member.T[order]
        # Demand traces in TraceBank's padded step-function layout;
        # trace-less VMs freeze at their initial demand.
        dem0 = np.array([v.demand for v in vms])
        mem0 = np.array([v.mem_demand for v in vms])
        bps = np.full((n, n_bps), np.inf)
        bps[:, 0] = 0.0
        cpu = np.repeat(dem0[:, None], n_bps, axis=1)
        mem = np.repeat(mem0[:, None], n_bps, axis=1)
        period = np.full(n, np.inf)
        if bank.rows.size:
            k = bank.bps.shape[1]
            bps[bank.rows, :k] = bank.bps
            cpu[bank.rows, :k] = bank.cpu_vals
            mem[bank.rows, :k] = bank.mem_vals
            cpu[bank.rows, k:] = bank.cpu_vals[:, -1:]
            mem[bank.rows, k:] = bank.mem_vals[:, -1:]
            period[bank.rows] = bank.period
        a["bps"][i, hj, slot] = bps[order]
        a["cpu_vals"][i, hj, slot] = cpu[order]
        a["mem_vals"][i, hj, slot] = mem[order]
        a["period"][i, hj, slot] = period[order]
        a["budget"][i] = snap.power_budget
        if n_tree and trees[i] is not None:
            tree, h_c = trees[i], len(snap.hosts)
            a["tree_anc"][i, :h_c, :tree.n_nodes] = tree.host_anc
            a["tree_limit"][i, :tree.n_nodes] = tree.limit
            a["tree_depth"][i, :tree.n_nodes] = tree.depth
        a["enabled"][i] = c.powercap_enabled
        a["dpm"][i] = c.dpm_enabled
        a["bal_on"][i] = c.balancer_enabled
        for e, (ev_t, host_id, on) in enumerate(
                sorted(c.config.power_events)):
            a["ev_t"][i, e] = ev_t
            a["ev_host"][i, e] = host_idx[host_id]
            a["ev_on"][i, e] = bool(on)
        if c.window is not None:
            w0, w1 = c.window
            a["win_mask"][:, i] = (w0 <= ts) & (ts < w1)
    return a, tag_names, rmeta


#: Serializes the kernel builds that :meth:`BatchedSimulator.compile` starts
#: from the sweep pipeline's worker threads.
_COMPILE_LOCK = threading.Lock()


def check_n_devices(n_devices: Optional[int], n_cells: int) -> int:
    """The ranks a grid of ``n_cells`` splits over: ``n_devices``
    (``None``: the process group's world size, 1 without one) clamped to
    ``[1, n_cells]``, as the reference clamps it; above the world size
    it raises ``ValueError``."""
    world = sharding.world_size()
    n = world if n_devices is None else int(n_devices)
    n = max(1, min(n, n_cells))
    if n > world:
        raise ValueError(f"n_devices={n_devices}: {n} ranks outside [1, "
                         f"{world}] in the process group (start the ranks "
                         f"with repro_torch.launch.mesh.spawn)")
    return n


def pad_cells(arrays: dict, pad: int) -> dict:
    """The packed arrays with ``pad`` copies of the leading cells appended
    to the cells axis (axis 1 of ``win_mask``, none for the time grid's
    ``ts`` and ``drs_mask``).  Cells are independent, so the copies'
    results are dropped and the kept cells' are exact."""
    if not pad:
        return arrays
    return {k: (v if k in ("ts", "drs_mask")
                else np.concatenate([v, v[:, :pad]], axis=1)
                if k == "win_mask"
                else np.concatenate([v, v[:pad]], axis=0))
            for k, v in arrays.items()}


def _cell_slice(arrays: dict, lo: int, hi: int) -> dict:
    """Cells ``lo:hi`` of the packed arrays."""
    return {k: (v if k in ("ts", "drs_mask") else v[:, lo:hi]
                if k == "win_mask" else v[lo:hi])
            for k, v in arrays.items()}


class BatchedSimulator:
    """Simulate S scenario cells at once.

    Cells must share the time grid (``duration_s``/``tick_s``) and DRS
    schedule, in the churn regime the power latencies, and, when they can
    migrate a VM, the migration execution model; host counts, VM counts,
    traces, budgets, trees, rules, policies, windows, DPM flags and
    scripted power events vary per cell (smaller cells are padded).
    ``waterfill_iters``: the bisection trips of every waterfill (100 reaches
    the float64 fixed point for realistic magnitudes).  ``balancer`` (a
    ``kernels.MigrationParams``) runs the hill-climb migration balancer for
    the cells with ``balancer_enabled``; the default (``max_moves=0``) runs
    none.  ``slot_slack`` widens the slot axis of a batch with DPM cells or
    the migration layer so that moves have somewhere to land; a run whose
    moves would need more raises after the run, naming it, rather than
    diverge.  ``device=None`` runs on the GPU; pass ``device="cpu"`` for
    the plain PyTorch versions of the kernels.  After :meth:`run`,
    :attr:`info` holds the tick loop's counts: ticks, ticks with an
    invocation, and device-to-host reads (``branch_reads``, of which
    ``migration_reads`` are the migration layer's, one a round).

    ``pad_hosts`` and ``pad_slots`` force the packed host axis and the slot
    axis before the slack up to at least those sizes: the sweep's pad
    buckets pack every cell of a pow2 shape class to one shape.  Padded
    hosts and slots are masked inside every primitive.

    ``n_devices`` splits the cells over the first ``n_devices`` ranks of
    the process group, by world rank, clamped by :func:`check_n_devices`
    (``None``: every rank of the process group; one rank without one):
    the reference's ``("cells",)`` mesh, whose one dimension is the world
    order, so no ``DeviceMesh`` is built.  Every rank of the world runs
    the same call: the cells axis is padded with copies of the leading
    cells to a multiple of the ranks (:func:`pad_cells`), world rank
    ``r < n_devices`` runs the ``r``-th contiguous shard through the same
    program on its own device (K1 a tick and K2 a DRS period over its
    shard, no collective inside the tick loop), a rank past the split
    runs nothing, and the harvest gathers the per-cell results over the
    whole world (``all_gather_objects``) to every rank in grid order and
    drops the copies.  :attr:`info` counts the rank's own loop, and its
    ``gather_s`` is the gather's wall.
    """

    def __init__(self, cells: Sequence[BatchCell],
                 balance: Optional[kernels.BalanceParams] = None,
                 dpm: Optional[kernels.DPMParams] = None,
                 waterfill_iters: int = 100,
                 slot_slack: float = 2.0,
                 balancer: Optional[kernels.MigrationParams] = None,
                 keep_timeseries: bool = False,
                 device=None,
                 n_devices: Optional[int] = None,
                 pad_hosts: int = 0,
                 pad_slots: int = 0):
        if not cells:
            raise ValueError("no cells")
        cells = list(cells)
        n_dev = check_n_devices(n_devices, len(cells))
        dev = resolve_device(device)
        balancer = balancer or kernels.MigrationParams(max_moves=0)
        churn = any(c.dpm_enabled or c.config.power_events for c in cells)
        # The migration layer runs where the grid can move a VM: rule
        # violations at the start, a live balancer, or rules that DPM's
        # evacuations must keep (and a later correction re-gather).
        has_rules = any(c.snapshot.rules for c in cells)
        migration = ((balancer.max_moves > 0
                      and any(c.balancer_enabled for c in cells))
                     or any(rules_mod.all_violations(c.snapshot)
                            for c in cells)
                     or (has_rules and any(c.dpm_enabled for c in cells)))
        reasons, ref_mig = _partition(cells, balancer)
        if reasons:
            name, why = next(iter(reasons.items()))
            raise BatchUnsupported(f"cell {name!r}: {why}")
        t0 = time.perf_counter()
        arrays, tag_names, rmeta = _pack(cells, slot_slack, churn,
                                         migration, pad_hosts, pad_slots)
        model = None
        if churn or migration:
            model = _migration_model(ref_mig, migration, rmeta, balancer,
                                     arrays["occ"].shape[-1])
        cfg = cells[0].config
        self._setup(arrays, [c.name for c in cells], tag_names,
                    np.array([c.window is not None for c in cells]),
                    cfg.tick_s, balance or kernels.BalanceParams(),
                    waterfill_iters, keep_timeseries, dev, model,
                    dpm or kernels.DPMParams(),
                    Schedule(cfg.drs_period_s, cfg.drs_first_at_s,
                             cfg.power_on_latency_s,
                             cfg.power_off_latency_s))
        self.n_devices = n_dev
        self.pack_s = time.perf_counter() - t0

    @staticmethod
    def unsupported_cells(cells: Sequence[BatchCell],
                          balancer: Optional[kernels.MigrationParams] = None
                          ) -> dict[str, str]:
        """Cell name -> the reason the engine cannot replay it, for every
        such cell, anchored on the first supportable cell's time grid and
        migration model."""
        return _partition(cells, balancer or kernels.MigrationParams(
            max_moves=0), check_traces=True)[0]

    @classmethod
    def from_pack(cls, arrays: dict, names: list, tag_names: list,
                  has_window, tick_s: float,
                  balance: kernels.BalanceParams, waterfill_iters: int,
                  keep_timeseries: bool, device=None,
                  migration: Optional[MigrationModel] = None,
                  dpm: Optional[kernels.DPMParams] = None,
                  schedule: Optional[Schedule] = None
                  ) -> "BatchedSimulator":
        """A simulator over arrays already packed (keys :data:`PACK_KEYS`
        and, when present, :data:`TREE_KEYS` and :data:`RULE_KEYS`; extra
        keys are ignored).  ``migration`` is the churn program's migration
        layer (``None``: the cap-only regime)."""
        keys = PACK_KEYS + tuple(k for k in TREE_KEYS + RULE_KEYS
                                 if k in arrays)
        sim = cls.__new__(cls)
        sim._setup({k: arrays[k] for k in keys}, list(names),
                   list(tag_names), np.asarray(has_window, dtype=bool),
                   tick_s, balance, waterfill_iters, keep_timeseries,
                   resolve_device(device), migration,
                   dpm or kernels.DPMParams(), schedule or Schedule())
        sim.pack_s = 0.0
        return sim

    def _setup(self, arrays, names, tag_names, has_window, tick_s, balance,
               waterfill_iters, keep_timeseries, device, migration, dpm,
               schedule) -> None:
        self._arrays = arrays
        self.names = names
        self._tag_names = tag_names
        self._has_window = has_window
        self._tick_s = float(tick_s)
        self._balance = balance
        self._iters = int(waterfill_iters)
        self._keep_timeseries = bool(keep_timeseries)
        self.device = device
        self._churn = migration is not None
        self._mig = migration
        self._dpm = dpm
        self._schedule = schedule
        self.n_devices = 1
        self.info: dict = {}

    # ------------------------------------------------------------- running
    def compile(self) -> float:
        """Build the kernels the program launches; returns the seconds
        spent, 0.0 once they are built.  The twin of the reference's AOT
        compile and its persistent compilation cache: the libraries land
        in ``build/repro_torch_kernels/`` and later processes load them
        without building.  K2's plan is taken at the packed shape here, so
        a cell too wide for it raises before the run.  Thread-safe."""
        if self.device.type != "cuda":
            return 0.0
        from repro_torch.kernels.powercap import kernel
        t0 = time.perf_counter()
        with _COMPILE_LOCK:
            kernel.library()
        S, H, J = self._arrays["occ"].shape
        kernel.balance_plan(S, H, J, kernel.max_active_clusters(
            J, self.device.index))
        return time.perf_counter() - t0

    def run_async(self) -> "PendingBatch":
        """Build the kernels if needed, upload the pack and run the
        program, and return before the harvest: on the GPU the cap-only
        program is enqueued without a wait, so the caller can pack or
        dispatch the next batch while the card works.  The churn program
        reads one flag a tick (and the migration layer one a round, see
        :attr:`info`), so it waits on the card at each of those reads and
        has mostly run when this returns.  :meth:`PendingBatch.result`
        harvests."""
        compile_s = self.compile()
        t0 = time.perf_counter()
        host = self._shard()
        if host is None:
            return PendingBatch(self, None, t0, compile_s)
        skip = _HOST_KEYS + (() if self._churn else _CHURN_KEYS)
        a = {k: torch.as_tensor(v, device=self.device)
             for k, v in host.items() if k not in skip}
        if self._churn:
            return PendingBatch(self, self._program_churn(a, host["ev_t"]),
                                t0, compile_s)
        return PendingBatch(self, self._program(a), t0, compile_s)

    def _shard(self) -> dict:
        """This rank's cells of the packed arrays (all of them on one
        rank), after :func:`pad_cells`; None on a rank past the split."""
        n, r = self.n_devices, sharding.rank()
        if n == 1:
            return self._arrays
        if r >= n:
            return None
        S = len(self.names)
        per = (S + (-S) % n) // n
        return _cell_slice(pad_cells(self._arrays, (-S) % n), r * per,
                           (r + 1) * per)

    def run(self) -> BatchResult:
        return self.run_async().result()

    def _tree(self, a: dict) -> Optional[kernels.TreeCols]:
        if "tree_anc" not in a:
            return None
        return kernels.TreeCols(a["tree_anc"], a["tree_limit"],
                                a["tree_depth"])

    def _deliver(self, a: dict, hosts, caps, active, slots: dict, cpu, mem,
                 host_mem, overhead=None):
        """One tick's delivery and accounting at the given state: the
        waterfill (K1 on the GPU), Eq. 1 power and the tick's rates.
        ``overhead`` is the in-flight vMotions' CPU on each host: it leaves
        the delivery capacity and counts toward Eq. 1's utilization."""
        on, limit = hosts.on, slots["limit"]
        managed = kernels.managed_capacity(hosts, caps)
        if overhead is not None:
            managed = torch.clamp_min(managed - overhead, 0.0)
        dem = torch.where(active, torch.minimum(cpu, limit), 0.0)
        floors = torch.where(active,
                             torch.minimum(slots["reservation"], dem), 0.0)
        alloc = waterfill_dense(managed, floors, dem, slots["weights"],
                                self._iters, active=active)
        mem_dem_h = torch.where(active, mem, 0.0).sum(-1)
        # Eq. 1 power, utilization measured against peak capacity.
        busy = alloc.sum(-1)
        if overhead is not None:
            busy = busy + overhead
        power = kernels.power_consumed(hosts, busy / a["cap_peak"])
        tick = {
            "cpu_payload_mhz_s": alloc.sum((-1, -2)),
            "cpu_demand_mhz_s": dem.sum((-1, -2)),
            "mem_payload_mb_s": torch.minimum(mem_dem_h, host_mem).sum(-1),
            "mem_demand_mb_s": mem_dem_h.sum(-1),
            "energy_j": (power * on).sum(-1),
        }
        tag_masks = slots["tag_masks"]
        tag_pay = (tag_masks * alloc[..., None]).sum((-3, -2))
        tag_dem = (tag_masks * dem[..., None]).sum((-3, -2))
        return tick, tag_pay, tag_dem, mem_dem_h

    @staticmethod
    def _demands(slots: dict, finite, t: float):
        """Demand at ``t`` from the packed step-function traces;
        ``finite`` is ``isfinite(slots["period"])``, taken where the slots
        last changed."""
        period = slots["period"]
        phase = torch.where(finite, torch.remainder(t, period), t)
        idx = torch.clamp_min(
            (slots["bps"] <= phase[..., None]).sum(-1) - 1, 0)[..., None]
        return (torch.gather(slots["cpu_vals"], -1, idx)[..., 0],
                torch.gather(slots["mem_vals"], -1, idx)[..., 0])

    def _program(self, a: dict) -> dict:
        """The cap-only tick loop over the shared time grid (the
        reference's ``build_static``)."""
        dev, f64, i32 = self.device, torch.float64, torch.int32
        S, G = a["on"].shape[0], len(self._tag_names)
        dt, iters = self._tick_s, self._iters
        hosts = kernels.HostCols(a["on"], a["idle"], a["peak"],
                                 a["cap_peak"], a["hyp"])
        on, enabled = a["on"], a["enabled"]
        active = a["occ"] & on[..., None]
        weights, reservation, limit = (a["weights"], a["reservation"],
                                       a["limit"])
        floor_caps = kernels.reserved_floor_caps(hosts, a["cpu_res"])
        vm_floors = torch.where(active, torch.minimum(reservation, limit),
                                0.0)
        host_mem = torch.where(on, a["host_mem"], 0.0)
        finite = torch.isfinite(a["period"])
        tcols = self._tree(a)

        def invoke_manager(caps, cpu):
            """RedivvyPowerCap then BalancePowerCap, counting cap changes
            as the object plane emits them; with a tree, each projected
            under the node limits, where the object plane projects."""
            redivvied = kernels.redivvy_caps(on, caps, floor_caps)
            if tcols is not None:
                redivvied = kernels.tree_project_caps(tcols, on, redivvied,
                                                      floor_caps)
            caps1 = torch.where(enabled[:, None], redivvied, caps)
            changes = kernels.count_cap_changes(on, caps, caps1)
            vm_ceils = torch.where(
                active, kernels.clip(cpu, reservation, limit), 0.0)
            caps2, _ = kernels.balance_caps(
                hosts, caps1,
                kernels.DenseCols(vm_floors, vm_ceils, weights, active,
                                  iters),
                a["cpu_res"], a["budget"], enabled, self._balance,
                plan_cells=len(self.names))
            if tcols is not None:
                caps2 = torch.where(
                    enabled[:, None],
                    kernels.tree_project_caps(tcols, on, caps2, floor_caps),
                    caps2)
            return caps2, changes + kernels.count_cap_changes(on, caps1,
                                                              caps2)

        caps = a["caps0"]
        acc = {k: torch.zeros(S, dtype=f64, device=dev) for k in FIELDS}
        win = dict(acc)
        tag_pay = torch.zeros((S, G), dtype=f64, device=dev)
        tag_dem = torch.zeros((S, G), dtype=f64, device=dev)
        no_changes = torch.zeros(S, dtype=i32, device=dev)
        n_changes = no_changes
        max_total = (caps * on).sum(-1)
        if tcols is not None:
            over_tree = torch.full((S,), -torch.inf, dtype=f64, device=dev)
        series = []
        ts, drs_mask = self._arrays["ts"], self._arrays["drs_mask"]
        for i in range(ts.shape[0]):
            cpu, mem = self._demands(a, finite, float(ts[i]))
            changes = no_changes
            if drs_mask[i]:
                caps, changes = invoke_manager(caps, cpu)
            tick, tp, td, _ = self._deliver(a, hosts, caps, active, a, cpu,
                                            mem, host_mem)
            in_win = a["win_mask"][i]
            acc = {k: acc[k] + tick[k] * dt for k in acc}
            win = {k: win[k] + torch.where(in_win, tick[k], 0.0) * dt
                   for k in win}
            tag_pay = tag_pay + tp * dt
            tag_dem = tag_dem + td * dt
            n_changes = n_changes + changes
            max_total = torch.maximum(max_total, (caps * on).sum(-1))
            if tcols is not None:
                over_tree = torch.maximum(over_tree, (
                    kernels.tree_node_sums(tcols, on, caps)
                    - tcols.limit).amax(-1))
            if self._keep_timeseries:
                series.append(dict(tick, cap_changes=changes))
        self.info = dict(ticks=int(ts.shape[0]),
                         invocation_ticks=int(drs_mask.sum()),
                         branch_reads=0)
        zi = torch.zeros(S, dtype=i32, device=dev)
        out = {"acc": acc, "win": win, "tag_payload": tag_pay,
               "tag_demand": tag_dem, "cap_changes": n_changes,
               "vmotions": zi, "power_ons": zi, "power_offs": zi,
               "over_budget": max_total - a["budget"], "final_caps": caps,
               "final_on": on, "final_occ": a["occ"],
               "slot_pressure": torch.zeros(S, dtype=torch.bool, device=dev)}
        if tcols is not None:
            out["over_tree"] = over_tree
        if self._keep_timeseries:
            out["timeseries"] = {k: torch.stack([s[k] for s in series])
                                 for k in series[0]}
            for k in ("vmotions", "power_ons", "power_offs"):
                out["timeseries"][k] = torch.zeros_like(
                    out["timeseries"]["cap_changes"])
        return out

    # --------------------------------------------------------------- churn
    def _program_churn(self, a: dict, ev_t: np.ndarray) -> dict:
        """The capacity-churn tick loop (the reference's ``build_churn``):
        power states, the slot layout, the DRS schedule and, in the timed
        regime, the in-flight migration table are carried per cell."""
        dev, f64, i32, i64 = (self.device, torch.float64, torch.int32,
                              torch.int64)
        S, H = a["on"].shape
        J = a["occ"].shape[-1]
        G = len(self._tag_names)
        dt, iters, dpmp, sched, mig = (self._tick_s, self._iters, self._dpm,
                                       self._schedule, self._mig)
        timed, M = mig.timed, mig.mig_table
        h_idx = torch.arange(H, device=dev)
        s_idx = torch.arange(S, device=dev)
        exists, enabled, budget = a["exists"], a["enabled"], a["budget"]
        host_mem_spec = a["host_mem"]
        tcols = self._tree(a)
        slot_keys = SLOT_KEYS + tuple(k for k in RULE_KEYS if k in a)
        pads = dict(_SLOT_PAD, bps=torch.where(
            torch.arange(a["bps"].shape[-1], device=dev) == 0, 0.0,
            torch.inf).to(f64))
        reads = {"branch": 0, "migration": 0}

        def read(flag) -> bool:
            """A migration-layer loop's one read a round."""
            reads["migration"] += 1
            return bool(flag)

        def hosts_of(on):
            return kernels.HostCols(on, a["idle"], a["peak"], a["cap_peak"],
                                    a["hyp"])

        def host_sum_vm_order(vals, act, vm):
            # Per-host sums added left to right in VM-index order, as the
            # object plane's ``bincount`` adds them: slot order stops
            # agreeing once a VM lands in a free slot, and on the near-ties
            # BalancePowerCap makes, one ULP flips DPM's victim (trap T1).
            # Empty slots sort last and add +0.0.
            key = torch.where(act, vm, torch.iinfo(i64).max)
            sv = torch.gather(torch.where(act, vals, 0.0), -1,
                              kernels.stable_argsort(key))
            acc = torch.zeros(sv.shape[:-1], dtype=f64, device=dev)
            for j in range(sv.shape[-1]):
                acc = acc + sv[..., j]
            return acc

        def apply_remap(work, move, victim, order, dests):
            """The victim's occupied slots to their destinations' first
            free slots, one ``move_slot`` per evacuee."""
            for k in range(J):
                dest = dests[:, k]
                work, _ = kernels.move_slot(work, move & (dest >= 0), victim,
                                            order[:, k], dest, pads)
            return work

        def no_moves(n):
            return (torch.full((S, max(n, 1), 3), -1, dtype=i64, device=dev),
                    torch.zeros(S, dtype=i64, device=dev))

        def replay(table, moves, n_moves, t):
            """Append an invocation's moves to the in-flight table (timed
            regime), replaying them on a scratch ``(occ, mem)`` copy so that
            a chained move reads the memory that travelled with its VM.
            Each entry ends at the running maximum of the ends so far
            (FIFO), and records which entry last moved its slot, so that
            the endpoint overhead follows the VM's current host while
            earlier legs are in flight."""
            (sc, msrc, mj, mdst, mend, mprev, cur, end) = table
            k_idx = torch.arange(M, device=dev)
            for k in range(moves.shape[1]):
                do = k < n_moves
                src, j, dst = moves[:, k, 0], moves[:, k, 1], moves[:, k, 2]
                si, ji = torch.clamp(src, 0, H - 1), torch.clamp(j, 0, J - 1)
                prev_v = sc["idx"][s_idx, si, ji]
                dur = torch.clamp_min(
                    torch.clamp_min(sc["mem"][s_idx, si, ji], 64.0)
                    / mig.vmotion_rate_mb_s, dt)
                end = torch.where(do, torch.maximum(end, t + dur), end)
                at = do[:, None] & (k_idx == cur[:, None])
                msrc = torch.where(at, src[:, None], msrc)
                mj = torch.where(at, j[:, None], mj)
                mdst = torch.where(at, dst[:, None], mdst)
                mend = torch.where(at, end[:, None], mend)
                mprev = torch.where(at, prev_v[:, None], mprev)
                idx = sc["idx"].clone()
                idx[s_idx, si, ji] = torch.where(do, cur, prev_v)
                sc, _ = kernels.move_slot(dict(sc, idx=idx), do, src, j, dst,
                                          {"occ": False, "mem": 0.0,
                                           "idx": -1})
                cur = cur + do.to(i64)
            return (sc, msrc, mj, mdst, mend, mprev, cur, end)

        def invocation(c, can, t):
            # Demands at t in the pre-invocation layout; they ride in the
            # working bundle, so migrations move them with their VM.
            cpu, mem = self._demands(c["slots"], c["finite"], t)
            mem_pre = mem                   # the timed replay's durations
            on, caps = c["on"], c["caps"]
            hosts = hosts_of(on)
            work = dict(c["slots"], cpu=cpu, mem=mem)
            vmot = torch.zeros(S, dtype=i32, device=dev)
            mig_pressure = torch.zeros(S, dtype=torch.bool, device=dev)
            launch = None
            corr = bal = None

            # Phase 1a: constraint correction under the capacity view --
            # fundable capacity (reserved-floor caps plus the whole
            # unreserved pool, paper Fig. 3) for cpc cells, managed
            # capacity at the current caps for static ones.
            if mig.rules.any:
                act0 = work["occ"] & on[..., None]
                floors_pre = kernels.reserved_floor_caps(
                    hosts, torch.where(act0, work["reservation"],
                                       0.0).sum(-1))
                spare = torch.clamp_min(
                    budget - torch.where(on, floors_pre, 0.0).sum(-1), 0.0)
                fundable = kernels.managed_capacity(
                    hosts, torch.minimum(floors_pre + spare[:, None],
                                         a["peak"]))
                cap_view = torch.where(
                    on, torch.where(enabled[:, None], fundable,
                                    kernels.managed_capacity(hosts, caps)),
                    0.0)
                work, moves, n_moves, prs, launch = \
                    kernels.correct_constraints_slots(
                        hosts, cap_view, work, host_mem_spec, mig.rules, can,
                        *no_moves(mig.rules.move_bound), pads=pads,
                        limits=mig.limits, launch=launch, read=read)
                corr = (moves, n_moves)
                vmot = vmot + n_moves.to(i32)
                mig_pressure = mig_pressure | prs

            act3 = work["occ"] & on[..., None]
            res, lim = work["reservation"], work["limit"]
            cpu_res = torch.where(act3, res, 0.0).sum(-1)

            # Phase 1b: reserved-floor redivvy (Powercap Allocation) on the
            # corrected placements.
            apply_cpc = can & enabled
            floor_caps = kernels.reserved_floor_caps(hosts, cpu_res)
            redivvied = kernels.redivvy_caps(on, caps, floor_caps)
            if tcols is not None:
                redivvied = kernels.tree_project_caps(tcols, on, redivvied,
                                                      floor_caps)
            caps1 = torch.where(apply_cpc[:, None], redivvied, caps)
            changes = torch.where(
                can, kernels.count_cap_changes(on, caps, caps1), 0)

            # Phase 2: BalancePowerCap.
            vm_floors = torch.where(act3, torch.minimum(res, lim), 0.0)
            vm_ceils = torch.where(act3, kernels.clip(work["cpu"], res, lim),
                                   0.0)
            caps2, _ = kernels.balance_caps(
                hosts, caps1,
                kernels.DenseCols(vm_floors, vm_ceils, work["weights"], act3,
                                  iters),
                cpu_res, budget, apply_cpc, self._balance,
                plan_cells=len(self.names))
            if tcols is not None:
                caps2 = torch.where(
                    apply_cpc[:, None],
                    kernels.tree_project_caps(tcols, on, caps2, floor_caps),
                    caps2)
            changes = changes + torch.where(
                can, kernels.count_cap_changes(on, caps1, caps2), 0)

            # Phase 2b: the residual imbalance fixed by migrations (DRS's
            # hill-climb, for every policy).
            if mig.balancer.max_moves > 0:
                work, moves, n_moves, prs, launch = \
                    kernels.balance_migrations(
                        hosts, caps2, work, host_mem_spec, mig.balancer,
                        mig.rules, can & a["bal_on"],
                        *no_moves(mig.balancer.max_moves), pads=pads,
                        limits=mig.limits, launch=launch, read=read)
                bal = (moves, n_moves)
                vmot = vmot + n_moves.to(i32)
                mig_pressure = mig_pressure | prs
                act3 = work["occ"] & on[..., None]
                res, lim = work["reservation"], work["limit"]
                cpu_res = torch.where(act3, res, 0.0).sum(-1)

            # Phase 3: DPM's triggers and Powercap Redistribution, on the
            # layout after the migrations.
            occ, cpu, mem = work["occ"], work["cpu"], work["mem"]
            eff_slot = torch.where(act3, kernels.clip(cpu, res, lim), 0.0)
            eff_h = host_sum_vm_order(eff_slot, act3, work["vm"])
            mem_h = host_sum_vm_order(mem, act3, work["vm"])
            cpu_util, mem_util = kernels.host_utilizations(
                hosts, caps2, eff_h, mem_h, host_mem_spec)
            hot_any = kernels.dpm_hot_mask(on, cpu_util, mem_util,
                                           dpmp.high_util).any(-1)
            standby = exists & ~on
            cand = standby.to(torch.uint8).argmax(-1)   # the first standby
            do_dpm = can & a["dpm"]

            # Power-on: fund the first standby host's cap (the decreases
            # execute now, and so does the candidate's cap, which counts
            # toward the budget while pending; the host joins when the
            # power-on timer fires).
            want_on = do_dpm & hot_any & standby.any(-1)
            funded, granted = kernels.power_on_funding_caps(
                hosts, caps2, cand, cpu_util, eff_h, cpu_res, budget,
                dpmp.high_util, tree=tcols)
            cand_cols = kernels.HostCols(
                torch.ones((S, 1), dtype=torch.bool, device=dev),
                *(torch.gather(col, -1, cand[:, None])
                  for col in (a["idle"], a["peak"], a["cap_peak"],
                              a["hyp"])))
            feasible = kernels.managed_capacity(
                cand_cols, granted[:, None])[:, 0] > 0.0
            do_on = want_on & torch.where(enabled, feasible, True)
            fund = do_on & enabled
            is_cand = h_idx == cand[:, None]
            caps3 = torch.where(fund[:, None], funded, caps2)
            changes = changes + torch.where(
                fund, kernels.count_cap_changes(on | is_cand, caps2, funded),
                0)

            # Power-off: sustained cluster-wide low utilization, the
            # stability window elapsed, and a complete evacuation plan.
            all_low = kernels.dpm_all_low(on, cpu_util, mem_util,
                                          dpmp.low_util)
            ls = torch.where(torch.isnan(c["low_since"]), t, c["low_since"])
            oldest = torch.maximum(
                torch.where(on, ls, -torch.inf).amax(-1), c["last_cfg"])
            window_ok = (t - oldest) >= dpmp.stable_window_s
            maybe_off = (do_dpm & ~hot_any & (on.sum(-1) > 1) & all_low
                         & window_ok)
            victim = torch.where(on, kernels.util_rank_key(cpu_util),
                                 torch.inf).argmin(-1)
            scope = None
            if tcols is not None:
                scope = kernels.tree_evac_scope(tcols, on, caps2, victim)
            ok, order, dests, n_evac, pressure = kernels.plan_evacuation(
                hosts, caps2, victim, occ, eff_slot, mem, res,
                work["migratable"], host_mem_spec, dpmp.target_util,
                allowed=work.get("allowed"), anti=work.get("anti"),
                scope=scope)
            do_off = maybe_off & ok
            vmot = vmot + torch.where(do_off, n_evac, 0).to(i32)
            reabsorbed = kernels.power_off_reabsorb_caps(
                hosts, caps2, victim, budget, tree=tcols)
            # The deferred actions touch exactly the hosts whose change
            # clears the emission threshold.
            changed = on & ((reabsorbed - caps2).abs()
                            > kernels.CAP_CHANGE_EPS)
            off_cpc = do_off & enabled
            pend_cnt = torch.where(off_cpc, changed.sum(-1), 0).to(i32)
            out = dict(
                c, caps=caps3,
                pon_idx=torch.where(do_on, cand, c["pon_idx"]),
                pon_end=torch.where(do_on, t + sched.power_on_latency_s,
                                    c["pon_end"]),
                poff_idx=torch.where(do_off, victim, c["poff_idx"]),
                pend_caps=torch.where(
                    do_off[:, None],
                    torch.where(off_cpc[:, None], reabsorbed, caps3),
                    c["pend_caps"]),
                pend_mask=torch.where(do_off[:, None],
                                      off_cpc[:, None] & changed,
                                      c["pend_mask"]),
                pend_cnt=torch.where(do_off, pend_cnt, c["pend_cnt"]),
                n_changes=c["n_changes"] + changes.to(i32),
                slot_pressure=c["slot_pressure"] | mig_pressure
                | (maybe_off & pressure))
            if not timed:
                work = apply_remap(work, do_off, victim, order, dests)
                return dict(
                    out, slots={k: work[k] for k in slot_keys},
                    finite=torch.isfinite(work["period"]),
                    poff_end=torch.where(
                        do_off, t + sched.power_off_latency_s,
                        c["poff_end"]),
                    vmotions=c["vmotions"] + vmot)
            # Timed regime: the what-if layout above shaped decisions only.
            # The carried slots stay as they were; every move joins the
            # in-flight table and commits on its vMotion schedule (step 2b)
            # through the same ``move_slot`` sequence, so the landing slots
            # coincide.  vMotions are counted as they commit.
            table = ({"occ": c["slots"]["occ"], "mem": mem_pre,
                      "idx": torch.full((S, H, J), -1, dtype=i64,
                                        device=dev)},
                     c["mig_src"], c["mig_j"], c["mig_dst"], c["mig_end"],
                     c["mig_prev"], torch.zeros(S, dtype=i64, device=dev),
                     torch.full((S,), -torch.inf, dtype=f64, device=dev))
            for moved in (corr, bal):
                if moved is not None:
                    table = replay(table, *moved, t)
            evac = torch.stack([victim[:, None].expand(-1, J), order,
                                dests], -1)
            table = replay(table, evac, torch.where(
                do_off, (dests >= 0).sum(-1), 0), t)
            # A power-off waits for its evacuations to commit (its
            # prerequisites); they are appended last and ends are FIFO, so
            # "last evacuation done" is "table drained".  No evacuee: the
            # timer starts now.
            wait = do_off & (n_evac > 0)
            return dict(
                out, mig_src=table[1], mig_j=table[2], mig_dst=table[3],
                mig_end=table[4], mig_prev=table[5],
                poff_end=torch.where(do_off & ~wait,
                                     t + sched.power_off_latency_s,
                                     c["poff_end"]),
                poff_wait=torch.where(do_off, wait, c["poff_wait"]))

        def commit(c, t):
            """Step 2b of the timed regime: each due table entry replays its
            recorded ``move_slot`` against the live layout, in table order
            from the layout the invocation's what-if started from, so the
            landing slots coincide.  Commits ignore endpoint power states
            (a VM may land on a host that failed mid-copy, as the object
            plane's ``move_vm`` lets it).  No read: an entry not due moves
            nothing."""
            slots, cols = c["slots"], []
            nmig = torch.zeros(S, dtype=i32, device=dev)
            for k in range(M):
                src = c["mig_src"][:, k]
                due = (src >= 0) & (c["mig_end"][:, k] <= t)
                slots, _ = kernels.move_slot(slots, due, src,
                                             c["mig_j"][:, k],
                                             c["mig_dst"][:, k], pads)
                cols.append(torch.where(due, -1, src))
                nmig = nmig + due.to(i32)
            return dict(c, slots=slots, mig_src=torch.stack(cols, -1),
                        finite=torch.isfinite(slots["period"]),
                        vmotions=c["vmotions"] + nmig)

        def vmotion_overhead(c):
            """The in-flight table's endpoint CPU a host: each entry charges
            its destination and its VM's current host -- for a chained
            move, the earliest uncommitted leg's source (commits drain
            FIFO, so a bounded walk over predecessors finds it)."""
            act_m = c["mig_src"] >= 0
            eff_src, prev = c["mig_src"], c["mig_prev"]
            for _ in range(M):
                pc = torch.clamp(prev, 0, M - 1)
                live = (prev >= 0) & torch.gather(act_m, 1, pc)
                eff_src = torch.where(live, torch.gather(c["mig_src"], 1, pc),
                                      eff_src)
                prev = torch.where(live, torch.gather(c["mig_prev"], 1, pc),
                                   -1)
            ep = ((eff_src[..., None] == h_idx)
                  | (c["mig_dst"][..., None] == h_idx))
            return mig.vmotion_overhead_mhz * (act_m[..., None] & ep).sum(
                1).to(f64)

        def scripted_events(c, t, due_host):
            """Events due at ``t`` (decided on the host from the packed
            times): a returning host boots with at most the unallocated
            budget as its cap, and within its tree slack, a pending
            power-on's grant counted as allocated."""
            on, last_cfg, caps = c["on"], c["last_cfg"], c["caps"]
            pending = c["pon_idx"] >= 0
            pon_c = torch.clamp(c["pon_idx"], 0, H - 1)
            pend_grant = torch.where(
                pending, torch.gather(caps, -1, pon_c[:, None])[:, 0], 0.0)
            for e in np.nonzero(due_host.any(0))[0]:
                due = torch.as_tensor(due_host[:, e], device=dev)
                eh, target = a["ev_host"][:, e], a["ev_on"][:, e]
                cur = torch.gather(on, -1, eh[:, None])[:, 0]
                onehot = h_idx == eh[:, None]
                boot = (due & target & ~cur)[:, None] & onehot
                pool = torch.clamp_min(
                    budget - (caps * on).sum(-1) - pend_grant, 0.0)
                caps = torch.where(boot, torch.minimum(caps, pool[:, None]),
                                   caps)
                if tcols is not None:
                    pend_on = pending[:, None] & (h_idx == pon_c[:, None])
                    head = kernels.tree_headroom(tcols, on | pend_on, caps)
                    room = torch.where(kernels.tree_anc_at(tcols, eh), head,
                                       torch.inf).amin(-1)
                    caps = torch.where(
                        boot, torch.minimum(
                            caps, torch.clamp_min(room, 0.0)[:, None]),
                        caps)
                on = torch.where((due & target)[:, None] & onehot, True, on)
                on = torch.where((due & ~target)[:, None] & onehot, False,
                                 on)
                last_cfg = torch.where(due & (cur != target), t, last_cfg)
            return dict(c, on=on, caps=caps, last_cfg=last_cfg)

        def zeros(dtype=f64, shape=(S,)):
            return torch.zeros(shape, dtype=dtype, device=dev)

        c = {
            "caps": a["caps0"], "on": a["on"],
            "slots": {k: a[k] for k in slot_keys},
            "finite": torch.isfinite(a["period"]),
            "low_since": torch.full((S, H), torch.nan, dtype=f64,
                                    device=dev),
            "last_cfg": torch.full((S,), -1e18, dtype=f64, device=dev),
            "next_drs": torch.full((S,), sched.drs_first_at_s, dtype=f64,
                                   device=dev),
            "pon_idx": torch.full((S,), -1, dtype=i64, device=dev),
            "pon_end": zeros(),
            "poff_idx": torch.full((S,), -1, dtype=i64, device=dev),
            "poff_end": zeros(),
            "pend_caps": a["caps0"], "pend_cnt": zeros(i32),
            "pend_mask": zeros(torch.bool, (S, H)),
            "acc": {k: zeros() for k in FIELDS},
            "win": {k: zeros() for k in FIELDS},
            "tag_pay": zeros(shape=(S, G)), "tag_dem": zeros(shape=(S, G)),
            "n_changes": zeros(i32), "vmotions": zeros(i32),
            "power_ons": zeros(i32), "power_offs": zeros(i32),
            "over_budget": torch.full((S,), -torch.inf, dtype=f64,
                                      device=dev),
            "over_tree": torch.full((S,), -torch.inf, dtype=f64, device=dev),
            "slot_pressure": zeros(torch.bool),
        }
        if timed:
            c.update({k: torch.full((S, M), v, device=dev,
                                    dtype=f64 if k == "mig_end" else i64)
                      for k, v in dict(_TABLE_PAD, mig_src=-1).items()})
            c["poff_wait"] = zeros(torch.bool)
        counters = ("n_changes", "vmotions", "power_ons", "power_offs")
        ev_done = np.zeros(ev_t.shape, dtype=bool)
        series = []
        invoked = 0
        ts = self._arrays["ts"]
        for i in range(ts.shape[0]):
            t = float(ts[i])
            start = {k: c[k] for k in counters}
            # 1. Scripted host lifecycle events.
            due_host = ~ev_done & (ev_t <= t)
            if due_host.any():
                ev_done |= due_host
                c = scripted_events(c, t, due_host)

            # 2. Pending power-on and power-off timers come due; a
            # power-off applies its deferred caps only on the hosts its
            # actions set (a host a scripted event booted meanwhile keeps
            # its boot cap).  A timed power-off waiting on its evacuation
            # holds a stale end: its timer starts when the table drains.
            on, caps = c["on"], c["caps"]
            pon_fire = (c["pon_idx"] >= 0) & (t >= c["pon_end"])
            on = on | (pon_fire[:, None] & (h_idx == c["pon_idx"][:, None]))
            poff_fire = (c["poff_idx"] >= 0) & (t >= c["poff_end"])
            if timed:
                poff_fire = poff_fire & ~c["poff_wait"]
            on = on & ~(poff_fire[:, None]
                        & (h_idx == c["poff_idx"][:, None]))
            caps = torch.where(poff_fire[:, None] & c["pend_mask"],
                               c["pend_caps"], caps)
            c = dict(
                c, on=on, caps=caps,
                last_cfg=torch.where(pon_fire | poff_fire, t, c["last_cfg"]),
                n_changes=c["n_changes"]
                + torch.where(poff_fire, c["pend_cnt"], 0),
                power_ons=c["power_ons"] + pon_fire.to(i32),
                power_offs=c["power_offs"] + poff_fire.to(i32),
                pon_idx=torch.where(pon_fire, -1, c["pon_idx"]),
                poff_idx=torch.where(poff_fire, -1, c["poff_idx"]))

            # 2b. In-flight migrations commit FIFO (timed regime); a
            # power-off whose evacuations have all committed starts its
            # latency timer now.
            outstanding = (c["pon_idx"] >= 0) | (c["poff_idx"] >= 0)
            if timed:
                c = commit(c, t)
                drained = ~(c["mig_src"] >= 0).any(-1)
                start_off = c["poff_wait"] & drained
                c = dict(c, poff_wait=c["poff_wait"] & ~start_off,
                         poff_end=torch.where(
                             start_off, t + sched.power_off_latency_s,
                             c["poff_end"]))
                outstanding = outstanding | ~drained

            # 3. The manager on the carried DRS schedule, deferred per cell
            # while its actions are in flight; one read a tick takes the
            # branch.
            due_drs = t >= c["next_drs"]
            can = due_drs & ~outstanding
            c["next_drs"] = torch.where(
                can, t + sched.drs_period_s,
                torch.where(due_drs, t + dt, c["next_drs"]))
            reads["branch"] += 1
            if bool(can.any()):
                invoked += 1
                c = invocation(c, can, t)

            # 4. Delivery and accounting at the post-invocation state.
            slots = c["slots"]
            cpu, mem = self._demands(slots, c["finite"], t)
            on, caps = c["on"], c["caps"]
            hosts = hosts_of(on)
            active = slots["occ"] & on[..., None]
            tick, tp, td, mem_dem_h = self._deliver(
                a, hosts, caps, active, slots, cpu, mem,
                torch.where(on, host_mem_spec, 0.0),
                vmotion_overhead(c) if timed else None)
            # Budget invariant: powered-on caps plus the grant of a host
            # whose power-on is pending.
            pending = c["pon_idx"] >= 0
            pon_c = torch.clamp(c["pon_idx"], 0, H - 1)
            total = (caps * on).sum(-1) + torch.where(
                pending, torch.gather(caps, -1, pon_c[:, None])[:, 0], 0.0)
            if tcols is not None:
                mask = on | (pending[:, None] & (h_idx == pon_c[:, None]))
                c["over_tree"] = torch.maximum(c["over_tree"], (
                    kernels.tree_node_sums(tcols, mask, caps)
                    - tcols.limit).amax(-1))

            # 5. DPM's low-band tracking at the delivered state.
            eff_h = torch.where(active, kernels.clip(
                cpu, slots["reservation"], slots["limit"]), 0.0).sum(-1)
            cpu_util, mem_util = kernels.host_utilizations(
                hosts, caps, eff_h, mem_dem_h, host_mem_spec)
            low = (on & (cpu_util < dpmp.low_util)
                   & (mem_util < dpmp.low_util))
            low_since = torch.where(low & torch.isnan(c["low_since"]), t,
                                    c["low_since"])
            in_win = a["win_mask"][i]
            c = dict(
                c, low_since=torch.where(on & ~low, torch.nan, low_since),
                acc={k: c["acc"][k] + tick[k] * dt for k in FIELDS},
                win={k: c["win"][k] + torch.where(in_win, tick[k], 0.0) * dt
                     for k in FIELDS},
                tag_pay=c["tag_pay"] + tp * dt,
                tag_dem=c["tag_dem"] + td * dt,
                over_budget=torch.maximum(c["over_budget"], total - budget))
            if self._keep_timeseries:
                series.append(dict(
                    tick, **{("cap_changes" if k == "n_changes" else k):
                             c[k] - start[k] for k in counters}))
        self.info = dict(ticks=int(ts.shape[0]), invocation_ticks=invoked,
                         branch_reads=reads["branch"] + reads["migration"],
                         migration_reads=reads["migration"])
        out = {"acc": c["acc"], "win": c["win"],
               "tag_payload": c["tag_pay"], "tag_demand": c["tag_dem"],
               "cap_changes": c["n_changes"], "vmotions": c["vmotions"],
               "power_ons": c["power_ons"], "power_offs": c["power_offs"],
               "over_budget": c["over_budget"], "final_caps": c["caps"],
               "final_on": c["on"], "final_occ": c["slots"]["occ"],
               "slot_pressure": c["slot_pressure"]}
        if tcols is not None:
            out["over_tree"] = c["over_tree"]
        if self._keep_timeseries:
            out["timeseries"] = {k: torch.stack([s[k] for s in series])
                                 for k in series[0]}
        return out

    def _harvest(self, out: dict, t0: float,
                 compile_s: float = 0.0) -> BatchResult:
        """Copy the outputs to the host (the wait on the card), check the
        invariants, and assemble the result."""
        host = None if out is None else {
            k: ({kk: vv.cpu().numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.cpu().numpy())
            for k, v in out.items()}
        if self.n_devices > 1:
            t1 = time.perf_counter()
            host = self._gather(host)
            self.info["gather_s"] = time.perf_counter() - t1
        run_s = time.perf_counter() - t0
        if bool(host["slot_pressure"].any()):
            bad = [self.names[i] for i in np.nonzero(host["slot_pressure"])[0]]
            raise RuntimeError(
                f"slot capacity bound a migration/evacuation decision in "
                f"cells "
                f"{bad[:5]}: repack with a larger slot_slack")
        over = host["over_budget"]
        if float(over.max()) > 1e-6:
            raise RuntimeError(
                f"budget violated during execution: worst overshoot "
                f"{float(over.max()):.3f} W (cell "
                f"{self.names[int(over.argmax())]})")
        over_tree = host.get("over_tree")
        if over_tree is not None and float(over_tree.max()) > 1e-6:
            raise RuntimeError(
                f"budget tree violated during execution: worst node over by "
                f"{float(over_tree.max()):.3f} W (cell "
                f"{self.names[int(over_tree.argmax())]})")
        acc = host["acc"]
        return BatchResult(
            names=list(self.names),
            cpu_payload_mhz_s=acc["cpu_payload_mhz_s"],
            cpu_demand_mhz_s=acc["cpu_demand_mhz_s"],
            mem_payload_mb_s=acc["mem_payload_mb_s"],
            mem_demand_mb_s=acc["mem_demand_mb_s"],
            energy_j=acc["energy_j"],
            cap_changes=host["cap_changes"],
            vmotions=host["vmotions"], power_ons=host["power_ons"],
            power_offs=host["power_offs"],
            tag_names=list(self._tag_names),
            tag_payload=host["tag_payload"],
            tag_demand=host["tag_demand"],
            window_fields=host["win"],
            has_window=self._has_window,
            final_caps=host["final_caps"],
            final_on=host["final_on"],
            final_occ=host["final_occ"],
            ticks=int(self._arrays["ts"].shape[0]),
            device=str(self.device),
            pack_s=self.pack_s,
            run_s=run_s,
            compile_s=compile_s,
            wall_s=compile_s + run_s,
            n_devices=self.n_devices,
            timeseries=host.get("timeseries"),
            tick_s=self._tick_s,
            over_budget=over,
            over_tree=over_tree)


    def _gather(self, host: dict) -> dict:
        """Every rank's shard of the outputs, in rank (grid) order, the
        padding's copies dropped: the per-cell arrays split on their
        leading cells axis, the timeseries (``(T, S)``) on axis 1."""
        n, S = self.n_devices, len(self.names)
        parts = sharding.all_gather_objects(host)[:n]

        def join(key, vals):
            if isinstance(vals[0], dict):
                return {kk: join(key, [v[kk] for v in vals])
                        for kk in vals[0]}
            if key == "timeseries":
                return np.concatenate(vals, axis=1)[:, :S]
            return np.concatenate(vals, axis=0)[:S]
        return {k: join(k, [p[k] for p in parts]) for k in parts[0]}


@dataclasses.dataclass
class PendingBatch:
    """A batch whose program has run or been enqueued but whose outputs
    are still on its device: :meth:`BatchedSimulator.run_async`'s handle.
    :meth:`result` copies them to the host and builds the
    :class:`BatchResult`; the sweep pipeline holds one a bucket and
    harvests them all at the end."""

    sim: BatchedSimulator
    out: dict
    dispatch_t0: float
    compile_s: float

    def result(self) -> BatchResult:
        return self.sim._harvest(self.out, self.dispatch_t0, self.compile_s)
