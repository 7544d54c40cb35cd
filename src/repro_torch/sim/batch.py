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
* **churn** (some cell has ``dpm_enabled`` or ``config.power_events``):
  the power states, the slot layout and the DRS schedule are carried state.
  Scripted events flip hosts on schedule; pending power-on and power-off
  timers fire; an invocation runs RedivvyPowerCap, BalancePowerCap, then
  DPM's triggers with Powercap Redistribution: a funded power-on, or an
  evacuation (atomic slot remaps, ``move_slot``) and a power-off whose
  reabsorbed caps apply when its timer fires.  Whether any cell may invoke
  depends on device state (power actions in flight), so the loop reads one
  flag a tick (``any(can)``); no loop runs over cells on the host.

A budget tree (``snapshot.budget_tree``) adds ancestor incidence, limit and
depth columns; the caps are projected under every node limit after the
redivvy and the balance, funding, reabsorption and evacuation are scoped
by it, and an ``over_tree`` invariant is checked at the harvest.

Placement rules (and with them the migration layer and timed vMotions)
raise :class:`BatchUnsupported`: ROADMAP queue 1, item 6.  The reference is
``repro.sim.batch``; results agree with it to float tolerance with exact
counts of cap changes, power-ons, power-offs and vMotions.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels
from repro_torch.drs.arrays import dense_slot_assignment
from repro_torch.drs.entitlement import waterfill_dense
from repro_torch.drs.snapshot import ClusterSnapshot
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.metrics import Accumulators, fold_timeseries
from repro_torch.sim.workloads import DemandTrace, TraceBank

FIELDS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")

#: The packed arrays: each is bitwise the reference pack's array of the
#: same key (``repro.sim.batch``).  The last seven serve the churn regime.
PACK_KEYS = ("on", "idle", "peak", "cap_peak", "hyp", "host_mem", "caps0",
             "cpu_res", "budget", "enabled", "occ", "reservation", "limit",
             "weights", "tag_masks", "bps", "cpu_vals", "mem_vals", "period",
             "ts", "drs_mask", "win_mask", "exists", "dpm", "vm",
             "migratable", "ev_t", "ev_host", "ev_on")

#: Packed only when a cell has a budget tree that binds.
TREE_KEYS = ("tree_anc", "tree_limit", "tree_depth")

#: Kept on the host: the loop reads them to take its branches.
_HOST_KEYS = ("ts", "drs_mask", "ev_t")

#: Read by the churn regime only.
_CHURN_KEYS = ("exists", "dpm", "vm", "migratable", "ev_host", "ev_on")

#: The per-slot columns the churn regime carries, moving with their VM.
SLOT_KEYS = ("occ", "reservation", "limit", "weights", "migratable",
             "period", "bps", "cpu_vals", "mem_vals", "tag_masks", "vm")

#: Pads restored behind a moved VM (``bps`` takes its padded breakpoint
#: row, built per program).
_SLOT_PAD = dict(kernels.SLOT_PAD, period=float("inf"), cpu_vals=0.0,
                 mem_vals=0.0, tag_masks=False, vm=-1)


class Schedule(NamedTuple):
    """The time grid's DRS schedule and power latencies, shared by a
    batch's cells."""

    drs_period_s: float = 300.0
    drs_first_at_s: float = 300.0
    power_on_latency_s: float = 120.0
    power_off_latency_s: float = 30.0


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


def _cell_reason(c: BatchCell, ref: SimConfig, churn: bool
                 ) -> Optional[str]:
    """Why this cell cannot join a batch anchored on ``ref`` (``churn``:
    the batch runs the churn regime)."""
    same = (c.config.duration_s == ref.duration_s
            and c.config.tick_s == ref.tick_s
            and c.config.drs_period_s == ref.drs_period_s
            and c.config.drs_first_at_s == ref.drs_first_at_s)
    if not same:
        return "disagrees on the shared time grid"
    if c.snapshot.rules:
        return ("placement rules need the migration layer, which is not "
                "ported yet (ROADMAP queue 1, item 6)")
    if c.dpm_enabled and not c.config.instant_migrations:
        if c.config.migration_gated:
            return ("timed migrations need the migration layer's in-flight "
                    "table, which is not ported yet (ROADMAP queue 1, "
                    "item 6)")
        return ("timed migrations in the batched engine need launch gating "
                "(and the migration layer, ROADMAP queue 1, item 6); "
                "ungated timed cells run on the vector engine")
    if churn and (c.config.power_on_latency_s != ref.power_on_latency_s
                  or c.config.power_off_latency_s
                  != ref.power_off_latency_s):
        return ("disagrees on power latencies (shared across a "
                "capacity-churn batch)")
    for t, host_id, _ in c.config.power_events:
        if host_id not in c.snapshot.hosts:
            return f"power event at t={t} targets unknown host {host_id!r}"
    return None


def _pack(cells: Sequence[BatchCell], slot_slack: float = 2.0,
          churn: bool = False) -> tuple[dict, list]:
    """The pack: NumPy arrays keyed as :data:`PACK_KEYS` (and
    :data:`TREE_KEYS` when a cell's tree binds), each bitwise the reference
    packer's (``repro.sim.batch``), and the sorted tag names.  A churn
    batch with a DPM cell widens the slot axis by ``slot_slack`` for the
    evacuations to land in."""
    S = len(cells)
    H = max(len(c.snapshot.hosts) for c in cells)
    ts, drs_mask = _drs_schedule(cells[0].config)
    T = ts.shape[0]

    # Pass 1: the dense slot assignment and each cell's trace bank.
    prepped = []
    n_bps = 1
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
        prepped.append((vms, bank, order, hj, slot, counts))
    J = max(max((int(p[5].max()) for p in prepped if p[5].size),
                default=1), 1)
    if churn and any(c.dpm_enabled for c in cells):
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

    for i, c in enumerate(cells):
        snap = c.snapshot
        vms, bank, order, hj, slot, counts = prepped[i]
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
        for e, (ev_t, host_id, on) in enumerate(
                sorted(c.config.power_events)):
            a["ev_t"][i, e] = ev_t
            a["ev_host"][i, e] = host_idx[host_id]
            a["ev_on"][i, e] = bool(on)
        if c.window is not None:
            w0, w1 = c.window
            a["win_mask"][:, i] = (w0 <= ts) & (ts < w1)
    return a, tag_names


class BatchedSimulator:
    """Simulate S scenario cells at once.

    Cells must share the time grid (``duration_s``/``tick_s``) and DRS
    schedule, and in the churn regime the power latencies; host counts,
    VM counts, traces, budgets, trees, policies, windows, DPM flags and
    scripted power events vary per cell (smaller cells are padded).
    ``waterfill_iters``: the bisection trips of every waterfill (100 reaches
    the float64 fixed point for realistic magnitudes).  ``slot_slack``
    widens the slot axis of a batch with DPM cells so that evacuations have
    somewhere to land; a run whose consolidation would need more raises
    after the run, naming it, rather than diverge.  ``device=None`` runs on
    the GPU; pass ``device="cpu"`` for the plain PyTorch versions of the
    kernels.  After :meth:`run`, :attr:`info` holds the tick loop's
    counts: ticks, ticks with an invocation, and device-to-host reads.
    """

    def __init__(self, cells: Sequence[BatchCell],
                 balance: Optional[kernels.BalanceParams] = None,
                 dpm: Optional[kernels.DPMParams] = None,
                 waterfill_iters: int = 100,
                 slot_slack: float = 2.0,
                 keep_timeseries: bool = False,
                 device=None):
        if not cells:
            raise ValueError("no cells")
        cells = list(cells)
        dev = resolve_device(device)
        churn = any(c.dpm_enabled or c.config.power_events for c in cells)
        for c in cells:
            reason = _cell_reason(c, cells[0].config, churn)
            if reason is not None:
                raise BatchUnsupported(f"cell {c.name!r}: {reason}")
        t0 = time.perf_counter()
        arrays, tag_names = _pack(cells, slot_slack, churn)
        cfg = cells[0].config
        self._setup(arrays, [c.name for c in cells], tag_names,
                    np.array([c.window is not None for c in cells]),
                    cfg.tick_s, balance or kernels.BalanceParams(),
                    waterfill_iters, keep_timeseries, dev, churn,
                    dpm or kernels.DPMParams(),
                    Schedule(cfg.drs_period_s, cfg.drs_first_at_s,
                             cfg.power_on_latency_s,
                             cfg.power_off_latency_s))
        self.pack_s = time.perf_counter() - t0

    @classmethod
    def from_pack(cls, arrays: dict, names: list, tag_names: list,
                  has_window, tick_s: float,
                  balance: kernels.BalanceParams, waterfill_iters: int,
                  keep_timeseries: bool, device=None, churn: bool = False,
                  dpm: Optional[kernels.DPMParams] = None,
                  schedule: Optional[Schedule] = None
                  ) -> "BatchedSimulator":
        """A simulator over arrays already packed (keys :data:`PACK_KEYS`
        and, when present, :data:`TREE_KEYS`; extra keys are ignored)."""
        keys = PACK_KEYS + tuple(k for k in TREE_KEYS if k in arrays)
        sim = cls.__new__(cls)
        sim._setup({k: arrays[k] for k in keys}, list(names),
                   list(tag_names), np.asarray(has_window, dtype=bool),
                   tick_s, balance, waterfill_iters, keep_timeseries,
                   resolve_device(device), churn,
                   dpm or kernels.DPMParams(), schedule or Schedule())
        sim.pack_s = 0.0
        return sim

    def _setup(self, arrays, names, tag_names, has_window, tick_s, balance,
               waterfill_iters, keep_timeseries, device, churn, dpm,
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
        self._churn = bool(churn)
        self._dpm = dpm
        self._schedule = schedule
        self.info: dict = {}

    # ------------------------------------------------------------- running
    def run(self) -> BatchResult:
        t0 = time.perf_counter()
        skip = _HOST_KEYS + (() if self._churn else _CHURN_KEYS)
        a = {k: torch.as_tensor(v, device=self.device)
             for k, v in self._arrays.items() if k not in skip}
        program = self._program_churn if self._churn else self._program
        out = program(a)
        return self._harvest(out, t0)

    def _tree(self, a: dict) -> Optional[kernels.TreeCols]:
        if "tree_anc" not in a:
            return None
        return kernels.TreeCols(a["tree_anc"], a["tree_limit"],
                                a["tree_depth"])

    def _deliver(self, a: dict, hosts, caps, active, slots: dict, cpu, mem,
                 host_mem):
        """One tick's delivery and accounting at the given state: the
        waterfill (K1 on the GPU), Eq. 1 power and the tick's rates."""
        on, limit = hosts.on, slots["limit"]
        managed = kernels.managed_capacity(hosts, caps)
        dem = torch.where(active, torch.minimum(cpu, limit), 0.0)
        floors = torch.where(active,
                             torch.minimum(slots["reservation"], dem), 0.0)
        alloc = waterfill_dense(managed, floors, dem, slots["weights"],
                                self._iters, active=active)
        mem_dem_h = torch.where(active, mem, 0.0).sum(-1)
        # Eq. 1 power, utilization measured against peak capacity.
        power = kernels.power_consumed(hosts,
                                       alloc.sum(-1) / a["cap_peak"])
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
                a["cpu_res"], a["budget"], enabled, self._balance)
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
    def _program_churn(self, a: dict) -> dict:
        """The capacity-churn tick loop (the reference's ``build_churn``
        without its migration and timed branches): power states, the slot
        layout and the DRS schedule are carried per cell."""
        dev, f64, i32, i64 = (self.device, torch.float64, torch.int32,
                              torch.int64)
        S, H = a["on"].shape
        J = a["occ"].shape[-1]
        G = len(self._tag_names)
        dt, iters, dpmp, sched = (self._tick_s, self._iters, self._dpm,
                                  self._schedule)
        h_idx = torch.arange(H, device=dev)
        exists, enabled, budget = a["exists"], a["enabled"], a["budget"]
        host_mem_spec = a["host_mem"]
        tcols = self._tree(a)
        pads = dict(_SLOT_PAD, bps=torch.where(
            torch.arange(a["bps"].shape[-1], device=dev) == 0, 0.0,
            torch.inf).to(f64))
        ev_t, ev_done = self._arrays["ev_t"], None

        def hosts_of(on):
            return kernels.HostCols(on, a["idle"], a["peak"], a["cap_peak"],
                                    a["hyp"])

        def host_sum_vm_order(vals, act, vm):
            # Per-host sums added left to right in VM-index order, as the
            # object plane's ``bincount`` adds them: slot order stops
            # agreeing once an evacuee lands in a free slot, and on the
            # near-ties BalancePowerCap makes, one ULP flips DPM's victim
            # (trap T1).  Empty slots sort last and add +0.0.
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

        def invocation(c, can, t):
            cpu, mem = self._demands(c["slots"], c["finite"], t)
            on, caps = c["on"], c["caps"]
            hosts = hosts_of(on)
            work = dict(c["slots"], cpu=cpu, mem=mem)
            act3 = work["occ"] & on[..., None]
            res, lim = work["reservation"], work["limit"]
            cpu_res = torch.where(act3, res, 0.0).sum(-1)

            # Phase 1: reserved-floor redivvy (Powercap Allocation).
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
            vm_ceils = torch.where(act3, kernels.clip(cpu, res, lim), 0.0)
            caps2, _ = kernels.balance_caps(
                hosts, caps1,
                kernels.DenseCols(vm_floors, vm_ceils, work["weights"], act3,
                                  iters),
                cpu_res, budget, apply_cpc, self._balance)
            if tcols is not None:
                caps2 = torch.where(
                    apply_cpc[:, None],
                    kernels.tree_project_caps(tcols, on, caps2, floor_caps),
                    caps2)
            changes = changes + torch.where(
                can, kernels.count_cap_changes(on, caps1, caps2), 0)

            # Phase 3: DPM's triggers and Powercap Redistribution.
            occ = work["occ"]
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
                scope=scope)
            do_off = maybe_off & ok
            work = apply_remap(work, do_off, victim, order, dests)
            reabsorbed = kernels.power_off_reabsorb_caps(
                hosts, caps2, victim, budget, tree=tcols)
            # The deferred actions touch exactly the hosts whose change
            # clears the emission threshold.
            changed = on & ((reabsorbed - caps2).abs()
                            > kernels.CAP_CHANGE_EPS)
            off_cpc = do_off & enabled
            pend_cnt = torch.where(off_cpc, changed.sum(-1), 0).to(i32)
            return dict(
                c, caps=caps3, slots={k: work[k] for k in SLOT_KEYS},
                finite=torch.isfinite(work["period"]),
                pon_idx=torch.where(do_on, cand, c["pon_idx"]),
                pon_end=torch.where(do_on, t + sched.power_on_latency_s,
                                    c["pon_end"]),
                poff_idx=torch.where(do_off, victim, c["poff_idx"]),
                poff_end=torch.where(do_off, t + sched.power_off_latency_s,
                                     c["poff_end"]),
                pend_caps=torch.where(
                    do_off[:, None],
                    torch.where(off_cpc[:, None], reabsorbed, caps3),
                    c["pend_caps"]),
                pend_mask=torch.where(do_off[:, None],
                                      off_cpc[:, None] & changed,
                                      c["pend_mask"]),
                pend_cnt=torch.where(do_off, pend_cnt, c["pend_cnt"]),
                n_changes=c["n_changes"] + changes.to(i32),
                vmotions=c["vmotions"]
                + torch.where(do_off, n_evac, 0).to(i32),
                slot_pressure=c["slot_pressure"] | (maybe_off & pressure))

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
            "slots": {k: a[k] for k in SLOT_KEYS},
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
        counters = ("n_changes", "vmotions", "power_ons", "power_offs")
        ev_done = np.zeros(ev_t.shape, dtype=bool)
        series = []
        reads = invoked = 0
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
            # its boot cap).
            on, caps = c["on"], c["caps"]
            pon_fire = (c["pon_idx"] >= 0) & (t >= c["pon_end"])
            on = on | (pon_fire[:, None] & (h_idx == c["pon_idx"][:, None]))
            poff_fire = (c["poff_idx"] >= 0) & (t >= c["poff_end"])
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

            # 3. The manager on the carried DRS schedule, deferred per cell
            # while its power actions are in flight; one read a tick takes
            # the branch.
            outstanding = (c["pon_idx"] >= 0) | (c["poff_idx"] >= 0)
            due_drs = t >= c["next_drs"]
            can = due_drs & ~outstanding
            c["next_drs"] = torch.where(
                can, t + sched.drs_period_s,
                torch.where(due_drs, t + dt, c["next_drs"]))
            reads += 1
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
                torch.where(on, host_mem_spec, 0.0))
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
                         branch_reads=reads)
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

    def _harvest(self, out: dict, t0: float) -> BatchResult:
        """Copy the outputs to the host, check the invariants, and
        assemble the result."""
        host = {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.cpu().numpy())
                for k, v in out.items()}
        run_s = time.perf_counter() - t0
        if bool(host["slot_pressure"].any()):
            bad = [self.names[i] for i in np.nonzero(host["slot_pressure"])[0]]
            raise RuntimeError(
                f"slot capacity bound an evacuation decision in cells "
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
            timeseries=host.get("timeseries"),
            tick_s=self._tick_s,
            over_budget=over,
            over_tree=over_tree)
