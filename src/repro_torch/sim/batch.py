"""Batched multi-cluster engine, cap-only regime: a whole grid at once.

``BatchedSimulator`` packs S scenario cells x H hosts x J VM slots per host
into padded ``float64`` tensors and runs the paper's control loop for every
cell at once: each tick looks up demand from the packed step-function
traces, delivers CPU with the dense-slot waterfill (kernel K1 on the GPU),
applies the Eq. 1 power model and adds the tick into the accumulators;
every DRS period the manager runs RedivvyPowerCap and then the
BalancePowerCap loop (kernel K2 on the GPU, one launch per invocation).

The cap-only regime freezes placements and host power states, so the pack
(host-side NumPy, as in the reference) is the whole scenario, and the tick
loop is a Python loop over the shared time grid.  The DRS schedule is a
host array, so the loop takes its branches without waiting on the device;
the harvest at the end is the only synchronisation.

Cells asking for more than the cap-only regime -- DPM, scripted power
events, placement rules (and with them the migration layer) -- raise
:class:`BatchUnsupported`; those regimes are later slices of the port.
The reference is ``repro.sim.batch``; results agree with it to float
tolerance with exact cap-change counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

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

#: The packed arrays the cap-only program reads: each is bitwise the
#: reference pack's array of the same key (``repro.sim.batch``).
PACK_KEYS = ("on", "idle", "peak", "cap_peak", "hyp", "host_mem", "caps0",
             "cpu_res", "budget", "enabled", "occ", "reservation", "limit",
             "weights", "tag_masks", "bps", "cpu_vals", "mem_vals", "period",
             "ts", "drs_mask", "win_mask")

#: Kept on the host: the loop reads them to take its branches.
_HOST_KEYS = ("ts", "drs_mask")


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
    vmotions: np.ndarray                     # always 0 in the cap-only regime
    power_ons: np.ndarray
    power_offs: np.ndarray
    tag_names: list
    tag_payload: np.ndarray                  # (S, G)
    tag_demand: np.ndarray                   # (S, G)
    window_fields: dict                      # field -> (S,) array
    has_window: np.ndarray                   # bool per cell
    final_caps: np.ndarray                   # (S, H)
    final_on: np.ndarray                     # (S, H)
    final_occ: np.ndarray                    # (S, H, J)
    ticks: int
    device: str = ""                         # where the program ran
    pack_s: float = 0.0                      # host-side packing
    run_s: float = 0.0                       # upload, tick loop, harvest
    # ``keep_timeseries=True`` only: field -> (T, S) per-tick rates and
    # per-tick cap-change counts.
    timeseries: Optional[dict] = None
    tick_s: float = 0.0

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


def _cell_reason(c: BatchCell, ref: SimConfig) -> Optional[str]:
    """Why this cell cannot join a cap-only batch anchored on ``ref``."""
    same = (c.config.duration_s == ref.duration_s
            and c.config.tick_s == ref.tick_s
            and c.config.drs_period_s == ref.drs_period_s
            and c.config.drs_first_at_s == ref.drs_first_at_s)
    if not same:
        return "disagrees on the shared time grid"
    if c.dpm_enabled:
        return ("DPM is not ported yet (the dynamic regime is a later "
                "slice: ROADMAP queue 1, item 5)")
    if c.config.power_events:
        return ("scripted power events are not ported yet (the dynamic "
                "regime is a later slice: ROADMAP queue 1, item 5)")
    if c.snapshot.rules:
        return ("placement rules need the migration layer, which is not "
                "ported yet (ROADMAP queue 1, item 6)")
    return None


def _pack(cells: Sequence[BatchCell]) -> tuple[dict, list]:
    """The cap-only pack: NumPy arrays keyed as :data:`PACK_KEYS`, each
    bitwise the reference packer's (``repro.sim.batch``), and the sorted
    tag names."""
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
    tag_names = sorted({t for c in cells
                        for v in c.snapshot.vms.values() for t in v.tags})
    G = len(tag_names)

    def host_col(fill=0.0):
        return np.full((S, H), fill, dtype=np.float64)

    a = {
        "on": np.zeros((S, H), dtype=bool),
        # Padded hosts keep a nonzero idle->peak range so Eq. 3 stays
        # finite; the `on` mask zeroes everything they produce.
        "idle": host_col(1.0), "peak": host_col(2.0),
        "cap_peak": host_col(1.0), "hyp": host_col(0.0),
        "host_mem": host_col(0.0), "caps0": host_col(0.0),
        "cpu_res": host_col(0.0),
        "budget": np.zeros(S), "enabled": np.zeros(S, dtype=bool),
        "occ": np.zeros((S, H, J), dtype=bool),
        "reservation": np.zeros((S, H, J)),
        "limit": np.full((S, H, J), np.inf),
        "weights": np.full((S, H, J), 1e-12),
        "tag_masks": np.zeros((S, H, J, G), dtype=bool),
        "bps": np.full((S, H, J, n_bps), np.inf),
        "cpu_vals": np.zeros((S, H, J, n_bps)),
        "mem_vals": np.zeros((S, H, J, n_bps)),
        "period": np.full((S, H, J), np.inf),
        "ts": ts, "drs_mask": drs_mask,
        "win_mask": np.zeros((T, S), dtype=bool),
    }
    a["bps"][..., 0] = 0.0

    for i, c in enumerate(cells):
        snap = c.snapshot
        vms, bank, order, hj, slot, counts = prepped[i]
        for j, h in enumerate(snap.hosts.values()):
            a["on"][i, j] = h.powered_on
            a["idle"][i, j] = h.spec.power_idle
            a["peak"][i, j] = h.spec.power_peak
            a["cap_peak"][i, j] = h.spec.capacity_peak
            a["hyp"][i, j] = h.spec.hypervisor_overhead
            a["host_mem"][i, j] = h.spec.memory_mb
            a["caps0"][i, j] = h.power_cap
        n = len(vms)
        res = np.array([v.reservation for v in vms])
        a["occ"][i, hj, slot] = True
        a["reservation"][i, hj, slot] = res[order]
        a["limit"][i, hj, slot] = np.array([v.limit for v in vms])[order]
        a["weights"][i, hj, slot] = np.maximum(
            np.array([v.shares for v in vms]), 1e-12)[order]
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
        a["enabled"][i] = c.powercap_enabled
        if c.window is not None:
            w0, w1 = c.window
            a["win_mask"][:, i] = (w0 <= ts) & (ts < w1)
    return a, tag_names


class BatchedSimulator:
    """Simulate S scenario cells at once, in the cap-only regime.

    Cells must share the time grid (``duration_s``/``tick_s``) and DRS
    schedule; host counts, VM counts, traces, budgets, policies and windows
    vary per cell (smaller cells are padded).  ``waterfill_iters``: the
    bisection trips of every waterfill (100 reaches the float64 fixed point
    for realistic magnitudes).  ``device=None`` runs on the GPU; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    """

    def __init__(self, cells: Sequence[BatchCell],
                 balance: Optional[kernels.BalanceParams] = None,
                 waterfill_iters: int = 100,
                 keep_timeseries: bool = False,
                 device=None):
        if not cells:
            raise ValueError("no cells")
        cells = list(cells)
        dev = resolve_device(device)
        for c in cells:
            reason = _cell_reason(c, cells[0].config)
            if reason is not None:
                raise BatchUnsupported(f"cell {c.name!r}: {reason}")
        t0 = time.perf_counter()
        arrays, tag_names = _pack(cells)
        self._setup(arrays, [c.name for c in cells], tag_names,
                    np.array([c.window is not None for c in cells]),
                    cells[0].config.tick_s,
                    balance or kernels.BalanceParams(), waterfill_iters,
                    keep_timeseries, dev)
        self.pack_s = time.perf_counter() - t0

    @classmethod
    def from_pack(cls, arrays: dict, names: list, tag_names: list,
                  has_window, tick_s: float,
                  balance: kernels.BalanceParams, waterfill_iters: int,
                  keep_timeseries: bool, device=None) -> "BatchedSimulator":
        """A simulator over arrays already packed (keys :data:`PACK_KEYS`;
        extra keys are ignored)."""
        sim = cls.__new__(cls)
        sim._setup({k: arrays[k] for k in PACK_KEYS}, list(names),
                   list(tag_names), np.asarray(has_window, dtype=bool),
                   tick_s, balance, waterfill_iters, keep_timeseries,
                   resolve_device(device))
        sim.pack_s = 0.0
        return sim

    def _setup(self, arrays, names, tag_names, has_window, tick_s, balance,
               waterfill_iters, keep_timeseries, device) -> None:
        self._arrays = arrays
        self.names = names
        self._tag_names = tag_names
        self._has_window = has_window
        self._tick_s = float(tick_s)
        self._balance = balance
        self._iters = int(waterfill_iters)
        self._keep_timeseries = bool(keep_timeseries)
        self.device = device

    # ------------------------------------------------------------- running
    def run(self) -> BatchResult:
        t0 = time.perf_counter()
        a = {k: torch.as_tensor(v, device=self.device)
             for k, v in self._arrays.items() if k not in _HOST_KEYS}
        out = self._program(a)
        return self._harvest(out, t0)

    def _program(self, a: dict) -> dict:
        """The tick loop over the shared time grid (the reference's
        ``build_static``)."""
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
        finite_period = torch.isfinite(a["period"])
        tag_masks = a["tag_masks"]

        def demands(t: float):
            phase = torch.where(finite_period,
                                torch.remainder(t, a["period"]), t)
            idx = torch.clamp_min(
                (a["bps"] <= phase[..., None]).sum(-1) - 1, 0)[..., None]
            return (torch.gather(a["cpu_vals"], -1, idx)[..., 0],
                    torch.gather(a["mem_vals"], -1, idx)[..., 0])

        def invoke_manager(caps, cpu):
            """RedivvyPowerCap then BalancePowerCap, counting cap changes
            as the object plane emits them."""
            redivvied = kernels.redivvy_caps(on, caps, floor_caps)
            caps1 = torch.where(enabled[:, None], redivvied, caps)
            changes = kernels.count_cap_changes(on, caps, caps1)
            vm_ceils = torch.where(
                active, kernels.clip(cpu, reservation, limit), 0.0)
            caps2, _ = kernels.balance_caps(
                hosts, caps1,
                kernels.DenseCols(vm_floors, vm_ceils, weights, active,
                                  iters),
                a["cpu_res"], a["budget"], enabled, self._balance)
            return caps2, changes + kernels.count_cap_changes(on, caps1,
                                                              caps2)

        def deliver(caps, cpu, mem):
            managed = kernels.managed_capacity(hosts, caps)
            dem = torch.where(active, torch.minimum(cpu, limit), 0.0)
            floors = torch.where(active, torch.minimum(reservation, dem), 0.0)
            alloc = waterfill_dense(managed, floors, dem, weights, iters,
                                    active=active)
            mem_dem_h = torch.where(active, mem, 0.0).sum(-1)
            # Eq. 1 power, utilization measured against peak capacity.
            power = kernels.power_consumed(
                hosts, alloc.sum(-1) / a["cap_peak"])
            tick = {
                "cpu_payload_mhz_s": alloc.sum((-1, -2)),
                "cpu_demand_mhz_s": dem.sum((-1, -2)),
                "mem_payload_mb_s": torch.minimum(mem_dem_h,
                                                  host_mem).sum(-1),
                "mem_demand_mb_s": mem_dem_h.sum(-1),
                "energy_j": (power * on).sum(-1),
            }
            tag_pay = (tag_masks * alloc[..., None]).sum((-3, -2))
            tag_dem = (tag_masks * dem[..., None]).sum((-3, -2))
            return tick, tag_pay, tag_dem

        caps = a["caps0"]
        acc = {k: torch.zeros(S, dtype=f64, device=dev) for k in FIELDS}
        win = dict(acc)
        tag_pay = torch.zeros((S, G), dtype=f64, device=dev)
        tag_dem = torch.zeros((S, G), dtype=f64, device=dev)
        no_changes = torch.zeros(S, dtype=i32, device=dev)
        n_changes = no_changes
        max_total = (caps * on).sum(-1)
        series = []
        ts, drs_mask = self._arrays["ts"], self._arrays["drs_mask"]
        for i in range(ts.shape[0]):
            cpu, mem = demands(float(ts[i]))
            changes = no_changes
            if drs_mask[i]:
                caps, changes = invoke_manager(caps, cpu)
            tick, tp, td = deliver(caps, cpu, mem)
            in_win = a["win_mask"][i]
            acc = {k: acc[k] + tick[k] * dt for k in acc}
            win = {k: win[k] + torch.where(in_win, tick[k], 0.0) * dt
                   for k in win}
            tag_pay = tag_pay + tp * dt
            tag_dem = tag_dem + td * dt
            n_changes = n_changes + changes
            max_total = torch.maximum(max_total, (caps * on).sum(-1))
            if self._keep_timeseries:
                series.append(dict(tick, cap_changes=changes))
        out = {"acc": acc, "win": win, "tag_payload": tag_pay,
               "tag_demand": tag_dem, "cap_changes": n_changes,
               "max_total_cap": max_total, "final_caps": caps}
        if self._keep_timeseries:
            out["timeseries"] = {k: torch.stack([s[k] for s in series])
                                 for k in series[0]}
        return out

    def _harvest(self, out: dict, t0: float) -> BatchResult:
        """Copy the outputs to the host (the run's one synchronisation),
        check the budget invariant, and assemble the result."""
        host = {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.cpu().numpy())
                for k, v in out.items()}
        run_s = time.perf_counter() - t0
        over = host["max_total_cap"] - self._arrays["budget"]
        if float(over.max()) > 1e-6:
            raise RuntimeError(
                f"budget violated during execution: worst overshoot "
                f"{float(over.max()):.3f} W (cell "
                f"{self.names[int(over.argmax())]})")
        acc = host["acc"]
        zi = np.zeros(len(self.names), dtype=np.int32)
        return BatchResult(
            names=list(self.names),
            cpu_payload_mhz_s=acc["cpu_payload_mhz_s"],
            cpu_demand_mhz_s=acc["cpu_demand_mhz_s"],
            mem_payload_mb_s=acc["mem_payload_mb_s"],
            mem_demand_mb_s=acc["mem_demand_mb_s"],
            energy_j=acc["energy_j"],
            cap_changes=host["cap_changes"],
            vmotions=zi, power_ons=zi, power_offs=zi,
            tag_names=list(self._tag_names),
            tag_payload=host["tag_payload"],
            tag_demand=host["tag_demand"],
            window_fields=host["win"],
            has_window=self._has_window,
            final_caps=host["final_caps"],
            final_on=self._arrays["on"],
            final_occ=self._arrays["occ"],
            ticks=int(self._arrays["ts"].shape[0]),
            device=str(self.device),
            pack_s=self.pack_s,
            run_s=run_s,
            timeseries=host.get("timeseries"),
            tick_s=self._tick_s)
