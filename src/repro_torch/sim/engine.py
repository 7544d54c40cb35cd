"""The vector engine: the per-tick hot path as tensor ops on one device.

:class:`VectorSimulator` runs the protocol of
:class:`repro_torch.sim.cluster.Simulator` -- action execution and manager
invocations on the object plane, on the host -- and keeps the per-tick
columns (VM demands, host caps, delivery, accounting) as ``float64``
tensors on its device.  Each tick is one segmented-waterfill delivery
(kernel K3 on the GPU) plus a handful of tensor ops; the reference is
``repro.sim.engine.VectorSimulator``.

* The CSR layout of the active VMs (stably sorted by host) is built once
  per placement and power state, when actions change them, not every tick.
  Per-host sums are trailing-axis sums over its rows: no atomics.
* The accumulators fold on the device with the tick loop's own
  ``acc = acc + x * dt`` and are read once, when the run ends.  Nothing in
  the tick waits on the device unless the timeline is recorded.
* Host copies of the caps and power states serve the budget invariant.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import kernels
from repro_torch.drs.entitlement import batched_waterfill
from repro_torch.drs.snapshot import ClusterSnapshot
from repro_torch.kernels.powercap.segments import row_sums, segment_layout
from repro_torch.sim.cluster import SimConfig, Simulator, SimResult
from repro_torch.sim.workloads import DemandTrace, TraceBank

#: The float accumulators, in the order of the device-side vector.
FIELDS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")


class VectorSimulator(Simulator):
    """Tensor-backed simulator on ``device`` (``None``: the GPU), which
    must be the manager's."""

    def __init__(self, snapshot: ClusterSnapshot, manager,
                 traces: dict[str, DemandTrace],
                 config: Optional[SimConfig] = None,
                 window: Optional[tuple[float, float]] = None,
                 device=None):
        super().__init__(snapshot, manager, traces, config, window, device)
        dev = self.device
        vms = list(self.live.vms.values())
        hosts = list(self.live.hosts.values())

        def col(values, dtype=torch.float64):
            return torch.as_tensor(np.array(values), dtype=dtype, device=dev)

        # Static VM columns.
        self._vm_ids = [v.vm_id for v in vms]
        self._vm_row = {vid: i for i, vid in enumerate(self._vm_ids)}
        self._reservation = col([v.reservation for v in vms])
        self._limit = col([v.limit for v in vms])
        self._shares = col([v.shares for v in vms])
        self._vm_powered = np.array([v.powered_on for v in vms], dtype=bool)
        # Static host columns.
        self._host_ids = [h.host_id for h in hosts]
        self._host_idx = {hid: i for i, hid in enumerate(self._host_ids)}
        self._host_static = [col([getattr(h.spec, f) for h in hosts])
                             for f in ("power_idle", "power_peak",
                                       "capacity_peak",
                                       "hypervisor_overhead")]
        self._host_mem = col([h.spec.memory_mb for h in hosts])
        # Per-tag VM masks (tags are static), in first-appearance order.
        tags: dict[str, list[int]] = {}
        for i, v in enumerate(vms):
            for tag in v.tags:
                tags.setdefault(tag, []).append(i)
        self._tags = list(tags)
        self._tag_mask = np.zeros((len(tags), len(vms)))
        for g, rows in enumerate(tags.values()):
            self._tag_mask[g, rows] = 1.0
        # Dynamic columns.
        self._cpu_dem = col([v.demand for v in vms])
        self._mem_dem = col([v.mem_demand for v in vms])
        self._bank = TraceBank.from_traces(traces, self._vm_ids)
        self._bank_is_all = (not self._bank.fallback and np.array_equal(
            self._bank.rows, np.arange(len(vms))))
        n_hosts = len(hosts)
        self._low_since = torch.full((n_hosts,), torch.nan,
                                     dtype=torch.float64, device=dev)
        # Device-side accumulators: FIELDS, their window twins, and the
        # per-tag payload and demand.
        self._acc = torch.zeros(len(FIELDS), dtype=torch.float64, device=dev)
        self._win = torch.zeros_like(self._acc)
        self._tag_acc = torch.zeros((2, len(self._tags)), dtype=torch.float64,
                                    device=dev)
        self._ticks = 0
        self._placement = None
        self._synced_version = -1
        self._refresh_topology()

    # ---------------------------------------------------------- topology
    def _refresh_topology(self) -> None:
        """Re-read caps and power states from the object plane, and the
        CSR layout when placements or power states changed."""
        hosts = self.live.hosts
        dev = self.device
        self._host_on = np.array(
            [hosts[hid].powered_on for hid in self._host_ids], dtype=bool)
        self._power_cap = np.array(
            [hosts[hid].power_cap for hid in self._host_ids],
            dtype=np.float64)
        idx = self._host_idx
        vm_host = np.array(
            [idx.get(self.live.vms[vid].host_id, -1) for vid in self._vm_ids],
            dtype=np.int64)
        on = torch.as_tensor(self._host_on, device=dev)
        self._on = on
        self._hosts = kernels.HostCols(on, *self._host_static)
        self._managed = kernels.managed_capacity(
            self._hosts, torch.as_tensor(self._power_cap, device=dev))
        placement = (vm_host.tobytes(), self._host_on.tobytes())
        if placement != self._placement:
            self._placement = placement
            placed = vm_host >= 0
            active = self._vm_powered & placed
            active[placed] &= self._host_on[vm_host[placed]]
            rows = np.nonzero(active)[0]
            rows = rows[np.argsort(vm_host[rows], kind="stable")]
            # The items are the active VMs in CSR order, so the layout's
            # permutation is the identity.
            n_hosts = len(self._host_ids)
            self._layout = segment_layout(vm_host[rows], n_hosts, dev)
            self._vms_per_host = np.bincount(vm_host[rows],
                                             minlength=n_hosts)
            items = torch.as_tensor(rows, device=dev)
            self._items = items
            self._res_i = self._reservation[items]
            self._limit_i = self._limit[items]
            self._shares_i = self._shares[items]
            self._tag_i = torch.as_tensor(self._tag_mask[:, rows],
                                          device=dev)
            self._host_mem_on = torch.where(on, self._host_mem, 0.0)
            self._mem_ok = on & (self._host_mem > 0.0)
        self._synced_version = self._topology_version

    def _arrays_current(self) -> None:
        if self._synced_version != self._topology_version:
            self._refresh_topology()

    # ------------------------------------------------------------- ticks
    def _update_demands(self, t: float) -> None:
        rows, cpu, mem = self._bank.eval(t, self.device)
        if self._bank_is_all:
            self._cpu_dem, self._mem_dem = cpu, mem
        else:
            self._cpu_dem[rows] = cpu
            self._mem_dem[rows] = mem

    def _migration_duration(self, vm) -> float:
        mb = max(float(self._mem_dem[self._vm_row[vm.vm_id]]), 64.0)
        return max(mb / self.config.vmotion_rate_mb_s, self.config.tick_s)

    def _overhead(self) -> Optional[torch.Tensor]:
        """Per-host vMotion CPU overhead of the in-flight migrations, or
        ``None`` when none runs."""
        running = self._running_migrations()
        if not running:
            return None
        overhead = np.zeros(len(self._host_ids))
        for p in running:
            vm = self.live.vms[p.action.target]
            src = self._host_idx.get(vm.host_id, -1)
            dst = self._host_idx.get(p.action.dest, -1)
            if src >= 0:
                overhead[src] += self.config.vmotion_overhead_mhz
            if dst >= 0 and dst != src:
                overhead[dst] += self.config.vmotion_overhead_mhz
        return torch.as_tensor(overhead, device=self.device)

    def _deliver_and_account(self, t: float) -> None:
        self._arrays_current()
        dt = self.config.tick_s
        on, managed = self._on, self._managed
        overhead = self._overhead()
        capacity = (managed if overhead is None
                    else torch.clamp_min(managed - overhead, 0.0))

        # Waterfill delivery: what each VM receives this tick (never above
        # instantaneous demand; reservations honored when demanded).
        cpu = self._cpu_dem[self._items]
        dem = torch.minimum(cpu, self._limit_i)
        floors = torch.minimum(self._res_i, dem)
        alloc = batched_waterfill(capacity, floors, dem, self._shares_i,
                                  layout=self._layout)
        eff = kernels.clip(cpu, self._res_i, self._limit_i)
        delivered, demand_h, mem_dem_h, eff_h = row_sums(
            self._layout, torch.stack([alloc, dem, self._mem_dem[self._items],
                                       eff]))
        # Memory: proportional delivery under overcommit.
        mem_deliv = torch.minimum(mem_dem_h, self._host_mem_on)
        # Eq. 1 power, utilization measured against peak capacity.
        busy = delivered if overhead is None else delivered + overhead
        power = kernels.power_consumed(self._hosts,
                                       busy / self._hosts.capacity_peak)
        tick = torch.stack([delivered.sum(), demand_h.sum(), mem_deliv.sum(),
                            mem_dem_h.sum(), power.sum()])
        self._acc = self._acc + tick * dt
        if self.window_acc is not None and self._in_window(t):
            self._win = self._win + tick * dt
        if self._tags:
            self._tag_acc = self._tag_acc + (
                self._tag_i * torch.stack([alloc, dem])[:, None]).sum(-1) * dt
        self._ticks += 1

        # DPM low-utilization tracking (NaN == "not in the low band").
        cpu_util = torch.where(managed > 0.0,
                               eff_h / torch.clamp_min(managed, 1e-300), 0.0)
        mem_util = torch.where(
            self._mem_ok,
            mem_dem_h / torch.clamp_min(self._host_mem, 1e-300), 0.0)
        low_util = self.manager.config.dpm.low_util
        low = on & (cpu_util < low_util) & (mem_util < low_util)
        low_since = torch.where(low & torch.isnan(self._low_since), t,
                                self._low_since)
        self._low_since = torch.where(on & ~low, torch.nan, low_since)

        if self.config.record_timeline:
            util = cpu_util.cpu().numpy()
            n_vms = self._vms_per_host
            self.timeline.append((t, {
                hid: ((self._power_cap[i], float(util[i]), int(n_vms[i]))
                      if self._host_on[i] else (self._power_cap[i], 0.0, 0))
                for i, hid in enumerate(self._host_ids)}))

    def _budget_invariant(self) -> None:
        self._arrays_current()
        total = float(self._power_cap[self._host_on].sum())
        for p in self.pending:
            if p.action.kind == "power_on" and p.state in ("waiting",
                                                           "running"):
                i = self._host_idx[p.action.target]
                if not self._host_on[i]:
                    total += float(self._power_cap[i])
        assert total <= self.live.power_budget + 1e-6, (
            f"budget violated during execution: {total:.1f} W > "
            f"{self.live.power_budget:.1f} W")
        tree = self.live.effective_tree()
        if tree is not None:
            mask = self._host_on.copy()
            for p in self.pending:
                if p.action.kind == "power_on" and p.state in ("waiting",
                                                               "running"):
                    mask[self._host_idx[p.action.target]] = True
            over = tree.max_overshoot(self._power_cap, mask)
            assert over <= 1e-6, (
                f"budget tree violated during execution: worst node over "
                f"by {over:.6f} W")

    # ----------------------------------------------------------- manager
    def _invoke_manager(self, t: float) -> None:
        # The manager pipeline runs on the object plane: push the demand
        # columns and the low-watermark tracker back into it first.
        cpu = self._cpu_dem.cpu().numpy()
        mem = self._mem_dem.cpu().numpy()
        vms = self.live.vms
        for row, vid in enumerate(self._vm_ids):
            vm = vms[vid]
            vm.demand = float(cpu[row])
            vm.mem_demand = float(mem[row])
        self.live.invalidate_host_sums()
        low_since = self._low_since.cpu().numpy()
        self.low_since = {
            self._host_ids[i]: float(low_since[i])
            for i in np.nonzero(~np.isnan(low_since))[0]}
        super()._invoke_manager(t)

    # --------------------------------------------------------------- run
    def run(self) -> SimResult:
        result = super().run()
        # The run's one read of the device-side accumulators.
        acc, win, tags = (self._acc.tolist(), self._win.tolist(),
                          self._tag_acc.tolist())
        for f, a, w in zip(FIELDS, acc, win):
            setattr(self.acc, f, a)
            if self.window_acc is not None:
                setattr(self.window_acc, f, w)
        if self._ticks:
            for g, tag in enumerate(self._tags):
                self.acc.tag_payload[tag] = tags[0][g]
                self.acc.tag_demand[tag] = tags[1][g]
        return result
