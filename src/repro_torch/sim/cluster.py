"""Simulator core: the tick loop and the execution of the manager's actions.

Mirrors the role of the DRS simulator in the paper's evaluation (Sec. V-A):
every tick, demand updates, pending actions complete and start, the
manager runs every DRS period, CPU is delivered within each host's
power-capped capacity, and Eq. 1 power is accounted.  Cap changes are
instantaneous; vMotions take a copy window with CPU overhead on both
endpoints; power-on and power-off take their latencies.

Delivery and accounting are the engine's: the port has the vector engine
(:class:`repro_torch.sim.engine.VectorSimulator`).  The per-object delivery
of the reference's legacy engine is a later slice (ROADMAP queue 1, item 8).
Scripted power events (host failures, maintenance windows) flip hosts on
schedule.  With gated migration launches every emitted migration starts at
its invocation's tick and migrations complete in emission order (FIFO),
the schedule the batched engine replays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.drs.snapshot import ClusterSnapshot
from repro_torch.sim.metrics import Accumulators
from repro_torch.sim.workloads import DemandTrace


@dataclasses.dataclass
class SimConfig:
    duration_s: float = 2100.0
    tick_s: float = 10.0
    drs_period_s: float = 300.0
    drs_first_at_s: float = 300.0
    vmotion_rate_mb_s: float = 128.0      # effective copy rate incl. recopy
    vmotion_overhead_mhz: float = 1500.0  # burned on src AND dst during copy
    max_concurrent_migrations: int = 4
    power_on_latency_s: float = 120.0
    power_off_latency_s: float = 30.0
    record_timeline: bool = True
    # Migrations complete at the tick they start, with no copy window and no
    # vMotion CPU overhead.
    instant_migrations: bool = False
    # Scripted host lifecycle events ((t_s, host_id, powered_on), ...),
    # applied at the first tick with t >= t_s.
    power_events: tuple = ()
    # Per-invocation migration-launch gates (None = ungated, 0 = none): a
    # host may be an endpoint of at most migration_slots_per_host
    # correction and balancer launches an invocation, the cluster of at
    # most migration_bandwidth.  Gated moves are not emitted (the next
    # invocation scores them again); evacuations are exempt.  Gated
    # migrations start at their invocation's tick (the launch gate replaces
    # the runtime concurrency gate) and complete FIFO.
    migration_slots_per_host: Optional[int] = None
    migration_bandwidth: Optional[int] = None

    @property
    def migration_gated(self) -> bool:
        return (self.migration_slots_per_host is not None
                or self.migration_bandwidth is not None)

    @property
    def migration_limits(self):
        """The kernels' twin of the launch gates, or ``None``."""
        if not self.migration_gated:
            return None
        from repro_torch.core.kernels import MigrationLimits
        return MigrationLimits(slots_per_host=self.migration_slots_per_host,
                               bandwidth=self.migration_bandwidth)


@dataclasses.dataclass
class SimResult:
    acc: Accumulators
    timeline: list                         # (t, {host: (cap_w, util, n_vms)})
    events: list                           # (t, str)
    final: ClusterSnapshot
    window_acc: Optional[Accumulators] = None


class _Pending:
    def __init__(self, action):
        self.action = action
        self.state = "waiting"             # waiting | running | done
        self.end_time = 0.0


class Simulator:
    """The tick loop; subclasses supply ``_deliver_and_account`` and
    ``_budget_invariant``."""

    def __init__(self, snapshot: ClusterSnapshot, manager,
                 traces: dict[str, DemandTrace],
                 config: Optional[SimConfig] = None,
                 window: Optional[tuple[float, float]] = None):
        self.live = snapshot
        self.manager = manager
        self.traces = traces
        self.config = config or SimConfig()
        self.window = window               # optional payload sub-window
        self.acc = Accumulators()
        self.window_acc = Accumulators() if window else None
        self.pending: list[_Pending] = []
        self.done_ids: set[int] = set()
        self.low_since: dict[str, float] = {}
        self.last_config_change = -1e18
        self.timeline: list = []
        self.events: list = []
        self._power_events = sorted(self.config.power_events)
        self._next_power_event = 0
        # Bumped whenever executed actions mutate placement, power state, or
        # caps; array-backed subclasses use it to refresh their columns.
        self._topology_version = 0

    # ------------------------------------------------------------------
    def _update_demands(self, t: float) -> None:
        for vm_id, trace in self.traces.items():
            cpu, mem = trace(t)
            vm = self.live.vms[vm_id]
            vm.demand, vm.mem_demand = cpu, mem
        # Demand edits bypass move_vm: drop the cached per-host sums.
        self.live.invalidate_host_sums()

    def _migration_duration(self, vm) -> float:
        mb = max(vm.mem_demand, 64.0)
        return max(mb / self.config.vmotion_rate_mb_s, self.config.tick_s)

    def _apply_power_events(self, t: float) -> None:
        """Scripted host lifecycle: power states flip at their scheduled
        tick, counting as a configuration change for DPM's stability
        window.  A returning host boots with at most the unallocated budget
        as its cap, and within its tree slack, with the grants of hosts
        whose power-on is in flight counted as allocated."""
        while (self._next_power_event < len(self._power_events)
               and self._power_events[self._next_power_event][0] <= t):
            _, host_id, on = self._power_events[self._next_power_event]
            self._next_power_event += 1
            host = self.live.hosts[host_id]
            if host.powered_on == bool(on):
                continue
            if on:
                total = sum(h.power_cap for h in self.live.powered_on_hosts())
                allocated = {h.host_id for h in self.live.powered_on_hosts()}
                for p in self.pending:
                    if p.action.kind == "power_on" and \
                            p.state in ("waiting", "running"):
                        tgt = self.live.hosts[p.action.target]
                        if not tgt.powered_on:
                            total += tgt.power_cap
                            allocated.add(tgt.host_id)
                host.power_cap = min(
                    host.power_cap,
                    max(self.live.power_budget - total, 0.0))
                tree = self.live.effective_tree()
                if tree is not None:
                    ids = list(self.live.hosts)
                    caps = np.array(
                        [self.live.hosts[h].power_cap for h in ids])
                    mask = np.array([h in allocated for h in ids])
                    slack = tree.host_slack(caps, mask)
                    host.power_cap = min(
                        host.power_cap,
                        max(float(slack[ids.index(host_id)]), 0.0))
            host.powered_on = bool(on)
            self._topology_version += 1
            self.last_config_change = t
            self.events.append(
                (t, f"power_event {host_id} {'on' if on else 'off'}"))

    def _prereqs_done(self, p: _Pending) -> bool:
        return all(pid in self.done_ids for pid in p.action.prereqs)

    def _running_migrations(self) -> list:
        return [p for p in self.pending
                if p.state == "running" and p.action.kind == "migrate"]

    def _host_migration_overhead(self, host_id: str) -> float:
        """vMotion CPU burned on ``host_id`` by the running migrations it
        is an endpoint of."""
        n = 0
        for p in self._running_migrations():
            vm = self.live.vms[p.action.target]
            if vm.host_id == host_id or p.action.dest == host_id:
                n += 1
        return n * self.config.vmotion_overhead_mhz

    # ------------------------------------------------------------------
    def _complete_actions(self, t: float) -> None:
        # Gated regime: migrations drain FIFO in emission order -- one may
        # not complete before every migration emitted ahead of it has.
        fifo = self.config.migration_gated
        mig_block = False
        for p in self.pending:
            if p.state != "running":
                continue
            if p.action.kind == "migrate" and fifo:
                if mig_block or p.end_time > t:
                    mig_block = True
                    continue
            elif p.end_time > t:
                continue
            a = p.action
            if a.kind == "migrate":
                self.live.move_vm(a.target, a.dest)
                self._topology_version += 1
                self.acc.vmotions += 1
                if self.window_acc is not None and self._in_window(t):
                    self.window_acc.vmotions += 1
            elif a.kind == "power_on":
                self.live.hosts[a.target].powered_on = True
                self._topology_version += 1
                self.acc.power_ons += 1
                self.last_config_change = t
                self.events.append((t, f"power_on {a.target}"))
            elif a.kind == "power_off":
                self.live.hosts[a.target].powered_on = False
                self._topology_version += 1
                self.acc.power_offs += 1
                self.last_config_change = t
                self.events.append((t, f"power_off {a.target}"))
            p.state = "done"
            self.done_ids.add(a.action_id)

    def _start_actions(self, t: float) -> None:
        running_migrations = len(self._running_migrations())
        for p in self.pending:
            if p.state != "waiting" or not self._prereqs_done(p):
                continue
            a = p.action
            if a.kind == "set_power_cap":
                # <1 ms on the baseboard: effectively instantaneous.
                self.live.hosts[a.target].power_cap = a.value
                self._topology_version += 1
                self.acc.cap_changes += 1
                p.state = "done"
                self.done_ids.add(a.action_id)
                self.events.append((t, f"cap {a.target}={a.value:.0f}W"))
            elif a.kind == "migrate":
                vm = self.live.vms[a.target]
                if vm.host_id == a.dest:   # already there (stale rec)
                    p.state = "done"
                    self.done_ids.add(a.action_id)
                    continue
                if self.config.instant_migrations:
                    # Atomic remap: no copy window, no endpoint overhead.
                    self.live.move_vm(a.target, a.dest)
                    self._topology_version += 1
                    self.acc.vmotions += 1
                    if self.window_acc is not None and self._in_window(t):
                        self.window_acc.vmotions += 1
                    p.state = "done"
                    self.done_ids.add(a.action_id)
                    continue
                if (not self.config.migration_gated
                        and running_migrations
                        >= self.config.max_concurrent_migrations):
                    # The ungated regime's runtime concurrency gate; gated
                    # clusters bound launches at the manager instead.
                    continue
                p.state = "running"
                p.end_time = t + self._migration_duration(vm)
                running_migrations += 1
            elif a.kind == "power_on":
                p.state = "running"
                p.end_time = t + self.config.power_on_latency_s
            elif a.kind == "power_off":
                p.state = "running"
                p.end_time = t + self.config.power_off_latency_s

    def _actions_outstanding(self) -> bool:
        return any(p.state != "done" for p in self.pending)

    # ------------------------------------------------------------------
    def _in_window(self, t: float) -> bool:
        return (self.window is not None and
                self.window[0] <= t < self.window[1])

    def _deliver_and_account(self, t: float) -> None:
        raise NotImplementedError(
            "the per-object delivery of the legacy engine is not ported yet "
            "(ROADMAP queue 1, item 8): use VectorSimulator")

    def _budget_invariant(self) -> None:
        raise NotImplementedError(
            "the per-object budget check of the legacy engine is not ported "
            "yet (ROADMAP queue 1, item 8): use VectorSimulator")

    def _invoke_manager(self, t: float) -> None:
        """One DRS + CloudPowerCap invocation; queues the emitted actions."""
        result = self.manager.run_invocation(
            self.live.clone(), now=t, low_since=self.low_since,
            last_config_change=self.last_config_change,
            limits=self.config.migration_limits)
        for a in result.actions:
            self.pending.append(_Pending(a))
        if result.actions:
            self.events.append(
                (t, f"drs: {len(result.actions)} actions "
                    f"({'; '.join(result.notes)})"))

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.config
        next_drs = cfg.drs_first_at_s
        t = 0.0
        while t < cfg.duration_s:
            self._apply_power_events(t)
            self._update_demands(t)
            self._complete_actions(t)
            self._start_actions(t)
            if t >= next_drs and not self._actions_outstanding():
                self._invoke_manager(t)
                next_drs = t + cfg.drs_period_s
            elif t >= next_drs:
                next_drs = t + cfg.tick_s   # defer while actions in flight
            self._start_actions(t)
            self._deliver_and_account(t)
            self._budget_invariant()
            t += cfg.tick_s
        return SimResult(acc=self.acc, timeline=self.timeline,
                         events=self.events, final=self.live,
                         window_acc=self.window_acc)
