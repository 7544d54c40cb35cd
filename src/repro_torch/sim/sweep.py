"""Scenario sweeps: programmatic scenario families run as one batch.

The cap-only families of the reference's sweep harness
(``repro.sim.sweep``): cluster size x rack budget x spike pattern x host
mix, each under the ``cpc``/``static``/``statichigh`` policies, with the
same random draws (``np.random.RandomState(spec.seed)``), so both packages
build byte-identical cells.  Capacity churn, placement rules and budget
trees are later slices of the port; specs asking for them raise
:class:`repro_torch.sim.batch.BatchUnsupported`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.power_model import PAPER_HOST, HostPowerSpec
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim import workloads
from repro_torch.sim.batch import BatchCell, BatchedSimulator, BatchUnsupported
from repro_torch.sim.cluster import SimConfig

# A smaller, less efficient host mixed in for heterogeneous sweeps:
# 8 cores x 2.4 GHz, 64 GB, idle 120 W / peak 240 W.
SMALL_HOST = HostPowerSpec(
    capacity_peak=19_200.0,
    power_idle=120.0,
    power_peak=240.0,
    memory_mb=64 * 1024,
)

SPIKES = ("flat", "burst", "step", "prime")
POLICIES = ("cpc", "static", "statichigh")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One cell of the scenario grid."""

    name: str
    n_hosts: int = 10
    vms_per_host: int = 10
    rack_budget_w: Optional[float] = None   # default: 250 W per host
    spike: str = "burst"                    # one of SPIKES
    heterogeneous: bool = False             # mix PAPER_HOST with SMALL_HOST
    churn: str = "none"                     # only "none" is ported
    rules: str = "none"                     # only "none" is ported
    tree: str = "none"                      # only "none" is ported
    duration_s: float = 1200.0
    tick_s: float = 10.0
    drs_period_s: float = 300.0
    seed: int = 0

    @property
    def budget(self) -> float:
        return (self.rack_budget_w if self.rack_budget_w is not None
                else 250.0 * self.n_hosts)

    @property
    def n_vms(self) -> int:
        return self.n_hosts * self.vms_per_host


def _specs_for(spec: SweepSpec) -> list[HostPowerSpec]:
    if not spec.heterogeneous:
        return [PAPER_HOST] * spec.n_hosts
    return [PAPER_HOST if i % 2 == 0 else SMALL_HOST
            for i in range(spec.n_hosts)]


def _sweep_traces(spec: SweepSpec, base: np.ndarray, hot_host: np.ndarray,
                  phase_frac: np.ndarray, n_on: int,
                  vm_ids: Sequence[str]) -> dict:
    """One cell's demand traces, built as one ``(n, 3, 3)`` segment table."""
    n, d = spec.n_vms, spec.duration_s
    segs = np.zeros((n, 3, 3))
    segs[:, :, 2] = 2 * 1024.0
    segs[:, 0, 1] = base
    counts = np.ones(n, dtype=np.int64)
    periods = np.full(n, np.inf)
    if spec.spike == "burst":
        # VMs on ~20% of hosts spike >2x in the middle third of the run.
        hot = hot_host[np.arange(n) % n_on]
        counts[hot] = 3
        segs[hot, 1, 0] = d / 3.0
        segs[hot, 1, 1] = 2.0 * base[hot] + 1200.0
        segs[hot, 2, 0] = 2.0 * d / 3.0
        segs[hot, 2, 1] = base[hot]
    elif spec.spike == "step":
        # Cluster-wide step down then back up (standby-style).
        counts[:] = 3
        segs[:, 1, 0] = d / 3.0
        segs[:, 1, 1] = base / 3.0
        segs[:, 2, 0] = 2.0 * d / 3.0
        segs[:, 2, 1] = base
    elif spec.spike == "prime":
        # Periodic off/prime/off window, phase drawn per VM.
        periods[:] = d
        off, prime = 0.3 * base, 2.2 * base
        counts[:] = 3
        segs[:, 0, 1] = off
        segs[:, 1, 0] = phase_frac * d
        segs[:, 1, 1] = prime
        segs[:, 2, 0] = (phase_frac + 0.4) * d
        segs[:, 2, 1] = off
        z = phase_frac <= 0.0        # measure-zero draw: window opens at 0
        if z.any():
            counts[z] = 2
            segs[z, 0, 1] = prime[z]
            segs[z, 1, 0] = (phase_frac[z] + 0.4) * d
            segs[z, 1, 1] = off[z]
    return workloads.traces_from_table(vm_ids, segs, counts, periods)


def build_sweep(spec: SweepSpec, policy: str,
                trace_memo: Optional[dict] = None,
                vm_memo: Optional[dict] = None
                ) -> tuple[ClusterSnapshot, dict, SimConfig]:
    """Materialize one (spec, policy) cell.

    ``cpc``/``static`` spread the rack budget across every host pro rata
    by peak power; ``statichigh`` runs fewer hosts at their physical peak
    (the rest stay in standby with a zero cap), as in paper Table II.
    ``trace_memo`` (one spec) shares traces between policies with the same
    powered-on host count; ``vm_memo`` (one grid) shares the read-only VM
    list between cells with the same VM count and powered-on hosts.
    """
    if spec.spike not in SPIKES:
        raise ValueError(f"unknown spike pattern {spec.spike!r}")
    for field, later in (("churn", "item 5"), ("rules", "item 6"),
                         ("tree", "item 5")):
        if getattr(spec, field) != "none":
            raise BatchUnsupported(
                f"{spec.name}: {field}={getattr(spec, field)!r} is not "
                f"ported yet (a later slice: ROADMAP queue 1, {later})")
    host_specs = _specs_for(spec)
    budget = spec.budget
    total_peak = sum(s.power_peak for s in host_specs)

    hosts: list[Host] = []
    if policy == "statichigh":
        spent = 0.0
        for i, s in enumerate(host_specs):
            on = spent + s.power_peak <= budget + 1e-9
            hosts.append(Host(host_id=f"host{i}", spec=s,
                              power_cap=s.power_peak if on else 0.0,
                              powered_on=on))
            if on:
                spent += s.power_peak
    else:
        for i, s in enumerate(host_specs):
            cap = budget * s.power_peak / total_peak
            hosts.append(Host(host_id=f"host{i}", spec=s,
                              power_cap=min(cap, s.power_peak)))
    on_hosts = [h.host_id for h in hosts if h.powered_on]
    if not on_hosts:
        raise ValueError("budget too small: no host can power on")

    rng = np.random.RandomState(spec.seed)
    base = rng.uniform(600.0, 1400.0, size=spec.n_vms)
    # Host-correlated bursts: every VM on a "hot" host spikes together.
    hot_host = rng.rand(spec.n_hosts) < 0.2
    phase_frac = rng.uniform(0.0, 0.5, size=spec.n_vms)

    n_on = len(on_hosts)
    vm_key = (spec.n_vms, tuple(on_hosts))
    vms = None if vm_memo is None else vm_memo.get(vm_key)
    if vms is None:
        vms = [VirtualMachine(vm_id=f"vm{v}", vcpus=1,
                              host_id=on_hosts[v % n_on])
               for v in range(spec.n_vms)]
        if vm_memo is not None:
            vm_memo[vm_key] = vms
    if trace_memo is not None and n_on in trace_memo:
        traces = trace_memo[n_on]
    else:
        traces = _sweep_traces(spec, base, hot_host, phase_frac, n_on,
                               [vm.vm_id for vm in vms])
        if trace_memo is not None:
            trace_memo[n_on] = traces
    snap = ClusterSnapshot(hosts, vms, power_budget=budget)
    cfg = SimConfig(duration_s=spec.duration_s, tick_s=spec.tick_s,
                    drs_period_s=spec.drs_period_s,
                    drs_first_at_s=spec.drs_period_s)
    return snap, traces, cfg


@dataclasses.dataclass
class SweepCellResult:
    spec: SweepSpec
    policy: str
    wall_s: float                # share of the batch's run wall
    ticks: int
    ticks_per_s: float
    cpu_satisfaction: float
    cpu_payload_mhz_s: float
    energy_j: float
    cap_changes: int
    vmotions: int
    power_ons: int = 0
    power_offs: int = 0


def build_batch_cells(specs: Sequence[SweepSpec],
                      policies: Sequence[str]):
    """The grid's cells in ``specs x policies`` order, with their keys.

    ``cpc``/``static`` of one spec share one ``build_sweep`` result and one
    ``TraceBank``; a grid-wide memo shares VM lists (the engine only reads
    the snapshots).
    """
    cells, keys = [], []
    vm_memo: dict = {}
    for spec in specs:
        memo: dict = {}
        built: dict = {}                # deployment class -> build_sweep()
        banks: dict = {}                # id(traces) -> TraceBank
        for p in policies:
            dep = "statichigh" if p == "statichigh" else "spread"
            if dep not in built:
                built[dep] = build_sweep(spec, p, trace_memo=memo,
                                         vm_memo=vm_memo)
            snap, traces, cfg = built[dep]
            if id(traces) not in banks:
                banks[id(traces)] = workloads.TraceBank.from_traces(
                    traces, list(snap.vms))
            cells.append(BatchCell(
                name=f"{spec.name}/{p}", snapshot=snap, traces=traces,
                config=cfg, powercap_enabled=(p == "cpc"),
                trace_bank=banks[id(traces)]))
            keys.append((spec, p))
    return cells, keys


def run_sweep(specs: Sequence[SweepSpec],
              policies: Sequence[str] = POLICIES,
              engine: str = "batch",
              device=None) -> dict[str, dict[str, SweepCellResult]]:
    """Run the grid as one batch; returns ``results[spec.name][policy]``.

    Only the batched engine is ported; ``device=None`` runs it on the GPU.
    """
    if engine != "batch":
        raise ValueError(f"engine {engine!r} is not ported: use 'batch'")
    cells, keys = build_batch_cells(specs, policies)
    res = BatchedSimulator(cells, device=device).run()
    per_cell_wall = max(res.run_s, 1e-9) / len(keys)
    out: dict[str, dict[str, SweepCellResult]] = {}
    for i, (spec, p) in enumerate(keys):
        acc = res.accumulators(i)
        out.setdefault(spec.name, {})[p] = SweepCellResult(
            spec=spec, policy=p, wall_s=per_cell_wall, ticks=res.ticks,
            ticks_per_s=res.ticks / per_cell_wall,
            cpu_satisfaction=acc.cpu_satisfaction(),
            cpu_payload_mhz_s=acc.cpu_payload_mhz_s,
            energy_j=acc.energy_j,
            cap_changes=acc.cap_changes,
            vmotions=acc.vmotions,
            power_ons=acc.power_ons,
            power_offs=acc.power_offs)
    return out


def scenario_families(sizes: Sequence[int] = (10, 100, 1000),
                      budgets_per_host_w: Sequence[float] = (250.0,),
                      spikes: Sequence[str] = ("burst", "prime"),
                      heterogeneous: Sequence[bool] = (False, True),
                      duration_s: float = 1200.0,
                      tick_s: float = 10.0) -> list[SweepSpec]:
    """The cap-only grid: size x budget x spike x host mix."""
    return [SweepSpec(name=f"h{n}_b{int(b)}w_{spike}{'_het' if het else ''}",
                      n_hosts=n, rack_budget_w=b * n, spike=spike,
                      heterogeneous=het, duration_s=duration_s,
                      tick_s=tick_s)
            for n in sizes for b in budgets_per_host_w for spike in spikes
            for het in heterogeneous]
