"""Scenario sweeps: programmatic scenario families at cluster scale.

The families of the reference's sweep harness (``repro.sim.sweep``):
cluster size x rack budget x spike pattern x host mix x capacity churn x
placement rules, and the ``two_row`` budget tree, each under the
``cpc``/``static``/``statichigh`` policies, with the same random draws
(``np.random.RandomState(spec.seed)``), so both packages build
byte-identical cells.  :func:`run_sweep` runs them cell by cell on the
vector engine (the default, as in the reference) or the legacy engine,
or on the batched engine: grouped into pow2 ``(hosts, VMs a host)`` pad
buckets, one batch a bucket, packed in a thread pool while earlier buckets
run, the cells the batched engine cannot replay exactly run on the vector
engine under ``on_unsupported="fallback"``.  :func:`run_sweep_batched`
packs the whole grid to its exact maximum shape instead.

* Migration search is off (``max_moves=0``) in the cap-only and churn
  families.  The rule families (``violation_burst``: split affinity
  groups, co-placed anti-affinity pairs and misplaced VM-host rules;
  ``cap_blocked``: a Fig. 1a affinity correction that only fundable
  capacity admits) run the whole migration layer: constraint correction
  and the hill-climb balancer (:data:`RULE_BALANCER`).
* Capacity churn (``SweepSpec.churn``) exercises the host lifecycle:
  ``dpm`` (a demand valley consolidates and powers a host off, a later
  burst powers it back on with Powercap Redistribution funding its cap),
  ``maintenance`` (a scripted power-off/power-on window) and ``failure``
  (a scripted power-off that stays down, with DPM free to bring capacity
  back), all with instantaneous migrations.  ``timed_churn`` and
  ``failure_cascade`` rerun ``dpm`` and ``failure`` under gated timed
  vMotions (copy windows of at least a tick, both endpoints charged
  overhead, :data:`TIMED_SLOTS_PER_HOST` launches a host and
  :data:`TIMED_BANDWIDTH` a cluster an invocation) with the migration
  layer on, so deferred moves cascade across invocations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import warnings
from typing import Optional, Sequence

import numpy as np

from repro_torch.backend import resolve_device
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import PAPER_HOST, HostPowerSpec
from repro_torch.drs.balancer import BalancerConfig
from repro_torch.drs.rules import AffinityRule, AntiAffinityRule, VMHostRule
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim import workloads
from repro_torch.sim.batch import (BatchCell, BatchedSimulator,
                                   BatchUnsupported)
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.experiments import ENGINES, POLICIES

# A smaller, less efficient host mixed in for heterogeneous sweeps:
# 8 cores x 2.4 GHz, 64 GB, idle 120 W / peak 240 W.
SMALL_HOST = HostPowerSpec(
    capacity_peak=19_200.0,
    power_idle=120.0,
    power_peak=240.0,
    power_nameplate=300.0,
    memory_mb=64 * 1024,
)

SPIKES = ("flat", "burst", "step", "prime")
CHURNS = ("none", "dpm", "maintenance", "failure", "timed_churn",
          "failure_cascade")
RULESETS = ("none", "violation_burst", "cap_blocked")
TREES = ("none", "two_row")

#: ``two_row``: row 0 (the first half of the hosts) is limited to this
#: fraction of the rack budget, below its pro-rata share, so the row limit
#: binds before the rack budget does.
TWO_ROW_LIMIT_FRAC = 0.45

#: The timed families' launch gates: migration slots a host and the
#: cluster's launches an invocation.
TIMED_SLOTS_PER_HOST = 2
TIMED_BANDWIDTH = 8

#: The migration balancer of migration-enabled cells, on every engine (the
#: manager's for vector cells, its ``params()`` for the batched engine).
RULE_BALANCER = BalancerConfig(max_moves=8)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One cell of the scenario grid."""

    name: str
    n_hosts: int = 10
    vms_per_host: int = 10
    rack_budget_w: Optional[float] = None   # default: 250 W per host
    spike: str = "burst"                    # one of SPIKES
    heterogeneous: bool = False             # mix PAPER_HOST with SMALL_HOST
    churn: str = "none"                     # one of CHURNS
    rules: str = "none"                     # one of RULESETS
    tree: str = "none"                      # one of TREES
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

    @property
    def dpm_enabled(self) -> bool:
        """Churn families where the manager itself drives the lifecycle."""
        return self.churn in ("dpm", "failure", "timed_churn",
                              "failure_cascade")

    @property
    def timed(self) -> bool:
        """Families of the timed, gated vMotion model: copy windows, both
        endpoints' overhead, per-host slot and cluster bandwidth gates."""
        return self.churn in ("timed_churn", "failure_cascade")

    @property
    def migration_enabled(self) -> bool:
        """Families that run the migration layer (correction and the
        balancer): the rule families and the timed ones."""
        return self.rules != "none" or self.timed


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
    if spec.churn in ("dpm", "timed_churn"):
        # Valley then burst: the middle third idles the cluster into DPM's
        # power-off band, the last third runs hot enough to trip its
        # power-on trigger.
        counts[:] = 3
        segs[:, 1, 0] = d / 3.0
        segs[:, 1, 1] = 0.2 * base
        segs[:, 2, 0] = 2.0 * d / 3.0
        segs[:, 2, 1] = 2.2 * base + 1500.0
    elif spec.spike == "burst":
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
    list between cells with the same VM count and powered-on hosts (the
    ``cap_blocked`` reservations replace the VMs they change, copy on
    write).
    """
    for field, known in (("spike", SPIKES), ("churn", CHURNS),
                         ("rules", RULESETS), ("tree", TREES)):
        if getattr(spec, field) not in known:
            raise ValueError(f"unknown {field} family "
                             f"{getattr(spec, field)!r}")
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
    if spec.tree == "two_row":
        # The burst concentrated on row 0, so its limit is what binds (the
        # draws above still happen: tree-less specs keep their stream).
        hot_host = np.zeros(spec.n_hosts, dtype=bool)
        hot_host[:max(spec.n_hosts // 4, 1)] = True

    n_on = len(on_hosts)
    vm_key = (spec.n_vms, tuple(on_hosts))
    vms = None if vm_memo is None else vm_memo.get(vm_key)
    if vms is None:
        vms = [VirtualMachine(vm_id=f"vm{v}", vcpus=1, memory_mb=8 * 1024,
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

    rules: list = []
    if spec.rules != "none":
        if n_on < 4:
            raise ValueError("rule families need >= 4 powered-on hosts")
        if spec.rules == "violation_burst":
            # Corrections for the first DRS invocation: two affinity groups
            # split across hosts, two anti-affinity pairs on one host each,
            # two VMs off their allowed hosts.
            rules = [
                AffinityRule(("vm0", "vm1")),
                AffinityRule(("vm2", "vm3")),
                AntiAffinityRule(("vm4", f"vm{4 + n_on}")),
                AntiAffinityRule(("vm5", f"vm{5 + n_on}")),
                VMHostRule("vm6", frozenset(
                    {on_hosts[7 % n_on], on_hosts[8 % n_on]})),
                VMHostRule("vm7", frozenset(
                    {on_hosts[8 % n_on], on_hosts[9 % n_on]})),
            ]
        else:
            # cap_blocked, paper Fig. 1a at sweep scale: an affinity
            # correction that fits only when the check reads fundable
            # capacity (the anchor's host must go past its current cap).
            anchor, mover = "vm2", "vm0"
            overrides = {anchor: 14_000.0, mover: 6_000.0,
                         f"vm{n_on}": 12_000.0}    # host 0's second VM
            vms = [dataclasses.replace(v, reservation=overrides[v.vm_id])
                   if v.vm_id in overrides else v for v in vms]
            rules = [AffinityRule((mover, anchor))]
    tree = None
    if spec.tree == "two_row":
        tree = BudgetTree.two_rows(budget, spec.n_hosts,
                                   row0_limit=TWO_ROW_LIMIT_FRAC * budget)
        # The deployment respects the tree from t = 0: each binding row's
        # caps scaled down to its limit (sweep VMs reserve nothing).
        caps = np.array([h.power_cap for h in hosts])
        on_mask = np.array([h.powered_on for h in hosts])
        caps = tree.project(caps, on_mask, floors=np.zeros(spec.n_hosts))
        for h, cap in zip(hosts, caps):
            h.power_cap = float(cap)
    snap = ClusterSnapshot(hosts, vms, power_budget=budget, rules=rules,
                           budget_tree=tree)
    power_events: tuple = ()
    if spec.churn == "maintenance":
        # One powered-on host leaves for the middle third and returns.
        power_events = ((spec.duration_s / 3.0, on_hosts[0], False),
                        (2.0 * spec.duration_s / 3.0, on_hosts[0], True))
    elif spec.churn in ("failure", "failure_cascade"):
        # Capacity lost at mid-run; DPM may repair it (under timed gated
        # migrations in the cascade family).
        power_events = ((spec.duration_s / 2.0, on_hosts[0], False),)
    cfg = SimConfig(duration_s=spec.duration_s, tick_s=spec.tick_s,
                    drs_period_s=spec.drs_period_s,
                    drs_first_at_s=spec.drs_period_s,
                    record_timeline=False,
                    instant_migrations=((spec.dpm_enabled
                                         or spec.migration_enabled)
                                        and not spec.timed),
                    migration_slots_per_host=(TIMED_SLOTS_PER_HOST
                                              if spec.timed else None),
                    migration_bandwidth=(TIMED_BANDWIDTH
                                         if spec.timed else None),
                    power_events=power_events)
    return snap, traces, cfg


def _sweep_manager(policy: str, device=None,
                   spec: Optional[SweepSpec] = None) -> CloudPowerCapManager:
    """The sweeps' manager: the policy's powercap switch, DPM where the
    spec's churn family drives it, and :data:`RULE_BALANCER` where it runs
    the migration layer (no migration search elsewhere)."""
    balancer = (dataclasses.replace(RULE_BALANCER)
                if spec is not None and spec.migration_enabled
                else BalancerConfig(max_moves=0))
    cfg = ManagerConfig(powercap_enabled=(policy == "cpc"),
                        dpm_enabled=bool(spec and spec.dpm_enabled),
                        balancer=balancer)
    return CloudPowerCapManager(cfg, device)


def grid_balancer(specs: Sequence[SweepSpec]):
    """The batched engine's balancer (``MigrationParams``) when a spec runs
    the migration layer, else ``None``."""
    if any(s.migration_enabled for s in specs):
        return RULE_BALANCER.params()
    return None


@dataclasses.dataclass
class SweepCellResult:
    spec: SweepSpec
    policy: str
    wall_s: float                # batch engine: share of the batch's wall
    ticks: int
    ticks_per_s: float
    cpu_satisfaction: float
    cpu_payload_mhz_s: float
    energy_j: float
    cap_changes: int
    vmotions: int
    power_ons: int = 0
    power_offs: int = 0


def _same_trace_specs(a: dict, b: dict, vm_ids: Sequence[str]) -> bool:
    """Whether two trace dicts compile to the same ``TraceBank``: every VM
    traced in both with equal declarative specs (a callable without a
    spec is never shared)."""
    if a is b:
        return True
    for vid in vm_ids:
        sa = getattr(a.get(vid), "spec", None)
        sb = getattr(b.get(vid), "spec", None)
        if sa is None or sa != sb:
            return False
    return True


@contextlib.contextmanager
def _gc_pause():
    """Cyclic garbage collection off while a grid's cells are built: the
    burst of long-lived objects (VMs, traces) would trip repeated full
    collections that find nothing to free."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def build_batch_cells(specs: Sequence[SweepSpec],
                      policies: Sequence[str]):
    """The grid's cells in ``specs x policies`` order, with their keys.

    ``cpc``/``static`` of one spec share one ``build_sweep`` result, a
    spec's cells share one ``TraceBank`` wherever their trace specs are
    equal, and a grid-wide memo shares VM lists (the engine only reads the
    snapshots).
    """
    cells, keys = [], []
    vm_memo: dict = {}
    with _gc_pause():
        for spec in specs:
            bank, bank_traces = None, None
            memo: dict = {}
            built: dict = {}            # deployment class -> build_sweep()
            for p in policies:
                dep = "statichigh" if p == "statichigh" else "spread"
                if dep not in built:
                    built[dep] = build_sweep(spec, p, trace_memo=memo,
                                             vm_memo=vm_memo)
                snap, traces, cfg = built[dep]
                vm_ids = list(snap.vms)
                if (bank is None or bank.vm_order != vm_ids
                        or not _same_trace_specs(bank_traces, traces,
                                                 vm_ids)):
                    bank = workloads.TraceBank.from_traces(traces, vm_ids)
                    bank_traces = traces
                cells.append(BatchCell(
                    name=f"{spec.name}/{p}", snapshot=snap, traces=traces,
                    config=cfg, powercap_enabled=(p == "cpc"),
                    dpm_enabled=spec.dpm_enabled,
                    balancer_enabled=spec.migration_enabled,
                    trace_bank=bank))
                keys.append((spec, p))
    return cells, keys


def run_cell(spec: SweepSpec, policy: str, engine: str = "vector",
             device=None) -> SweepCellResult:
    """One cell on the vector or the legacy engine, on ``device``
    (``None``: the GPU)."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} runs no single cell: use one "
                         f"of {sorted(ENGINES)}")
    dev = resolve_device(device)
    snap, traces, cfg = build_sweep(spec, policy)
    sim = ENGINES[engine](snap, _sweep_manager(policy, dev, spec), traces,
                          cfg, device=dev)
    t0 = time.perf_counter()
    result = sim.run()
    wall = time.perf_counter() - t0
    ticks = int(round(cfg.duration_s / cfg.tick_s))
    acc = result.acc
    return SweepCellResult(
        spec=spec, policy=policy, wall_s=wall, ticks=ticks,
        ticks_per_s=ticks / max(wall, 1e-9),
        cpu_satisfaction=acc.cpu_satisfaction(),
        cpu_payload_mhz_s=acc.cpu_payload_mhz_s,
        energy_j=acc.energy_j,
        cap_changes=acc.cap_changes,
        vmotions=acc.vmotions,
        power_ons=acc.power_ons,
        power_offs=acc.power_offs)


#: One record a bucket of the most recent batched :func:`run_sweep` or
#: :func:`run_sweep_batched`, in bucket order: ``bucket`` (the pow2
#: ``(hosts, slots)`` class, ``(None, None)`` for the exact pack),
#: ``n_cells``, ``n_devices``, ``compile_s`` (kernel builds), ``pack_s``
#: (host-side packing), ``run_s`` (upload, tick loop and harvest),
#: ``wall_s`` (compile and run), ``info`` (the engine's
#: :attr:`BatchedSimulator.info`: ticks, ticks with an invocation,
#: device-to-host reads) and ``result`` (its
#: :class:`~repro_torch.sim.batch.BatchResult`: final states, invariants).
LAST_BATCH_INFO: list = []

#: Worker threads of the pipeline: bucket i + 1 packs while bucket i runs.
_PIPELINE_WORKERS = 4


def _pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _bucket_key(cell) -> tuple[int, int]:
    """A cell's pow2 shape class: (hosts, most VMs on one host), each
    rounded up to a power of two, so that a mixed 10/100/1000-host grid
    packs each size to its own class, not every cell to 1000 hosts."""
    counts: dict[str, int] = {}
    for v in cell.snapshot.vms.values():
        counts[v.host_id] = counts.get(v.host_id, 0) + 1
    return (_pow2(len(cell.snapshot.hosts)),
            _pow2(max(counts.values(), default=1)))


def _harvest_order(n: int) -> Sequence[int]:
    """The order the pipeline harvests its buckets in.  Results are keyed
    by cell and reassembled in ``specs x policies`` order, so any order
    gives the same grid (the tests shuffle it)."""
    return range(n)


def _cell_results(res, keys) -> dict:
    """``{(spec.name, policy): SweepCellResult}`` of one bucket's
    :class:`BatchResult`; each cell's ``wall_s`` is an even share of the
    bucket's ``run_s``."""
    per_cell_wall = max(res.run_s, 1e-9) / len(keys)
    out = {}
    for i, (spec, p) in enumerate(keys):
        acc = res.accumulators(i)
        out[(spec.name, p)] = SweepCellResult(
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


def _run_pipeline(buckets, n_devices: Optional[int] = None,
                  slot_slack: float = 3.0, device=None) -> dict:
    """Run prepared buckets, each ``(pad_hosts, pad_slots, cells, keys,
    balancer)``: a thread pool packs every bucket (host NumPy) and builds
    its kernels (:meth:`BatchedSimulator.compile`), and the calling thread
    runs each bucket (:meth:`BatchedSimulator.run_async`) as soon as it is
    packed, so bucket i + 1 packs while bucket i runs.  The harvest comes
    at the end, in :func:`_harvest_order`; one record a bucket lands in
    :data:`LAST_BATCH_INFO` in bucket order.  Returns ``{(spec.name,
    policy): result}``."""
    from concurrent.futures import ThreadPoolExecutor, as_completed

    dev = resolve_device(device)

    def build(i):
        hp, jp, cells, _, balancer = buckets[i]
        sim = BatchedSimulator(cells, slot_slack=slot_slack,
                               balancer=balancer, device=dev,
                               n_devices=n_devices, pad_hosts=hp,
                               pad_slots=jp)
        sim.compile()
        return i, sim

    pendings = [None] * len(buckets)
    with ThreadPoolExecutor(
            max_workers=min(len(buckets), _PIPELINE_WORKERS)) as pool:
        futs = [pool.submit(build, i) for i in range(len(buckets))]
        for fut in as_completed(futs):
            i, sim = fut.result()
            pendings[i] = sim.run_async()
    flat: dict = {}
    infos = [None] * len(buckets)
    for i in _harvest_order(len(buckets)):
        res = pendings[i].result()
        hp, jp, cells, keys, _ = buckets[i]
        infos[i] = {
            "bucket": (hp or None, jp or None),
            "n_cells": len(cells),
            "n_devices": res.n_devices,
            "compile_s": res.compile_s,
            "pack_s": res.pack_s,
            "run_s": res.run_s,
            "wall_s": res.wall_s,
            "info": dict(pendings[i].sim.info),
            "result": res,
        }
        flat.update(_cell_results(res, keys))
    LAST_BATCH_INFO.extend(infos)
    return flat


def _run_buckets(cells, keys, n_devices: Optional[int] = None,
                 slot_slack: float = 3.0, device=None) -> dict:
    """Group the cells into pow2 ``(hosts, slots)`` shape classes, one
    batch a class in ascending order, and run them through the
    pipeline."""
    by_bucket: dict[tuple[int, int], list] = {}
    for c, k in zip(cells, keys):
        by_bucket.setdefault(_bucket_key(c), []).append((c, k))
    work = []
    for (hp, jp), pairs in sorted(by_bucket.items()):
        bspecs = list(dict.fromkeys(k[0] for _, k in pairs))
        work.append((hp, jp, [c for c, _ in pairs], [k for _, k in pairs],
                     grid_balancer(bspecs)))
    return _run_pipeline(work, n_devices=n_devices, slot_slack=slot_slack,
                         device=device)


def run_sweep(specs: Sequence[SweepSpec],
              policies: Sequence[str] = POLICIES,
              engine: str = "vector",
              on_unsupported: str = "raise",
              n_devices: Optional[int] = None,
              device=None,
              slot_slack: float = 3.0
              ) -> dict[str, dict[str, SweepCellResult]]:
    """Run the grid; returns ``results[spec.name][policy]`` in ``specs x
    policies`` order.

    ``engine="vector"`` or ``"legacy"`` runs the cells one by one.
    ``engine="batch"`` first probes the whole grid for cells the batched
    engine cannot replay exactly: by default the first raises
    :class:`BatchUnsupported`; with ``on_unsupported="fallback"`` a
    warning names them and they run on the vector engine.  The rest are
    grouped into pow2 ``(hosts, VMs a host)`` pad buckets, one
    :class:`BatchedSimulator` a bucket (with :func:`grid_balancer`'s
    balancer, its slot axis widened by ``slot_slack`` for migrations and
    DPM's evacuations), run through the pipeline (:data:`LAST_BATCH_INFO`
    holds a record a bucket).  ``n_devices`` splits each bucket's cells
    over that many ranks of the process group (clamped to the bucket's
    cells; ``None``: every rank, one without a process group): every rank
    runs the same call and gets the whole grid's results (see
    :class:`~repro_torch.sim.batch.BatchedSimulator`).  ``device=None``
    runs on the GPU.
    """
    if engine != "batch":
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: use 'vector', 'legacy' "
                             f"or 'batch'")
        return {spec.name: {p: run_cell(spec, p, engine, device)
                            for p in policies} for spec in specs}
    resolve_device(device)
    LAST_BATCH_INFO.clear()
    cells, keys = build_batch_cells(specs, policies)
    reasons = BatchedSimulator.unsupported_cells(cells, grid_balancer(specs))
    if reasons and on_unsupported != "fallback":
        # The whole grid is probed first: bucketing could otherwise hide a
        # time-grid mismatch by splitting the cells that disagree.
        name, why = min(reasons.items())
        raise BatchUnsupported(f"cell {name!r}: {why}")
    if reasons:
        warnings.warn(
            "batched engine cannot run cells "
            f"{sorted(reasons)[:5]}{'...' if len(reasons) > 5 else ''} "
            f"({next(iter(reasons.values()))}); running those on the "
            "sequential vector engine and batching the rest",
            RuntimeWarning, stacklevel=2)
    good = [(c, k) for c, k in zip(cells, keys)
            if f"{k[0].name}/{k[1]}" not in reasons]
    flat = (_run_buckets([c for c, _ in good], [k for _, k in good],
                         n_devices, slot_slack, device) if good else {})
    return {spec.name: {p: flat.get((spec.name, p))
                        or run_cell(spec, p, "vector", device)
                        for p in policies} for spec in specs}


def run_sweep_batched(specs: Sequence[SweepSpec],
                      policies: Sequence[str] = POLICIES,
                      slot_slack: float = 3.0,
                      _prebuilt=None,
                      n_devices: Optional[int] = None,
                      device=None
                      ) -> dict[str, dict[str, SweepCellResult]]:
    """The whole grid as one batch packed to its exact maximum ``(hosts,
    slots)``, no pow2 padding: the shape the reference's benchmark
    baselines use.  All specs must share the time grid.  ``_prebuilt``
    takes ``build_batch_cells``' output instead of building the grid
    again.  ``n_devices`` as :func:`run_sweep` takes it."""
    cells, keys = _prebuilt or build_batch_cells(specs, policies)
    LAST_BATCH_INFO.clear()
    flat = _run_pipeline([(0, 0, cells, keys, grid_balancer(specs))],
                         n_devices=n_devices, slot_slack=slot_slack,
                         device=device)
    out: dict[str, dict[str, SweepCellResult]] = {}
    for spec, p in keys:
        out.setdefault(spec.name, {})[p] = flat[(spec.name, p)]
    return out


def scenario_families(sizes: Sequence[int] = (10, 100, 1000),
                      budgets_per_host_w: Sequence[float] = (250.0,),
                      spikes: Sequence[str] = ("burst", "prime"),
                      heterogeneous: Sequence[bool] = (False, True),
                      churns: Sequence[str] = ("none",),
                      rules: Sequence[str] = ("none",),
                      duration_s: float = 1200.0,
                      tick_s: float = 10.0) -> list[SweepSpec]:
    """The grid: size x budget x spike x host mix x churn x rules (the
    reference's names and order)."""
    return [SweepSpec(name=(f"h{n}_b{int(b)}w_{spike}"
                            f"{'_het' if het else ''}"
                            f"{'' if churn == 'none' else '_' + churn}"
                            f"{'' if rule == 'none' else '_' + rule}"),
                      n_hosts=n, rack_budget_w=b * n, spike=spike,
                      heterogeneous=het, churn=churn, rules=rule,
                      duration_s=duration_s, tick_s=tick_s)
            for n in sizes for b in budgets_per_host_w for spike in spikes
            for het in heterogeneous for churn in churns for rule in rules]


def row_contention_specs(sizes: Sequence[int] = (10, 100),
                         duration_s: float = 1200.0,
                         tick_s: float = 10.0) -> list[SweepSpec]:
    """The ``two_row`` budget-tree family: a row limit binds before the
    rack budget does (the burst concentrated on row 0), in the cap-only
    regime."""
    return [SweepSpec(name=f"h{n}_row_contention", n_hosts=n,
                      spike="burst", tree="two_row",
                      duration_s=duration_s, tick_s=tick_s)
            for n in sizes]


def scale_ladder(sizes: Sequence[int] = (10, 100, 1000),
                 spike: str = "burst",
                 duration_s: float = 600.0,
                 tick_s: float = 10.0) -> list[SweepSpec]:
    """The ``sweep_scale`` benchmark ladder: one spike family per size."""
    return [SweepSpec(name=f"h{n}_{spike}", n_hosts=n, spike=spike,
                      duration_s=duration_s, tick_s=tick_s)
            for n in sizes]
