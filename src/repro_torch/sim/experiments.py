"""The paper's three evaluation scenarios (Sec. V-B/C/D), policy-swappable.

Each builder returns ``(snapshot, traces, sim_config, window)``;
:func:`run_policy` runs one of them under CloudPowerCap, Static or
StaticHigh on the legacy per-object engine (the default, as in the
reference) or the vector engine, and :func:`run_all` under all three:
the metrics of Tables III, IV and V (:func:`repro_torch.sim.metrics.
ratio_table`).  The reference is ``repro.sim.experiments``; the builders
make the same clusters and traces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.backend import resolve_device
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import PAPER_HOST, HostPowerSpec
from repro_torch.drs.dpm import DPMConfig
from repro_torch.drs.rules import VMHostRule
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim import workloads
from repro_torch.sim.cluster import SimConfig, Simulator, SimResult
from repro_torch.sim.engine import VectorSimulator

#: The tick engines: the per-object legacy engine and the vector engine.
ENGINES = {"legacy": Simulator, "vector": VectorSimulator}


@dataclasses.dataclass
class Scenario:
    name: str
    build: Callable[[str], tuple[ClusterSnapshot, dict, SimConfig,
                                 Optional[tuple[float, float]]]]


def _mk_hosts(n: int, cap_w: float, spec: HostPowerSpec = PAPER_HOST
              ) -> list[Host]:
    return [Host(host_id=f"host{i}", spec=spec, power_cap=cap_w)
            for i in range(n)]


def _manager(policy: str, dpm_enabled: bool, device) -> CloudPowerCapManager:
    cfg = ManagerConfig(powercap_enabled=(policy == "cpc"),
                        dpm_enabled=dpm_enabled)
    cfg.dpm = DPMConfig(stable_window_s=150.0)
    return CloudPowerCapManager(cfg, device)


# --------------------------------------------------------------- Sec. V-B
def build_headroom(policy: str):
    """30 VMs on 3 hosts; one host's VMs spike 1.0 -> 2.4 GHz at 750 s."""
    cap = 320.0 if policy == "statichigh" else 250.0
    hosts = _mk_hosts(3, cap)
    vms, traces = [], {}
    for i in range(30):
        vm = VirtualMachine(vm_id=f"vm{i}", vcpus=1, memory_mb=8 * 1024,
                            host_id=f"host{i // 10}")
        vms.append(vm)
        if i < 10:   # the spiking host's VMs
            traces[vm.vm_id] = workloads.burst(
                base_cpu=1000.0, burst_cpu=2400.0, mem_mb=2 * 1024,
                t_start=750.0, t_end=1400.0)
        else:
            traces[vm.vm_id] = workloads.constant(1000.0, 2 * 1024)
    snap = ClusterSnapshot(hosts, vms, power_budget=3 * cap)
    cfg = SimConfig(duration_s=2100.0, drs_first_at_s=300.0)
    return snap, traces, cfg, (750.0, 1400.0)


# --------------------------------------------------------------- Sec. V-C
def build_standby(policy: str):
    """Demand 1.2 GHz -> 0.4 GHz at 750 s (DPM consolidates), back at
    1400 s: CloudPowerCap reallocates the powered-off host's budget,
    Static must power the host back on."""
    cap = 320.0 if policy == "statichigh" else 250.0
    hosts = _mk_hosts(3, cap)
    vms, traces = [], {}
    for i in range(30):
        vm = VirtualMachine(vm_id=f"vm{i}", vcpus=1, memory_mb=8 * 1024,
                            host_id=f"host{i // 10}")
        vms.append(vm)
        traces[vm.vm_id] = workloads.step_trace([
            (0.0, 1200.0, 2 * 1024),
            (750.0, 400.0, 2 * 1024),
            (1400.0, 1200.0, 2 * 1024),
        ])
    snap = ClusterSnapshot(hosts, vms, power_budget=3 * cap)
    cfg = SimConfig(duration_s=2100.0, drs_first_at_s=300.0)
    return snap, traces, cfg, None


# --------------------------------------------------------------- Sec. V-D
def build_flexible(policy: str):
    """Trading (prime-time bursty, storage-constrained to 8 hosts) and
    hadoop (steady, pinned) across a rack: Static and CloudPowerCap run 32
    hosts at 250 W, StaticHigh 25 hosts at 320 W (an 8 kW rack)."""
    if policy == "statichigh":
        n_hosts, cap = 25, 320.0
    else:
        n_hosts, cap = 32, 250.0
    hosts = _mk_hosts(n_hosts, cap)
    storage_hosts = [f"host{i}" for i in range(8)]
    vms, traces, rules = [], {}, []
    day = 21600.0  # a compressed 6 h "day"; the phases scale with it
    prime = (0.25, 0.5)  # prime time from 0.25 to 0.75 of the day

    vid = 0
    for h in range(n_hosts):
        host_id = f"host{h}"
        is_storage = host_id in storage_hosts
        if is_storage:
            for _ in range(6):   # trading VMs
                vm = VirtualMachine(vm_id=f"trd{vid}", vcpus=2,
                                    memory_mb=8 * 1024, host_id=host_id,
                                    tags=frozenset({"trading"}))
                vms.append(vm)
                traces[vm.vm_id] = workloads.prime_time(
                    off_cpu=200.0, prime_cpu=5200.0,
                    off_mem=2 * 1024, prime_mem=7 * 1024,
                    period_s=day, prime_start_frac=prime[0],
                    prime_frac=prime[1])
                rules.append(VMHostRule(vm.vm_id, frozenset(storage_hosts)))
                vid += 1
            n_hadoop = 3
        else:
            n_hadoop = 6
        for _ in range(n_hadoop):
            vm = VirtualMachine(vm_id=f"hdp{vid}", vcpus=2,
                                memory_mb=16 * 1024, host_id=host_id,
                                migratable=False,
                                tags=frozenset({"hadoop"}))
            vms.append(vm)
            if is_storage:
                # The elastic scheduler runs no hadoop task on trading hosts
                # in prime time.
                traces[vm.vm_id] = workloads.prime_time(
                    off_cpu=2500.0, prime_cpu=0.0,
                    off_mem=14 * 1024, prime_mem=14 * 1024,
                    period_s=day, prime_start_frac=prime[0],
                    prime_frac=prime[1])
            else:
                traces[vm.vm_id] = workloads.constant(2500.0, 14 * 1024)
            vid += 1
    snap = ClusterSnapshot(hosts, vms, power_budget=8000.0, rules=rules)
    cfg = SimConfig(duration_s=day, tick_s=60.0, drs_first_at_s=300.0,
                    record_timeline=False)
    return snap, traces, cfg, None


SCENARIOS = {
    "headroom": Scenario("headroom", build_headroom),
    "standby": Scenario("standby", build_standby),
    "flexible": Scenario("flexible", build_flexible),
}

POLICIES = ("cpc", "static", "statichigh")


def run_policy(scenario: str, policy: str,
               dpm_enabled: Optional[bool] = None,
               engine: str = "legacy", device=None) -> SimResult:
    """One scenario under one policy on ``engine`` (``"legacy"`` or
    ``"vector"``), its manager and engine on ``device`` (``None``: the
    GPU).  DPM runs on ``standby`` unless ``dpm_enabled`` says otherwise."""
    dev = resolve_device(device)
    snap, traces, cfg, window = SCENARIOS[scenario].build(policy)
    if dpm_enabled is None:
        dpm_enabled = scenario == "standby"
    manager = _manager(policy, dpm_enabled, dev)
    return ENGINES[engine](snap, manager, traces, cfg, window=window,
                           device=dev).run()


def run_all(scenario: str, engine: str = "legacy",
            device=None) -> dict[str, SimResult]:
    return {p: run_policy(scenario, p, engine=engine, device=device)
            for p in POLICIES}
