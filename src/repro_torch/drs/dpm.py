"""Distributed Power Management (paper Sec. II-C, IV-D).

DPM right-sizes the powered-on capacity: it consolidates VMs and powers a
host off when utilization stays low, and powers one on when any host runs
hot.  CloudPowerCap's Powercap Redistribution
(:mod:`repro_torch.core.redistribute`) frees the budget of a host powered
off and funds the cap of one powering on.  The trigger masks are the
kernel layer's, shared with the batched engine; the reference is
``repro.drs.dpm``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kernels
from repro_torch.drs import placement
from repro_torch.drs.snapshot import ClusterSnapshot


@dataclasses.dataclass
class DPMConfig:
    high_util: float = 0.81        # power-on trigger
    low_util: float = 0.45         # power-off consideration band
    target_util: float = 0.45      # post-consolidation ceiling on targets
    stable_window_s: float = 300.0 # utilization must be low this long

    def params(self) -> kernels.DPMParams:
        return kernels.DPMParams(
            high_util=self.high_util, low_util=self.low_util,
            target_util=self.target_util,
            stable_window_s=self.stable_window_s)


@dataclasses.dataclass
class DPMRecommendation:
    power_on: Optional[str] = None
    power_off: Optional[str] = None
    evacuations: list = dataclasses.field(default_factory=list)  # (vm, dest)


def capacity_at_util(snapshot: ClusterSnapshot, host_id: str,
                     util: float) -> float:
    """Managed capacity at which the host's current demand equals
    ``util``: 0 for a powered-off host or one without demand."""
    if not snapshot.hosts[host_id].powered_on:
        return 0.0
    demand = sum(v.effective_demand for v in snapshot.vms_on(host_id))
    if demand <= 0.0:
        return 0.0
    return demand / max(util, 1e-9)


def run_dpm(snapshot: ClusterSnapshot, config: DPMConfig,
            low_since: Optional[dict[str, float]] = None,
            now: float = 0.0,
            last_config_change: float = -1e18) -> DPMRecommendation:
    """One DPM pass.  ``low_since[host]`` is the time the host's
    utilization last entered the low band (for the stability window)."""
    rec = DPMRecommendation()
    on = snapshot.powered_on_hosts()
    standby = [h for h in snapshot.hosts.values() if not h.powered_on]

    av = snapshot.as_arrays()
    cpu_util = av.host_cpu_utilization()
    mem_util = av.host_mem_utilization()
    on_mask = av.host_on
    t_on, t_cpu, t_mem = (torch.from_numpy(x[None])
                          for x in (on_mask, cpu_util, mem_util))

    # Power-on: any hot host?
    if bool(kernels.dpm_hot_mask(t_on, t_cpu, t_mem,
                                 config.high_util).any()):
        if standby:
            rec.power_on = standby[0].host_id
        return rec

    # Power-off: sustained cluster-wide low utilization.
    if len(on) <= 1:
        return rec
    if not bool(kernels.dpm_all_low(t_on, t_cpu, t_mem,
                                    config.low_util)[0]):
        return rec
    if low_since is not None:
        oldest = max(max(low_since.get(h.host_id, now) for h in on),
                     last_config_change)
        if now - oldest < config.stable_window_s:
            return rec

    # Evacuate the least-utilized host (ranked by ``kernels.util_rank_key``:
    # rounding ties go to the lower index) if its VMs fit elsewhere
    # without pushing any target above target_util.
    on_idx = np.nonzero(on_mask)[0]
    keys = kernels.util_rank_key(torch.from_numpy(cpu_util[on_idx])).numpy()
    victim_i = int(on_idx[np.argmin(keys)])
    victim = snapshot.hosts[av.host_ids[victim_i]]
    # Budget trees: evacuees stay inside the victim's tightest saturated
    # subtree, the batched engine's ``kernels.tree_evac_scope``.
    tree = snapshot.effective_tree()
    evac_scope = None
    if tree is not None:
        evac_scope = kernels.tree_evac_scope(
            tree.cols(), t_on, torch.from_numpy(av.power_cap[None]),
            torch.tensor([victim_i]))[0].numpy()
    trial = snapshot.clone()
    evacuations: list[tuple[str, str]] = []
    ok = True
    for vm in sorted(trial.vms_on(victim.host_id),
                     key=lambda v: -v.mem_demand):
        if not vm.migratable:
            ok = False
            break
        best, best_util = None, 1e18
        for host in trial.powered_on_hosts():
            if host.host_id == victim.host_id:
                continue
            if evac_scope is not None and \
                    not bool(evac_scope[av.host_index[host.host_id]]):
                continue
            if not placement.fits(trial, vm.vm_id, host.host_id):
                continue
            cap = host.managed_capacity
            demand_after = sum(x.effective_demand
                               for x in trial.vms_on(host.host_id)
                               ) + vm.effective_demand
            util_after = demand_after / max(cap, 1e-9)
            mem_after = (sum(x.mem_demand for x in trial.vms_on(host.host_id))
                         + vm.mem_demand) / max(host.memory_mb, 1e-9)
            if util_after <= config.target_util and \
                    mem_after <= config.target_util and util_after < best_util:
                best, best_util = host.host_id, util_after
        if best is None:
            ok = False
            break
        trial.move_vm(vm.vm_id, best)
        evacuations.append((vm.vm_id, best))
    if ok:
        rec.power_off = victim.host_id
        rec.evacuations = evacuations
    return rec
