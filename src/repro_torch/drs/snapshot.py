"""Cluster snapshot datamodel.

DRS (and CloudPowerCap with it) works on a snapshot of the VM/host
inventory: it clones the snapshot, runs candidate actions on the clone in
what-if mode, and emits the actions that pass.  Capacity unit is MHz
(paper convention).

A snapshot may carry a :class:`repro_torch.core.budget_tree.BudgetTree`
over its hosts (in iteration order) and placement rules
(:mod:`repro_torch.drs.rules`), which the migration layer corrects toward
and DPM's evacuations keep.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import TYPE_CHECKING, Iterable, Optional

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.power_model import HostPowerSpec


@dataclasses.dataclass
class VirtualMachine:
    """A VM of the simulator plane."""

    vm_id: str
    vcpus: int = 1
    memory_mb: float = 8 * 1024
    # Resource controls (paper Sec. II-C).
    reservation: float = 0.0            # MHz, guaranteed
    limit: float = math.inf             # MHz, hard upper bound
    shares: Optional[float] = None      # default: 1000 per vCPU
    mem_reservation: float = 0.0        # MB
    # Current state.
    demand: float = 0.0                 # MHz the VM would consume uncontended
    mem_demand: float = 0.0             # MB
    host_id: Optional[str] = None
    powered_on: bool = True
    migratable: bool = True
    tags: frozenset = frozenset()

    def __post_init__(self) -> None:
        if self.shares is None:
            self.shares = 1000.0 * self.vcpus
        if self.limit < self.reservation:
            raise ValueError(f"{self.vm_id}: limit < reservation")

    @property
    def effective_demand(self) -> float:
        """Demand clamped into [reservation, limit]."""
        return float(np.clip(self.demand, self.reservation, self.limit))


@dataclasses.dataclass
class Host:
    host_id: str
    spec: "HostPowerSpec"
    power_cap: float                    # Watts; enforced by the baseboard
    powered_on: bool = True
    tags: frozenset = frozenset()

    @property
    def capped_capacity(self) -> float:
        """Eq. 3: raw capacity reachable at the current power cap."""
        if not self.powered_on:
            return 0.0
        return float(self.spec.capped_capacity(self.power_cap))

    @property
    def managed_capacity(self) -> float:
        """Eq. 4: capacity the resource manager may allocate."""
        if not self.powered_on:
            return 0.0
        return float(self.spec.managed_capacity(self.power_cap))

    @property
    def peak_managed_capacity(self) -> float:
        return float(self.spec.managed_capacity(self.spec.power_peak))

    @property
    def memory_mb(self) -> float:
        return self.spec.memory_mb if self.powered_on else 0.0


class ClusterSnapshot:
    """Hosts + VMs + the cluster power budget."""

    def __init__(self, hosts: Iterable[Host], vms: Iterable[VirtualMachine],
                 power_budget: float, rules: Optional[list] = None,
                 budget_tree=None):
        self.hosts: dict[str, Host] = {h.host_id: h for h in hosts}
        self.vms: dict[str, VirtualMachine] = {v.vm_id: v for v in vms}
        self.power_budget = float(power_budget)
        self.rules = list(rules or [])
        #: ``None`` or a trivial tree means the flat scalar budget; trees
        #: are immutable and shared across clones.
        self.budget_tree = budget_tree
        if budget_tree is not None and budget_tree.n_hosts != len(self.hosts):
            raise ValueError("budget tree host count != cluster host count")
        self._host_sums: Optional[dict] = None
        for vm in self.vms.values():
            if vm.host_id is not None and vm.host_id not in self.hosts:
                raise ValueError(f"{vm.vm_id} placed on unknown host")

    def clone(self) -> "ClusterSnapshot":
        snap = ClusterSnapshot.__new__(ClusterSnapshot)
        snap.hosts = {k: copy.copy(h) for k, h in self.hosts.items()}
        snap.vms = {k: copy.copy(v) for k, v in self.vms.items()}
        snap.power_budget = self.power_budget
        snap.rules = list(self.rules)
        snap.budget_tree = self.budget_tree
        snap._host_sums = None
        return snap

    # ------------------------------------------------- per-host sum cache
    def _placement_sums(self) -> dict:
        """Cached per-host ``{cpu_reserved, mem_demand}`` rollups, built in
        one pass and kept coherent by :meth:`move_vm`; any other mutation
        of placements, VM power states or demands must call
        :meth:`invalidate_host_sums`."""
        if self._host_sums is None:
            cpu = {hid: 0.0 for hid in self.hosts}
            mem = {hid: 0.0 for hid in self.hosts}
            for v in self.vms.values():
                if v.powered_on and v.host_id in cpu:
                    cpu[v.host_id] += v.reservation
                    mem[v.host_id] += v.mem_demand
            self._host_sums = {"cpu_reserved": cpu, "mem_demand": mem}
        return self._host_sums

    def invalidate_host_sums(self) -> None:
        self._host_sums = None

    def move_vm(self, vm_id: str, dest_host: Optional[str]) -> None:
        """Re-place a VM, keeping the per-host sum cache coherent."""
        vm = self.vms[vm_id]
        if self._host_sums is not None and vm.powered_on:
            for key, val in (("cpu_reserved", vm.reservation),
                             ("mem_demand", vm.mem_demand)):
                col = self._host_sums[key]
                if vm.host_id in col:
                    col[vm.host_id] -= val
                if dest_host in col:
                    col[dest_host] += val
        vm.host_id = dest_host

    def as_arrays(self, device=None):
        """Struct-of-arrays view (:class:`repro_torch.drs.arrays.ArrayView`)
        at call time; ``device`` is where its waterfills run (``None``: the
        GPU)."""
        from repro_torch.drs.arrays import ArrayView
        return ArrayView.from_snapshot(self, device)

    def powered_on_hosts(self) -> list[Host]:
        return [h for h in self.hosts.values() if h.powered_on]

    def vms_on(self, host_id: str) -> list[VirtualMachine]:
        return [v for v in self.vms.values()
                if v.host_id == host_id and v.powered_on]

    # ------------------------------------------------------- reservations
    def cpu_reserved(self, host_id: str) -> float:
        return sum(v.reservation for v in self.vms_on(host_id))

    def cached_cpu_reserved(self, host_id: str) -> float:
        """O(1) reserved-CPU sum, valid while placements change only
        through :meth:`move_vm`."""
        return self._placement_sums()["cpu_reserved"].get(host_id, 0.0)

    def mem_demand_on(self, host_id: str) -> float:
        return self._placement_sums()["mem_demand"].get(host_id, 0.0)

    def mem_used(self, host_id: str) -> float:
        return sum(v.memory_mb for v in self.vms_on(host_id))

    def mem_reserved(self, host_id: str) -> float:
        return sum(v.mem_reservation for v in self.vms_on(host_id))

    def reserved_power_cap(self, host_id: str) -> float:
        """Minimum power cap supporting the reservations of resident VMs."""
        host = self.hosts[host_id]
        if not host.powered_on:
            return 0.0
        return float(host.spec.cap_for_managed_capacity(
            self.cpu_reserved(host_id)))

    def total_allocated_power(self) -> float:
        return sum(h.power_cap for h in self.hosts.values() if h.powered_on)

    def unreserved_power_budget(self) -> float:
        """Budget minus the power needed for running VMs' reservations."""
        av = self.as_arrays()
        return self.power_budget - float(
            av.reserved_power_cap()[av.host_on].sum())

    def unallocated_power_budget(self) -> float:
        return self.power_budget - self.total_allocated_power()

    # ------------------------------------------------------- entitlements
    def normalized_entitlement(self, host_id: str, device=None) -> float:
        """N_h = sum of VM entitlements / host managed capacity."""
        av = self.as_arrays(device)
        return float(av.normalized_entitlements()[av.host_index[host_id]])

    def imbalance(self, device=None) -> float:
        """DRS imbalance metric: stddev of normalized entitlements, from one
        segmented waterfill over every host (kernel K3 on the GPU)."""
        return self.as_arrays(device).imbalance()

    def host_cpu_utilization(self, host_id: str) -> float:
        host = self.hosts[host_id]
        cap = host.managed_capacity
        if cap <= 0:
            return 0.0
        demand = sum(v.effective_demand for v in self.vms_on(host_id))
        return demand / cap

    def host_mem_utilization(self, host_id: str) -> float:
        """Active-memory utilization (demand-based, ESX-style)."""
        host = self.hosts[host_id]
        if not host.powered_on or host.memory_mb <= 0:
            return 0.0
        demand = sum(v.mem_demand for v in self.vms_on(host_id))
        return demand / host.memory_mb

    # -------------------------------------------------------------- checks
    def reservations_respected(self, host_id: str) -> bool:
        """Admission-control invariant: CPU and memory reservations fit."""
        host = self.hosts[host_id]
        return (self.cpu_reserved(host_id) <= host.managed_capacity + 1e-6
                and self.mem_reserved(host_id) <= host.memory_mb + 1e-6)

    def budget_respected(self) -> bool:
        return self.total_allocated_power() <= self.power_budget + 1e-6

    def effective_tree(self):
        """The budget tree when it constrains beyond the scalar budget;
        ``None`` for a flat or trivial one (the engines then take the
        scalar path, bitwise)."""
        tree = self.budget_tree
        if tree is None or tree.is_trivial(self.power_budget):
            return None
        return tree

    def tree_respected(self, atol: float = 1e-6) -> bool:
        """Every budget-tree node's subtree cap-sum within its limit."""
        tree = self.effective_tree()
        if tree is None:
            return True
        av = self.as_arrays()
        return tree.max_overshoot(av.power_cap, av.host_on) <= atol

    def validate(self) -> None:
        assert self.budget_respected(), (
            f"power budget violated: {self.total_allocated_power():.1f} W "
            f"allocated > {self.power_budget:.1f} W budget")
        assert self.tree_respected(), (
            "budget tree violated: a node's subtree caps exceed its limit")
        # :meth:`reservations_respected` for every powered-on host, with
        # the per-host sums taken in one pass over the VMs (the same order
        # of additions, so the same floats).
        cpu = {hid: 0 for hid in self.hosts}
        mem = {hid: 0 for hid in self.hosts}
        for v in self.vms.values():
            if v.powered_on and v.host_id in cpu:
                cpu[v.host_id] += v.reservation
                mem[v.host_id] += v.mem_reservation
        for h in self.powered_on_hosts():
            assert (cpu[h.host_id] <= h.managed_capacity + 1e-6
                    and mem[h.host_id] <= h.memory_mb + 1e-6), (
                f"{h.host_id}: reservations exceed managed capacity")
