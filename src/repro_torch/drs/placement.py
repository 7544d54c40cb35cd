"""Placement: the fit check, initial placement and constraint correction.

Constraint correction is the first phase of every DRS invocation: the
migrations that fix rule violations (affinity, anti-affinity, VM-host).
CloudPowerCap lets the fit check read *fundable* capacity -- what a host
could reach if its cap were raised from the cluster's unreserved budget --
instead of the capacity at its current cap (paper Fig. 3 / Sec. IV-B).

:func:`correct_constraints` packs the snapshot into the dense slot layout,
runs the batched engine's correction kernel function through
:class:`repro_torch.core.migration_core.MigrationCore`, and replays the
moves onto the snapshot.  :func:`fits` and :func:`place` are the per-VM
primitives DPM's evacuation planning uses.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.drs import rules as rules_mod
from repro_torch.drs.snapshot import ClusterSnapshot

CapacityFn = Callable[[ClusterSnapshot, str], float]


def current_capacity(snapshot: ClusterSnapshot, host_id: str) -> float:
    """Capacity at the host's current power cap (static-cap world view)."""
    return snapshot.hosts[host_id].managed_capacity


def fits(snapshot: ClusterSnapshot, vm_id: str, host_id: str,
         capacity_fn: CapacityFn = current_capacity) -> bool:
    """Reservation, memory and rule admission of a what-if move, from the
    snapshot's cached per-host sums."""
    vm = snapshot.vms[vm_id]
    host = snapshot.hosts[host_id]
    if not host.powered_on:
        return False
    if not rules_mod.placement_allowed(snapshot, vm_id, host_id):
        return False
    cpu_after = snapshot.cached_cpu_reserved(host_id) + vm.reservation
    if cpu_after > capacity_fn(snapshot, host_id) + 1e-9:
        return False
    mem_after = snapshot.mem_demand_on(host_id) + vm.mem_demand
    return mem_after <= host.memory_mb + 1e-9


def place(snapshot: ClusterSnapshot, vm_id: str,
          capacity_fn: CapacityFn = current_capacity):
    """Initial placement: the admissible host with the most free
    capacity."""
    best, best_free = None, -1.0
    for host in snapshot.powered_on_hosts():
        if fits(snapshot, vm_id, host.host_id, capacity_fn):
            free = (capacity_fn(snapshot, host.host_id)
                    - snapshot.cached_cpu_reserved(host.host_id))
            if free > best_free:
                best, best_free = host.host_id, free
    return best


def correct_constraints(snapshot: ClusterSnapshot,
                        capacity_fn: CapacityFn = current_capacity,
                        budget=None, device=None) -> list[tuple[str, str]]:
    """The ``(vm_id, dest_host)`` moves that fix rule violations, applied
    to ``snapshot`` in place (callers pass a clone).  ``budget`` is the
    invocation's :class:`~repro_torch.core.migration_core.LaunchBudget`
    when launches are gated; the kernels run on ``device`` (``None``: the
    GPU)."""
    if not snapshot.rules:
        return []
    from repro_torch.core.migration_core import MigrationCore
    return MigrationCore(device=device).correct(snapshot, capacity_fn,
                                                budget)
