"""Placement: the fit check, initial placement and constraint correction.

:func:`fits` and :func:`place` are the object-plane primitives DPM's
evacuation planning uses.  Correcting placement-rule violations needs the
migration layer, a later slice of the port (ROADMAP queue 1, item 6): a
snapshot with rules raises, here and in :func:`fits`.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.drs.snapshot import ClusterSnapshot

CapacityFn = Callable[[ClusterSnapshot, str], float]


def current_capacity(snapshot: ClusterSnapshot, host_id: str) -> float:
    """Capacity at the host's current power cap (static-cap world view)."""
    return snapshot.hosts[host_id].managed_capacity


def _no_rules(snapshot: ClusterSnapshot) -> None:
    if snapshot.rules:
        raise NotImplementedError(
            "placement rules need the migration layer, which is not ported "
            "yet (ROADMAP queue 1, item 6)")


def fits(snapshot: ClusterSnapshot, vm_id: str, host_id: str,
         capacity_fn: CapacityFn = current_capacity) -> bool:
    """Reservation and memory admission of a what-if move, from the
    snapshot's cached per-host sums."""
    _no_rules(snapshot)
    vm = snapshot.vms[vm_id]
    host = snapshot.hosts[host_id]
    if not host.powered_on:
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
                        budget=None) -> list[tuple[str, str]]:
    """The ``(vm_id, dest_host)`` moves that fix rule violations: none
    without rules."""
    _no_rules(snapshot)
    return []
