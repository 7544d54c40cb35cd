"""Constraint correction: the cap-only regime's early return.

Correcting placement-rule violations needs the migration layer, a later
slice of the port (ROADMAP queue 1, item 6): a snapshot with rules raises.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.drs.snapshot import ClusterSnapshot

CapacityFn = Callable[[ClusterSnapshot, str], float]


def current_capacity(snapshot: ClusterSnapshot, host_id: str) -> float:
    """Capacity at the host's current power cap (static-cap world view)."""
    return snapshot.hosts[host_id].managed_capacity


def correct_constraints(snapshot: ClusterSnapshot,
                        capacity_fn: CapacityFn = current_capacity,
                        budget=None) -> list[tuple[str, str]]:
    """The ``(vm_id, dest_host)`` moves that fix rule violations: none
    without rules."""
    if not snapshot.rules:
        return []
    raise NotImplementedError(
        "placement rules need the migration layer, which is not ported yet "
        "(ROADMAP queue 1, item 6)")
