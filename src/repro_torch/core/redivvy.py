"""Algorithm 1: RedivvyPowerCap -- proportional-share power redivvy.

After constraint correction changes where reservations live, host caps are
redistributed so that every host can honor its resident reservations and
the remaining unreserved budget is spread by proportional sharing.  The
conserving form of the paper's line 15 (shrinking hosts keep ``1 - r`` of
their excess), as in the reference (``repro.core.redivvy``).  The math is
the kernel layer's :func:`repro_torch.core.kernels.redivvy_caps`, run on
host columns on the CPU: this is the object plane.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kernels
from repro_torch.drs import actions as act
from repro_torch.drs.snapshot import ClusterSnapshot


def redivvy_power_cap(before: ClusterSnapshot, after: ClusterSnapshot,
                      reason: str = "redivvy") -> dict[str, float]:
    """Compute post-correction caps on ``after`` (mutating it) and return
    the per-host cap map.

    ``before`` holds the pre-correction caps; ``after`` the post-correction
    placements with caps at each host's reserved floor (callers build it
    with :func:`get_flexible_power`).
    """
    av = after.as_arrays()
    caps_start = np.array([before.hosts[hid].power_cap
                           for hid in av.host_ids], dtype=np.float64)
    on, floors = (torch.from_numpy(av.host_on[None]),
                  torch.from_numpy(av.power_cap[None]))
    new_caps = kernels.redivvy_caps(on, torch.from_numpy(caps_start[None]),
                                    floors)
    tree = after.effective_tree()
    if tree is not None:
        # Budget trees: the redivvied caps scaled back under every node
        # limit, the reserved floors protected (``after`` arrives floored).
        new_caps = kernels.tree_project_caps(tree.cols(), on, new_caps,
                                             floors)
    new_caps = new_caps[0].numpy()
    for i, hid in enumerate(av.host_ids):
        if av.host_on[i]:
            after.hosts[hid].power_cap = float(new_caps[i])
    total_before = sum(h.power_cap for h in before.hosts.values()
                       if h.powered_on)
    total_after = sum(h.power_cap for h in after.hosts.values()
                      if h.powered_on)
    assert total_after <= max(total_before, after.power_budget) + 1e-6, (
        f"redivvy grew allocation {total_before:.1f} -> {total_after:.1f}")
    return {h.host_id: h.power_cap for h in after.hosts.values()
            if h.powered_on}


def set_reserved_floor_caps(snapshot: ClusterSnapshot) -> None:
    """Drop every powered-on host's cap to its reserved floor, in place."""
    av = snapshot.as_arrays()
    floors = kernels.reserved_floor_caps(
        av.host_cols(), torch.from_numpy(av.cpu_reserved()[None]))[0].numpy()
    for i, hid in enumerate(av.host_ids):
        if av.host_on[i]:
            snapshot.hosts[hid].power_cap = float(floors[i])


def get_flexible_power(snapshot: ClusterSnapshot) -> ClusterSnapshot:
    """Clone with every host's cap at its reserved floor (paper Fig. 3
    step 1): the cluster's unreserved budget becomes flexible headroom."""
    flex = snapshot.clone()
    set_reserved_floor_caps(flex)
    return flex


def fundable_capacity(flex: ClusterSnapshot, host_id: str) -> float:
    """Max managed capacity ``host_id`` could reach if granted as much of
    the unreserved budget as physics allows (the placement fit check's
    capacity during Powercap Allocation)."""
    host = flex.hosts[host_id]
    if not host.powered_on:
        return 0.0
    spare = max(flex.power_budget - sum(
        h.power_cap for h in flex.powered_on_hosts()), 0.0)
    tree = flex.effective_tree()
    if tree is not None:
        # Spare Watts reach the host only up to the tightest headroom on
        # its root path.
        av = flex.as_arrays()
        slack = tree.host_slack(av.power_cap, av.host_on)
        spare = min(spare, max(float(slack[av.host_index[host_id]]), 0.0))
    cap = min(host.power_cap + spare, host.spec.power_peak)
    return float(host.spec.managed_capacity(cap))


def emit_actions(before: ClusterSnapshot, new_caps: dict[str, float],
                 reason: str = "redivvy") -> list[act.Action]:
    return act.order_cap_changes(before, new_caps, reason=reason)
