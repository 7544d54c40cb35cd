"""Algorithm 3: Powercap Redistribution for DPM's host power-on and -off.

Power-on: the candidate host needs a cap before it joins.  Take the
unallocated budget first; if that is short, drain hosts of low utilization,
never below the capacity at which DPM's power-on trigger would fire nor
below their reservations.  Power-off: the host's cap returns to the pool
and is spread over the remaining hosts in proportion to their headroom to
peak.

Both decisions are the kernel layer's ``power_on_funding_caps`` and
``power_off_reabsorb_caps``, shared with the batched engine and run here
on host columns on the CPU (the object plane).  The reference is
``repro.core.redistribute``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import kernels
from repro_torch.drs import actions as act
from repro_torch.drs.snapshot import ClusterSnapshot

if TYPE_CHECKING:
    from repro_torch.drs.dpm import DPMConfig


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x))


def redistribute_for_power_on(snapshot: ClusterSnapshot, candidate_id: str,
                              dpm_config: "DPMConfig | None" = None
                              ) -> tuple[ClusterSnapshot, float]:
    """Fund ``candidate_id``'s cap; returns (what-if snapshot, granted W).
    The candidate ends with the largest cap the budget allows, at most its
    peak; donors keep their reservations and stay out of DPM's power-on
    band."""
    from repro_torch.drs.dpm import DPMConfig
    dpm_config = dpm_config or DPMConfig()
    f = snapshot.clone()
    av = f.as_arrays()
    tree = f.effective_tree()
    new_caps, _ = kernels.power_on_funding_caps(
        av.host_cols(), _t(av.power_cap[None]),
        torch.tensor([av.host_index[candidate_id]]),
        _t(av.host_cpu_utilization()[None]), _t(av.host_demand()[None]),
        _t(av.cpu_reserved()[None]), _t([f.power_budget]),
        dpm_config.high_util,
        tree=tree.cols() if tree is not None else None)
    av.write_caps(f, new_caps[0].numpy())
    # The cap is the budget allocation: below idle the host cannot even sit
    # powered on, which the caller treats as infeasible.
    return f, f.hosts[candidate_id].power_cap


def redistribute_after_power_off(snapshot: ClusterSnapshot, off_id: str
                                 ) -> ClusterSnapshot:
    """Reabsorb ``off_id``'s budget into the remaining hosts' caps, in
    proportion to each one's headroom to peak."""
    f = snapshot.clone()
    av = f.as_arrays()
    tree = f.effective_tree()
    new_caps = kernels.power_off_reabsorb_caps(
        av.host_cols(), _t(av.power_cap[None]),
        torch.tensor([av.host_index[off_id]]), _t([f.power_budget]),
        tree=tree.cols() if tree is not None else None)
    f.hosts[off_id].powered_on = False
    av.write_caps(f, new_caps[0].numpy())
    f.validate()
    return f


def emit_actions(before: ClusterSnapshot, after: ClusterSnapshot,
                 reason: str = "powercap-redistribute",
                 include: tuple[str, ...] = ()) -> list[act.Action]:
    """Cap-change actions for every host powered on in either snapshot,
    and for ``include`` (the power-on candidate, whose funded cap applies
    while it is still in standby)."""
    new_caps = {h.host_id: h.power_cap for h in after.hosts.values()
                if h.powered_on or before.hosts[h.host_id].powered_on
                or h.host_id in include}
    return act.order_cap_changes(before, new_caps, reason=reason)
