"""Dense slot layout of a snapshot's VMs (host-side NumPy)."""

from __future__ import annotations

import numpy as np


def dense_slot_assignment(snapshot, n_hosts: int):
    """Group placed, powered-on VMs under their resident host.

    Returns ``(vms, order, hj, slot, counts)``: ``vms`` is the snapshot's VM
    list, ``order`` the indices of active VMs sorted stably by host, ``hj``
    and ``slot`` each active VM's (host, slot) coordinate in the dense
    ``(H, J)`` layout, and ``counts`` the per-host occupancy.  The same
    coordinates as the reference's packer, so both engines agree on every
    slot-ordered sum.
    """
    vms = list(snapshot.vms.values())
    host_idx = {hid: j for j, hid in enumerate(snapshot.hosts)}
    host_j = np.array([host_idx.get(v.host_id, -1) for v in vms],
                      dtype=np.int64)
    act = np.array([v.powered_on for v in vms], dtype=bool)
    act &= host_j >= 0
    order = np.nonzero(act)[0]
    hj = host_j[order]
    srt = np.argsort(hj, kind="stable")
    order, hj = order[srt], hj[srt]
    counts = np.bincount(hj, minlength=n_hosts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(hj.size) - np.repeat(starts, counts)
    return vms, order, hj, slot, counts
