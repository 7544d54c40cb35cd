"""Algorithm 2: BalancePowerCap -- powercap-based entitlement balancing.

Progressive filling toward max-min fairness: move Watts from the hosts
with the lowest normalized entitlement to those with the highest until the
imbalance drops below threshold or the physical cap ranges bind.  Donors
never drop below their VMs' reservations, recipients never pass their
peak, and transfers conserve the budget.

This is the object-plane adapter: the snapshot's VMs are packed into the
dense ``(1, H, J)`` slot layout (the batched engine's assignment, so
slot-ordered tie-breaks agree) and the whole loop runs as one call of
:func:`repro_torch.core.kernels.balance_caps` -- kernel K2 on the GPU, its
plain version on the CPU.  The reference takes the same lift under its
Pallas executor (``repro.core.balance._balance_caps_pallas``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels
from repro_torch.drs import actions as act
from repro_torch.drs.arrays import dense_slot_assignment
from repro_torch.drs.snapshot import ClusterSnapshot


@dataclasses.dataclass
class BalanceConfig:
    # Cap writes cost <1 ms, so powercap balancing can afford a much tighter
    # target than migration balancing.
    imbalance_threshold: float = 0.01
    max_iters: int = 64
    min_transfer: float = 1e-3      # capacity units; below this we stop

    def params(self) -> kernels.BalanceParams:
        return kernels.BalanceParams(
            imbalance_threshold=self.imbalance_threshold,
            max_iters=self.max_iters,
            min_transfer=self.min_transfer)


def balance_power_cap(snapshot: ClusterSnapshot,
                      config: BalanceConfig | None = None, device=None
                      ) -> tuple[ClusterSnapshot, bool]:
    """Returns (what-if snapshot with rebalanced caps, did-anything flag).
    The loop runs on ``device`` (``None``: the GPU)."""
    config = config or BalanceConfig()
    f = snapshot.clone()
    av = f.as_arrays(device)
    if int(av.host_on.sum()) < 2:
        # Nothing to balance between: skip the loop and its waterfills.
        return f, False
    new_caps, did = _balance_caps_dense(f, av, snapshot.power_budget,
                                        config, resolve_device(device))
    tree = snapshot.effective_tree()
    if tree is not None:
        # Budget trees: transfers conserve the cluster total but may push a
        # row past its limit; the balanced caps are scaled back under every
        # node, the reserved floors protected.
        hosts = av.host_cols()
        floor_caps = kernels.reserved_floor_caps(
            hosts, torch.from_numpy(av.cpu_reserved()[None]))
        new_caps = kernels.tree_project_caps(
            tree.cols(), hosts.on, torch.from_numpy(new_caps[None]),
            floor_caps)[0].numpy()
    av.write_caps(f, new_caps)
    if did:
        f.validate()
    return f, did


def _balance_caps_dense(snapshot, av, budget: float, config: BalanceConfig,
                        dev: torch.device) -> tuple[np.ndarray, bool]:
    """The loop over the dense ``(1, H, J)`` slot layout, one cell;
    returns ``(caps (H,), did)`` on the host."""
    floors, ceils, weights, _ = av.waterfill_cols()
    H = av.n_hosts
    _, order, hj, slot, counts = dense_slot_assignment(snapshot, H)
    J = max(int(counts.max()) if counts.size else 0, 1)
    fl = np.zeros((1, H, J))
    ce = np.zeros((1, H, J))
    w = np.full((1, H, J), 1e-12)
    active = np.zeros((1, H, J), dtype=bool)
    fl[0, hj, slot] = floors[order]
    ce[0, hj, slot] = ceils[order]
    w[0, hj, slot] = weights[order]
    active[0, hj, slot] = True

    def t(a):
        return torch.as_tensor(a, device=dev)

    caps, did = kernels.balance_caps(
        av.host_cols(dev), t(av.power_cap[None]),
        kernels.DenseCols(t(fl), t(ce), t(w), t(active)),
        t(av.cpu_reserved()[None]), t(np.array([budget])),
        t(np.array([True])), config.params())
    return caps[0].cpu().numpy(), bool(did[0])


def emit_actions(before: ClusterSnapshot, after: ClusterSnapshot
                 ) -> list[act.Action]:
    """Cap-decrease actions are prerequisites of the increases they fund."""
    new_caps = {h.host_id: h.power_cap for h in after.powered_on_hosts()}
    return act.order_cap_changes(before, new_caps, reason="powercap-balance")
