"""MigrationCore: constraint correction and the hill-climb balancer on the
object plane (sibling of :class:`repro_torch.core.manager_core.ManagerCore`).

One DRS invocation makes migrations in two places:

* *constraint correction* (phase 1): moves that fix affinity,
  anti-affinity and VM-host rule violations, with the fit check reading an
  injected capacity view -- the current cap, or the *fundable* capacity a
  host could reach if its cap were raised from the unreserved budget
  (paper Fig. 1a / Fig. 3);
* *entitlement balancing* (the residue of phase 2): DRS's greedy
  hill-climb, one risk-cost-benefit-filtered move at a time, after
  BalancePowerCap has removed what imbalance Watts can.

The decisions are the kernel functions of :mod:`repro_torch.core.kernels`
(``correct_constraints_slots``, ``balance_migrations``, ``move_slot``) on
the dense slot layout, the batched engine's own.  This module packs a
snapshot into a one-cell layout on the manager's device (the balancer's
waterfills are kernel K1 on the GPU), runs them, and replays the slot moves
onto the snapshot as ``(vm_id, dest_host)`` pairs, so every engine makes
the same moves.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels
from repro_torch.drs.arrays import RulesPack, dense_slot_assignment
from repro_torch.drs.snapshot import ClusterSnapshot


class _DenseCell:
    """One snapshot packed into the kernels' dense slot layout (S == 1),
    its columns on ``device``."""

    def __init__(self, snapshot: ClusterSnapshot, extra_slots: int,
                 pack: Optional[RulesPack] = None, device="cpu"):
        hosts = list(snapshot.hosts.values())
        self.host_ids = [h.host_id for h in hosts]
        n_hosts = len(hosts)
        vms, order, hj, slot, counts = dense_slot_assignment(snapshot,
                                                             n_hosts)
        n_slots = int(max(counts.max() if counts.size else 0, 1)
                      + max(extra_slots, 1))

        def col(vals, fill, dtype=np.float64, trailing=()):
            arr = np.full((1, n_hosts, n_slots) + trailing, fill,
                          dtype=dtype)
            arr[0, hj, slot] = np.asarray(vals)[order]
            return arr

        work = {
            "occ": col(np.ones(len(vms), dtype=bool), False, bool),
            "reservation": col([v.reservation for v in vms], 0.0),
            "limit": col([v.limit for v in vms], np.inf),
            "weights": col([max(v.shares, 1e-12) for v in vms], 1e-12),
            "migratable": col([v.migratable for v in vms], True, bool),
            "cpu": col([v.demand for v in vms], 0.0),
            "mem": col([v.mem_demand for v in vms], 0.0),
        }
        if pack is None:
            pack = _rules_pack(snapshot)
        self.rmeta = pack.meta()
        if pack.n_groups:
            work["aff_group"] = col(pack.affinity_group, -1, np.int64)
        if pack.n_vmhost:
            work["allowed"] = col(pack.allowed, True, bool,
                                  trailing=(n_hosts,))
        if pack.n_anti:
            work["anti"] = col(pack.anti_member.T, False, bool,
                               trailing=(pack.n_anti,))
        self._occ = work["occ"][0].copy()
        self.work = {k: torch.as_tensor(v, device=device)
                     for k, v in work.items()}

        def host_col(field, dtype=np.float64):
            return torch.as_tensor(np.array([[field(h) for h in hosts]],
                                            dtype=dtype), device=device)

        self.hosts = kernels.HostCols(
            on=host_col(lambda h: h.powered_on, bool),
            power_idle=host_col(lambda h: h.spec.power_idle),
            power_peak=host_col(lambda h: h.spec.power_peak),
            capacity_peak=host_col(lambda h: h.spec.capacity_peak),
            hyp_overhead=host_col(lambda h: h.spec.hypervisor_overhead))
        self.caps = host_col(lambda h: h.power_cap)
        self.host_mem = host_col(lambda h: h.spec.memory_mb)
        # Slot -> VM row, for replaying the kernels' moves on the snapshot.
        self._slot_vm = np.full((n_hosts, n_slots), -1, dtype=np.int64)
        self._slot_vm[hj, slot] = order
        self._vms = vms

    def replay(self, snapshot: ClusterSnapshot, moves: torch.Tensor,
               n_moves) -> list[tuple[str, str]]:
        """Apply the kernels' moves to the snapshot, each to its
        destination's first free slot as ``move_slot`` places it, so the
        slot coordinates stay aligned."""
        out: list[tuple[str, str]] = []
        for src, j, dst in moves[0, :int(n_moves[0])].tolist():
            row = int(self._slot_vm[src, j])
            ns = int(np.argmin(self._occ[dst]))
            self._slot_vm[dst, ns] = row
            self._slot_vm[src, j] = -1
            self._occ[dst, ns] = True
            self._occ[src, j] = False
            vm_id = self._vms[row].vm_id
            dest_host = self.host_ids[int(dst)]
            snapshot.move_vm(vm_id, dest_host)
            out.append((vm_id, dest_host))
        return out


class LaunchBudget:
    """An invocation's migration-launch ledger, shared by its phases.

    Made once an invocation when the cluster gates launches
    (:class:`repro_torch.core.kernels.MigrationLimits`) and threaded through
    constraint correction, then balancing, so both read one set of
    per-host endpoint counts and one cluster total, as the batched engine
    carries them between its two kernel calls.  Host order is the
    snapshot's.  Evacuations are exempt and never read it.
    """

    def __init__(self, limits: kernels.MigrationLimits, n_hosts: int,
                 device="cpu"):
        self.limits = limits
        self.launch_h = torch.zeros((1, n_hosts), dtype=torch.int64,
                                    device=device)
        self.launch_n = torch.zeros(1, dtype=torch.int64, device=device)

    @property
    def launch(self):
        return self.launch_h, self.launch_n

    def update(self, launch) -> None:
        self.launch_h, self.launch_n = launch


class MigrationCore:
    """Drives the migration protocol for one snapshot on ``device``
    (``None``: the GPU)."""

    def __init__(self, params: Optional[kernels.MigrationParams] = None,
                 device=None):
        self.params = params or kernels.MigrationParams()
        self.device = resolve_device(device)

    def _moves_buffer(self, bound: int):
        return (torch.full((1, max(bound, 1), 3), -1, dtype=torch.int64,
                           device=self.device),
                torch.zeros(1, dtype=torch.int64, device=self.device))

    def _gates(self, budget: Optional[LaunchBudget]):
        if budget is None:
            return kernels.MigrationLimits(), None
        return budget.limits, budget.launch

    def correct(self, snapshot: ClusterSnapshot,
                capacity_fn: Callable[[ClusterSnapshot, str], float],
                budget: Optional[LaunchBudget] = None
                ) -> list[tuple[str, str]]:
        """Constraint correction: fix rule violations in ``snapshot`` (in
        place) and return the ``(vm_id, dest_host)`` moves; ``budget``
        gates the launches when the cluster does."""
        pack = _rules_pack(snapshot)
        meta = pack.meta()
        if not meta.any:
            return []
        # Every correction may land on one host (several groups anchored on
        # the fullest): the full move bound of headroom keeps the slot axis
        # from binding a decision.
        cell = _DenseCell(snapshot, extra_slots=max(meta.move_bound, 1),
                          pack=pack, device=self.device)
        capacity = torch.as_tensor(
            [[capacity_fn(snapshot, hid) if snapshot.hosts[hid].powered_on
              else 0.0 for hid in cell.host_ids]], dtype=torch.float64,
            device=self.device)
        moves, n_moves = self._moves_buffer(meta.move_bound)
        limits, launch = self._gates(budget)
        _, moves, n_moves, pressure, launch = \
            kernels.correct_constraints_slots(
                cell.hosts, capacity, cell.work, cell.host_mem, cell.rmeta,
                torch.ones(1, dtype=torch.bool, device=self.device), moves,
                n_moves, limits=limits, launch=launch)
        _check_pressure(pressure)
        if budget:
            budget.update(launch)
        return cell.replay(snapshot, moves.cpu(), n_moves.cpu())

    def balance(self, snapshot: ClusterSnapshot,
                budget: Optional[LaunchBudget] = None
                ) -> list[tuple[str, str]]:
        """Greedy hill-climb balancing: move VMs in ``snapshot`` (what-if)
        and return the moves."""
        if self.params.max_moves <= 0:
            return []
        cell = _DenseCell(snapshot, extra_slots=max(self.params.max_moves, 1),
                          device=self.device)
        moves, n_moves = self._moves_buffer(self.params.max_moves)
        limits, launch = self._gates(budget)
        _, moves, n_moves, pressure, launch = kernels.balance_migrations(
            cell.hosts, cell.caps, cell.work, cell.host_mem, self.params,
            cell.rmeta, torch.ones(1, dtype=torch.bool, device=self.device),
            moves, n_moves, limits=limits, launch=launch)
        _check_pressure(pressure)
        if budget:
            budget.update(launch)
        return cell.replay(snapshot, moves.cpu(), n_moves.cpu())


def _check_pressure(pressure: torch.Tensor) -> None:
    """The slot axis binding a decision is a sizing fault of the cell (the
    headroom above makes it unreachable): it fails loudly."""
    if bool(pressure.any()):
        raise RuntimeError(
            "slot capacity bound a migration decision on the object plane; "
            "dense-cell slot headroom undersized")


def _rules_pack(snapshot: ClusterSnapshot) -> RulesPack:
    """The snapshot's :class:`RulesPack`, VM and host rows in inventory
    order (the order :func:`dense_slot_assignment` enumerates)."""
    return RulesPack.from_rules(
        snapshot.rules, {v: i for i, v in enumerate(snapshot.vms)},
        {h: i for i, h in enumerate(snapshot.hosts)})
