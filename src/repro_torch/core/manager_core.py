"""ManagerCore: the three-phase CloudPowerCap protocol, on the object plane.

One DRS invocation (default every 300 s) runs:

  Phase 1  Powercap Allocation      (paper Fig. 3)  constraint correction on
           a GetFlexiblePower clone, then RedivvyPowerCap.
  Phase 2  Powercap-based Balancing (paper Fig. 4)  BalancePowerCap first,
           residual imbalance fixed by DRS's migration balancer.
  Phase 3  Powercap Redistribution  (paper Fig. 5)  DPM power-on/off with
           budget funding / reabsorption.

The simulators call :meth:`ManagerCore.invoke` (through
:class:`repro_torch.core.manager.CloudPowerCapManager`) on snapshot clones
and execute the emitted :mod:`repro_torch.drs.actions` list.  The port
covers the cap-only regime: rules, the migration search and DPM raise
(ROADMAP queue 1, items 5 and 6); the migration balancer's own stopping
test runs, so an invocation whose search would stop in its first round
completes with the reference's default ``BalancerConfig``.
BalancePowerCap, the entitlement sums behind the invocation's notes and
the balancer's entitlement waterfill run on the manager's ``device``
(kernels K2, K3 and K1 on the GPU).

Baselines from the paper's evaluation (``Static``, ``StaticHigh``) run the
same pipeline with cap changes disabled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.backend import resolve_device
from repro_torch.core import balance as bal
from repro_torch.core import redivvy
from repro_torch.drs import actions as act
from repro_torch.drs import balancer, dpm, placement
from repro_torch.drs.snapshot import ClusterSnapshot


@dataclasses.dataclass
class InvocationResult:
    actions: list
    snapshot: ClusterSnapshot            # what-if end state
    migrations: int = 0
    cap_changes: int = 0
    notes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ManagerConfig:
    powercap_enabled: bool = True        # False => Static/StaticHigh baseline
    balance: bal.BalanceConfig = dataclasses.field(
        default_factory=bal.BalanceConfig)
    balancer: balancer.BalancerConfig = dataclasses.field(
        default_factory=balancer.BalancerConfig)
    dpm: dpm.DPMConfig = dataclasses.field(default_factory=dpm.DPMConfig)
    dpm_enabled: bool = True


class ManagerCore:
    """Drives one cluster; stateless between invocations except config.
    ``device=None`` runs its kernels on the GPU."""

    def __init__(self, config: Optional[ManagerConfig] = None, device=None):
        self.config = config or ManagerConfig()
        self.device = resolve_device(device)

    def invoke(self, snapshot: ClusterSnapshot, now: float = 0.0,
               low_since: Optional[dict] = None,
               last_config_change: float = -1e18,
               limits=None) -> InvocationResult:
        if limits is not None:
            raise NotImplementedError(
                "gated migration launches are not ported yet (ROADMAP "
                "queue 1, item 6)")
        actions: list[act.Action] = []
        notes: list[str] = []
        working = self._phase_allocation(snapshot, actions, notes)
        working = self._phase_balancing(working, actions, notes)
        working = self._phase_redistribution(working, now, low_since,
                                             last_config_change)
        assert working.tree_respected(), (
            "manager invocation left a budget-tree node over its limit")
        migrations = sum(1 for a in actions if a.kind == "migrate")
        cap_changes = sum(1 for a in actions if a.kind == "set_power_cap")
        return InvocationResult(actions=actions, snapshot=working,
                                migrations=migrations,
                                cap_changes=cap_changes, notes=notes)

    # ---------------- Phase 1: constraint correction ------------------
    def _phase_allocation(self, snapshot: ClusterSnapshot, actions: list,
                          notes: list) -> ClusterSnapshot:
        if self.config.powercap_enabled:
            flex = redivvy.get_flexible_power(snapshot)
            moves = placement.correct_constraints(
                flex, capacity_fn=redivvy.fundable_capacity)
            # Post-correction reserved floors (reservations moved with VMs).
            redivvy.set_reserved_floor_caps(flex)
            new_caps = redivvy.redivvy_power_cap(snapshot, flex)
            cap_actions = redivvy.emit_actions(snapshot, new_caps,
                                               reason="powercap-allocation")
            cap_ids = tuple(a.action_id for a in cap_actions)
            move_actions = [act.migrate(vm, dest, prereqs=cap_ids,
                                        reason="constraint-correction")
                            for vm, dest in moves]
            actions += cap_actions + move_actions
            working = flex
        else:
            working = snapshot.clone()
            moves = placement.correct_constraints(working)
            actions += [act.migrate(vm, dest, reason="constraint-correction")
                        for vm, dest in moves]
        if moves:
            notes.append(f"constraint-correction: {len(moves)} moves")
        return working

    # ---------------- Phase 2: entitlement balancing ------------------
    def _phase_balancing(self, working: ClusterSnapshot, actions: list,
                         notes: list) -> ClusterSnapshot:
        cfg = self.config
        if cfg.powercap_enabled:
            balanced, did = bal.balance_power_cap(working, cfg.balance,
                                                  device=self.device)
            if did:
                cap_actions = bal.emit_actions(working, balanced)
                actions += cap_actions
                notes.append(
                    f"powercap-balance: {len(cap_actions)} cap changes, "
                    f"imbalance {working.imbalance(self.device):.3f}->"
                    f"{balanced.imbalance(self.device):.3f}")
                working = balanced
        residual_moves = balancer.balance(working, cfg.balancer,
                                          device=self.device)
        if residual_moves:
            actions += [act.migrate(vm, dest, reason="entitlement-balance")
                        for vm, dest in residual_moves]
            notes.append(f"migration-balance: {len(residual_moves)} moves")
        return working

    # ---------------- Phase 3: DPM + redistribution -------------------
    def _phase_redistribution(self, working: ClusterSnapshot, now: float,
                              low_since: Optional[dict],
                              last_config_change: float) -> ClusterSnapshot:
        if self.config.dpm_enabled:
            # Not ported yet: run_dpm raises (ROADMAP queue 1, item 5).
            dpm.run_dpm(working, self.config.dpm, low_since=low_since,
                        now=now, last_config_change=last_config_change)
        return working
