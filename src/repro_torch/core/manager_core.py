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
and execute the emitted :mod:`repro_torch.drs.actions` list, with its
prerequisite edges (decreases before the increases they fund, funding
before a power-on, evacuations before a power-off).  The migration
decisions of phases 1 and 2 -- constraint correction and the hill-climb
balancer -- are :class:`repro_torch.core.migration_core.MigrationCore`'s;
with gated launches both share one
:class:`~repro_torch.core.migration_core.LaunchBudget` an invocation.
BalancePowerCap, the entitlement sums behind the invocation's notes and
the migration layer's waterfills run on the manager's ``device``
(kernels K2, K3 and K1 on the GPU).

Baselines from the paper's evaluation (``Static``, ``StaticHigh``) run the
same pipeline with cap changes disabled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.backend import resolve_device
from repro_torch.core import balance as bal
from repro_torch.core import redistribute as redist
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
        """``limits`` (:class:`repro_torch.core.kernels.MigrationLimits`)
        gates the migrations correction and balancing may launch this
        invocation, from one shared ledger; evacuations (phase 3) are
        exempt."""
        actions: list[act.Action] = []
        notes: list[str] = []
        budget = None
        if limits is not None and limits.gated:
            from repro_torch.core.migration_core import LaunchBudget
            budget = LaunchBudget(limits, len(snapshot.hosts), self.device)
        working = self._phase_allocation(snapshot, actions, notes, budget)
        working = self._phase_balancing(working, actions, notes, budget)
        working = self._phase_redistribution(working, actions, notes, now,
                                             low_since, last_config_change)
        # Every phase projects or scopes its own caps, so the tree holds on
        # the state the invocation hands back (a powering-on candidate's
        # grant counts through its already-set cap).
        assert working.tree_respected(), (
            "manager invocation left a budget-tree node over its limit")
        migrations = sum(1 for a in actions if a.kind == "migrate")
        cap_changes = sum(1 for a in actions if a.kind == "set_power_cap")
        return InvocationResult(actions=actions, snapshot=working,
                                migrations=migrations,
                                cap_changes=cap_changes, notes=notes)

    # ---------------- Phase 1: constraint correction ------------------
    def _phase_allocation(self, snapshot: ClusterSnapshot, actions: list,
                          notes: list, budget=None) -> ClusterSnapshot:
        if self.config.powercap_enabled:
            flex = redivvy.get_flexible_power(snapshot)
            moves = placement.correct_constraints(
                flex, capacity_fn=redivvy.fundable_capacity, budget=budget,
                device=self.device)
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
            moves = placement.correct_constraints(working, budget=budget,
                                                  device=self.device)
            actions += [act.migrate(vm, dest, reason="constraint-correction")
                        for vm, dest in moves]
        if moves:
            notes.append(f"constraint-correction: {len(moves)} moves")
        return working

    # ---------------- Phase 2: entitlement balancing ------------------
    def _phase_balancing(self, working: ClusterSnapshot, actions: list,
                         notes: list, budget=None) -> ClusterSnapshot:
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
        residual_moves = balancer.balance(working, cfg.balancer, budget,
                                          device=self.device)
        if residual_moves:
            actions += [act.migrate(vm, dest, reason="entitlement-balance")
                        for vm, dest in residual_moves]
            notes.append(f"migration-balance: {len(residual_moves)} moves")
        return working

    # ---------------- Phase 3: DPM + redistribution -------------------
    def _phase_redistribution(self, working: ClusterSnapshot, actions: list,
                              notes: list, now: float,
                              low_since: Optional[dict],
                              last_config_change: float) -> ClusterSnapshot:
        cfg = self.config
        if not cfg.dpm_enabled:
            return working
        rec = dpm.run_dpm(working, cfg.dpm, low_since=low_since, now=now,
                          last_config_change=last_config_change)
        if rec.power_on is not None and cfg.powercap_enabled:
            funded, granted = redist.redistribute_for_power_on(
                working, rec.power_on, cfg.dpm)
            spec = working.hosts[rec.power_on].spec
            if spec.managed_capacity(granted) <= 0.0:
                notes.append(
                    f"dpm power-on {rec.power_on} infeasible: "
                    f"only {granted:.0f} W available")
            else:
                # The candidate's funded cap is an action like any other,
                # after the decreases that fund it: the host comes up with
                # its grant applied.
                cap_actions = redist.emit_actions(
                    working, funded, reason="powercap-poweron",
                    include=(rec.power_on,))
                pon = act.power_on(
                    rec.power_on,
                    prereqs=tuple(a.action_id for a in cap_actions),
                    reason="dpm")
                actions += cap_actions + [pon]
                working = funded
                working.hosts[rec.power_on].powered_on = True
                notes.append(f"dpm power-on {rec.power_on} "
                             f"granted {granted:.0f} W")
        elif rec.power_on is not None:
            actions.append(act.power_on(rec.power_on, reason="dpm"))
            notes.append(f"dpm power-on {rec.power_on}")
            working.hosts[rec.power_on].powered_on = True
        elif rec.power_off is not None:
            evac = [act.migrate(vm, dest, reason="dpm-evacuate")
                    for vm, dest in rec.evacuations]
            for vm, dest in rec.evacuations:
                working.move_vm(vm, dest)
            poff = act.power_off(
                rec.power_off,
                prereqs=tuple(a.action_id for a in evac), reason="dpm")
            actions += evac + [poff]
            if cfg.powercap_enabled:
                redistributed = redist.redistribute_after_power_off(
                    working, rec.power_off)
                cap_actions = redist.emit_actions(
                    working, redistributed, reason="powercap-poweroff")
                for a in cap_actions:
                    a.prereqs = a.prereqs + (poff.action_id,)
                actions += cap_actions
                working = redistributed
            else:
                working.hosts[rec.power_off].powered_on = False
            notes.append(
                f"dpm power-off {rec.power_off} "
                f"({len(rec.evacuations)} evacuations)")
        return working
