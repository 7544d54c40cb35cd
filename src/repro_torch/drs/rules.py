"""Placement rules: affinity, anti-affinity and VM-host rules.

The paper's motivating scenarios (Fig. 1a) hinge on business rules whose
correction needs migrations that static power caps can block.  The
correction itself runs on the dense slot layout
(:func:`repro_torch.core.kernels.correct_constraints_slots`); these classes
state the rules and test a snapshot against them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AffinityRule:
    """All listed VMs must share one host."""
    vm_ids: tuple

    def violations(self, snapshot) -> list[str]:
        hosts = {snapshot.vms[v].host_id for v in self.vm_ids
                 if snapshot.vms[v].powered_on}
        return [f"affinity{self.vm_ids}"] if len(hosts) > 1 else []


@dataclasses.dataclass(frozen=True)
class AntiAffinityRule:
    """No two listed VMs may share a host."""
    vm_ids: tuple

    def violations(self, snapshot) -> list[str]:
        placed = [snapshot.vms[v].host_id for v in self.vm_ids
                  if snapshot.vms[v].powered_on]
        return ([f"anti-affinity{self.vm_ids}"]
                if len(placed) != len(set(placed)) else [])


@dataclasses.dataclass(frozen=True)
class VMHostRule:
    """A VM restricted to a set of hosts (e.g. storage visibility)."""
    vm_id: str
    allowed_hosts: frozenset

    def violations(self, snapshot) -> list[str]:
        vm = snapshot.vms[self.vm_id]
        if vm.powered_on and vm.host_id not in self.allowed_hosts:
            return [f"vm-host({self.vm_id})"]
        return []


def all_violations(snapshot) -> list[str]:
    out = []
    for rule in snapshot.rules:
        out.extend(rule.violations(snapshot))
    return out


def placement_allowed(snapshot, vm_id: str, host_id: str) -> bool:
    """Would placing ``vm_id`` on ``host_id`` keep its VM-host and
    anti-affinity rules?  Affinity rules are targets to correct toward: a
    move onto the rule mates' host is always allowed, and a move away is
    the caller's to check on the what-if snapshot."""
    for rule in snapshot.rules:
        if isinstance(rule, VMHostRule) and rule.vm_id == vm_id:
            if host_id not in rule.allowed_hosts:
                return False
        elif isinstance(rule, AntiAffinityRule) and vm_id in rule.vm_ids:
            for other in rule.vm_ids:
                if other != vm_id and snapshot.vms[other].host_id == host_id:
                    return False
    return True
