"""Cluster snapshot datamodel: the fields the cap-only batched engine packs.

Capacity unit is MHz (paper convention).  Placement rules and budget trees
belong to later slices of the port: a snapshot may carry ``rules`` only so
that the engine can refuse it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

from repro_torch.core.power_model import HostPowerSpec


@dataclasses.dataclass
class VirtualMachine:
    vm_id: str
    vcpus: int = 1
    reservation: float = 0.0            # MHz, guaranteed
    limit: float = math.inf             # MHz, hard upper bound
    shares: Optional[float] = None      # default: 1000 per vCPU
    demand: float = 0.0                 # MHz the VM would consume uncontended
    mem_demand: float = 0.0             # MB
    host_id: Optional[str] = None
    powered_on: bool = True
    tags: frozenset = frozenset()

    def __post_init__(self) -> None:
        if self.shares is None:
            self.shares = 1000.0 * self.vcpus
        if self.limit < self.reservation:
            raise ValueError(f"{self.vm_id}: limit < reservation")


@dataclasses.dataclass
class Host:
    host_id: str
    spec: HostPowerSpec
    power_cap: float                    # Watts
    powered_on: bool = True


class ClusterSnapshot:
    """Hosts + VMs + the cluster power budget."""

    def __init__(self, hosts: Iterable[Host], vms: Iterable[VirtualMachine],
                 power_budget: float, rules: Optional[list] = None):
        self.hosts: dict[str, Host] = {h.host_id: h for h in hosts}
        self.vms: dict[str, VirtualMachine] = {v.vm_id: v for v in vms}
        self.power_budget = float(power_budget)
        self.rules = list(rules or [])
        for vm in self.vms.values():
            if vm.host_id is not None and vm.host_id not in self.hosts:
                raise ValueError(f"{vm.vm_id} placed on unknown host")
