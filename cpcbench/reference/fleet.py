"""The fleet's plain reference: a replica host's capacity under its cap
(CloudPowerCap's Eqs. 3-4), the imbalance of the hosts' normalized
entitlements, and the router's weighted least-loaded dispatch.

``host`` is a traffic mix's ``host`` block: ``capacity_peak``,
``power_idle_w``, ``power_peak_w`` and ``vm_demand_fraction`` (one replica
VM a host, demanding that share of the host's peak capacity).
"""

from __future__ import annotations

import numpy as np


def managed_capacity(cap: float, host: dict) -> float:
    """Eq. 3 with no hypervisor overhead (Eq. 4): the capacity reachable
    under ``cap`` Watts."""
    idle, peak = host["power_idle_w"], host["power_peak_w"]
    frac = (np.clip(cap, idle, peak) - idle) / (peak - idle)
    return float(np.maximum(host["capacity_peak"] * frac - 0.0, 0.0))


def imbalance(caps: list, host: dict) -> float:
    """Population standard deviation over the hosts of entitlement over
    capacity, a host's one VM entitled to the least of its demand and the
    host's capacity."""
    demand = host["vm_demand_fraction"] * host["capacity_peak"]
    norm = []
    for cap in caps:
        c = managed_capacity(cap, host)
        norm.append(min(demand, c) / c if c > 0 else 0.0)
    return float(np.std(norm))


def route(capacities: list, n: int) -> list:
    """Requests a replica of ``n`` sent to idle replicas: each goes to the
    replica with the least ``(queue + 1) / capacity``, the first of equals,
    among those with capacity."""
    queue = [0] * len(capacities)
    for _ in range(n):
        live = [i for i, c in enumerate(capacities) if c > 0.0]
        if not live:
            raise RuntimeError("no replica has capacity")
        best = min(live, key=lambda i: (queue[i] + 1) / capacities[i])
        queue[best] += 1
    return queue
