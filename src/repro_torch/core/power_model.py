"""CloudPowerCap host power model (paper Eqs. 1-4).

The static host description, with the scalar maps the object plane reads
(a host's capped and managed capacity, the cap that supports a capacity).
The same maps over host columns, for the engines, are the tensor functions
in :mod:`repro_torch.core.kernels`.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

ArrayLike = Union[float, np.ndarray]


@dataclasses.dataclass(frozen=True)
class HostPowerSpec:
    """Static power/capacity description of one host.

    ``capacity_peak`` is the capacity (MHz) at 100% utilization, uncapped;
    ``power_idle``/``power_peak`` the Watts at 0% and 100%;
    ``power_nameplate`` the label power (deployment math only);
    ``hypervisor_overhead`` Eq. 4's ``C_H``; ``memory_mb`` host memory.
    """

    capacity_peak: float
    power_idle: float
    power_peak: float
    power_nameplate: float = 0.0
    hypervisor_overhead: float = 0.0
    memory_mb: float = 0.0

    def __post_init__(self) -> None:
        if self.power_peak <= self.power_idle:
            raise ValueError(
                f"power_peak ({self.power_peak}) must exceed power_idle "
                f"({self.power_idle})")
        if self.capacity_peak <= 0:
            raise ValueError("capacity_peak must be positive")

    def power_consumed(self, utilization: ArrayLike) -> ArrayLike:
        """Eq. 1: utilization -> consumed Watts."""
        u = np.clip(utilization, 0.0, 1.0)
        return self.power_idle + (self.power_peak - self.power_idle) * u

    def capped_capacity(self, power_cap: ArrayLike) -> ArrayLike:
        """Eq. 3: capacity reachable under ``power_cap`` Watts."""
        cap = np.clip(power_cap, self.power_idle, self.power_peak)
        frac = (cap - self.power_idle) / (self.power_peak - self.power_idle)
        return self.capacity_peak * frac

    def cap_for_capacity(self, capacity: ArrayLike) -> ArrayLike:
        """Eq. 3 inverted: the least cap that supports ``capacity``."""
        c = np.clip(capacity, 0.0, self.capacity_peak)
        return self.power_idle + (self.power_peak - self.power_idle) * (
            c / self.capacity_peak)

    def managed_capacity(self, power_cap: ArrayLike) -> ArrayLike:
        """Eq. 4: the capacity the resource manager may allocate."""
        return np.maximum(
            self.capped_capacity(power_cap) - self.hypervisor_overhead, 0.0)

    def cap_for_managed_capacity(self, capacity: ArrayLike) -> ArrayLike:
        return self.cap_for_capacity(
            np.asarray(capacity) + self.hypervisor_overhead)


# Paper Table I server: 12 cores x 2.9 GHz = 34.8 GHz, 96 GB,
# nameplate 400 W, peak 320 W, idle 160 W.
PAPER_HOST = HostPowerSpec(
    capacity_peak=34_800.0,       # MHz
    power_idle=160.0,
    power_peak=320.0,
    power_nameplate=400.0,
    hypervisor_overhead=0.0,
    memory_mb=96 * 1024,
)


# One NVIDIA H100 SXM per host: the serving path's replica host.
# capacity_peak is the card's dense bf16 tensor-core rate (989 TFLOP/s,
# NVIDIA's H100 SXM data sheet); power_peak is the card's power limit and
# power_idle its idle draw, both as nvidia-smi printed them on an
# "NVIDIA H100 80GB HBM3" with a 700.00 W limit (tools/h100_power.py);
# memory is the card's 80 GB.
H100_HOST = HostPowerSpec(
    capacity_peak=989e12,         # FLOP/s, bf16 dense
    power_idle=74.95,             # W, median of 10 idle samples
    power_peak=700.0,
    power_nameplate=700.0,
    hypervisor_overhead=0.0,
    memory_mb=80 * 1024,
)


def deployment_table(spec: HostPowerSpec, rack_budget_watts: float,
                     power_caps: list[float]) -> list[dict]:
    """Paper Table II: for each candidate per-host cap, how many hosts fit
    in the rack budget and the capacity and memory they give, each also
    as a ratio to the first row's."""
    rows = []
    base = None
    for cap in power_caps:
        count = int(rack_budget_watts // cap)
        total_capacity = count * float(spec.capped_capacity(cap))
        total_memory = count * spec.memory_mb
        if base is None:
            base = (total_capacity, total_memory)
        rows.append({
            "power_cap_w": cap,
            "host_count": count,
            "capacity": total_capacity,
            "capacity_ratio": total_capacity / base[0] if base[0] else 0.0,
            "memory_mb": total_memory,
            "memory_ratio": total_memory / base[1] if base[1] else 0.0,
        })
    return rows
