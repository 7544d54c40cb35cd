"""CloudPowerCap host power model constants (paper Eqs. 1-4).

Only the static host description the cap-only engine packs; the Eq. 1/3/4
maps themselves run on tensors in :mod:`repro_torch.core.kernels`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HostPowerSpec:
    """Static power/capacity description of one host.

    ``capacity_peak`` is the capacity (MHz) at 100% utilization, uncapped;
    ``power_idle``/``power_peak`` the Watts at 0% and 100%;
    ``hypervisor_overhead`` Eq. 4's ``C_H``; ``memory_mb`` host memory.
    """

    capacity_peak: float
    power_idle: float
    power_peak: float
    hypervisor_overhead: float = 0.0
    memory_mb: float = 0.0

    def __post_init__(self) -> None:
        if self.power_peak <= self.power_idle:
            raise ValueError(
                f"power_peak ({self.power_peak}) must exceed power_idle "
                f"({self.power_idle})")
        if self.capacity_peak <= 0:
            raise ValueError("capacity_peak must be positive")


# Paper Table I server: 12 cores x 2.9 GHz = 34.8 GHz, 96 GB,
# peak 320 W, idle 160 W.
PAPER_HOST = HostPowerSpec(
    capacity_peak=34_800.0,       # MHz
    power_idle=160.0,
    power_peak=320.0,
    hypervisor_overhead=0.0,
    memory_mb=96 * 1024,
)
