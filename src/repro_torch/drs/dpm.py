"""Distributed Power Management (paper Sec. II-C, IV-D): its configuration.

DPM and Powercap Redistribution are a later slice of the port (ROADMAP
queue 1, item 5): :func:`run_dpm` raises.  The vector engine still tracks
each host's low-utilization band against :attr:`DPMConfig.low_util`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DPMConfig:
    high_util: float = 0.81        # power-on trigger
    low_util: float = 0.45         # power-off consideration band
    target_util: float = 0.45      # post-consolidation ceiling on targets
    stable_window_s: float = 300.0 # utilization must be low this long


@dataclasses.dataclass
class DPMRecommendation:
    power_on: Optional[str] = None
    power_off: Optional[str] = None
    evacuations: list = dataclasses.field(default_factory=list)  # (vm, dest)


def run_dpm(snapshot, config: DPMConfig, low_since=None, now: float = 0.0,
            last_config_change: float = -1e18) -> DPMRecommendation:
    raise NotImplementedError(
        "DPM is not ported yet (the dynamic regime is a later slice: "
        "ROADMAP queue 1, item 5)")
