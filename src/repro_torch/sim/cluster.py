"""Simulation configuration shared by every cell of a batch."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SimConfig:
    duration_s: float = 2100.0
    tick_s: float = 10.0
    drs_period_s: float = 300.0
    drs_first_at_s: float = 300.0
    # Scripted host lifecycle events ((t_s, host_id, powered_on), ...): a
    # later slice of the port replays them; the cap-only engine refuses them.
    power_events: tuple = ()
