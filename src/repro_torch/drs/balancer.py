"""Greedy hill-climbing entitlement balancing by migration (paper
Sec. IV-A): its configuration, and the cap-only regime's early return.

The migration search itself is a later slice of the port (ROADMAP queue 1,
item 6): :func:`balance` with ``max_moves > 0`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BalancerConfig:
    imbalance_threshold: float = 0.05   # target stddev of N_h
    max_moves: int = 16                 # per invocation (paper: 5-min budget)
    min_goodness: float = 1e-3          # minimum imbalance reduction per move
    # Risk-cost-benefit: a move must reduce imbalance by at least
    # cost_per_gb * mem_demand_gb to be worth the vMotion.
    cost_per_gb: float = 2e-4
    # Migrations only pay off when some host strains against its capacity.
    contention_threshold: float = 0.9


def balance(snapshot, config: Optional[BalancerConfig] = None,
            budget=None) -> list[tuple[str, str]]:
    """The moves that balance ``snapshot``: none when ``max_moves <= 0``."""
    config = config or BalancerConfig()
    if config.max_moves <= 0:
        return []
    raise NotImplementedError(
        "migration balancing (max_moves > 0) is not ported yet "
        "(ROADMAP queue 1, item 6)")
