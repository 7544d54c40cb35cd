"""Greedy hill-climbing entitlement balancing (paper Sec. IV-A).

DRS lowers the stddev of the hosts' normalized entitlements by migrating
VMs, one greedy move at a time, each through a risk-cost-benefit filter.
CloudPowerCap's BalancePowerCap (:mod:`repro_torch.core.balance`) runs
first and removes what imbalance Watts can; the residue is fixed here.

The search is :func:`repro_torch.core.kernels.balance_migrations` (argmax
scores of candidate moves on the dense slot layout, rule-aware admission,
closed-form imbalance scoring), run for a snapshot through
:class:`repro_torch.core.migration_core.MigrationCore`, so the vector and
the batched engines pick the same moves.  Its entitlement waterfills are
kernel K1 on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import kernels


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

    def params(self) -> kernels.MigrationParams:
        """The kernels' twin of this configuration."""
        return kernels.MigrationParams(
            imbalance_threshold=self.imbalance_threshold,
            max_moves=self.max_moves, min_goodness=self.min_goodness,
            cost_per_gb=self.cost_per_gb,
            contention_threshold=self.contention_threshold)


def balance(snapshot, config: Optional[BalancerConfig] = None,
            budget=None, device=None) -> list[tuple[str, str]]:
    """Move VMs in ``snapshot`` (what-if) and return the moves.  ``budget``
    is the invocation's shared
    :class:`~repro_torch.core.migration_core.LaunchBudget` when launches
    are gated (the correction's launches count against it); the search runs
    on ``device`` (``None``: the GPU)."""
    config = config or BalancerConfig()
    if config.max_moves <= 0:
        return []
    from repro_torch.core.migration_core import MigrationCore
    return MigrationCore(config.params(), device).balance(snapshot, budget)
