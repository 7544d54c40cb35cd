"""The migration sweep families of the port against the JAX package's.

``sweep_grid_rules``'s and ``sweep_grid_timed``'s grids
(``benchmarks/run.py``: rules ``violation_burst`` and ``cap_blocked``;
churn ``timed_churn`` and ``failure_cascade`` with and without rules) cut
to 10-16 hosts, through both of the port's engines and both of the
reference's.  The reference's own vector and batched engines split on a
few cells (ROADMAP trap T5: hosts whose normalized entitlements or
utilizations tie to within a sum's rounding); everywhere else the port
equals them, counts exact, payload and energy to 1e-9, final placement,
power states and caps equal.
"""

import pytest
import torch

from test_torch_timed import _hold_family, rules_grid, timed_grid, x64  # noqa: F401


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_sweep_grid_rules_family_matches_reference(x64):
    split = _hold_family(rules_grid(16))
    # Where the reference splits: static cells whose hottest hosts
    # saturate (normalized entitlements 1.0 up to a sum's rounding).
    assert split and all(p == "static" for _, p in split)


def test_sweep_grid_timed_family_matches_reference(x64):
    split = _hold_family(timed_grid(10))
    assert all("failure_cascade" in name for name, _ in split)
