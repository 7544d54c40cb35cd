"""Carry a scenario grid packed by the JAX reference over to the port.

For this system the "weights" are the packed scenario arrays: the
reference's ``BatchedSimulator`` packs its cells into a dict of NumPy
arrays (``_arrays``) plus a static spec (``_static``) that shapes the
program.  :func:`from_reference_pack` builds the port's simulator over
the very same bytes, so both engines can run identical inputs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.kernels import BalanceParams
from repro_torch.sim.batch import BatchedSimulator, BatchUnsupported


def from_reference_pack(arrays: dict, static, device=None,
                        ) -> BatchedSimulator:
    """A port ``BatchedSimulator`` over a reference pack.

    ``arrays`` is the reference simulator's ``_arrays``; ``static`` its
    ``_static``, of which the fields ``tick_s``, ``waterfill_iters``,
    ``balance``, ``keep_timeseries`` and ``n_tags`` are read (the others
    shape regimes the cap-only port refuses).  Cells are named ``cell{i}``
    and tags ``tag{g}`` in the reference's (sorted) tag order; a cell has
    a window when any tick falls inside it.
    """
    if static.churn or static.n_tree_nodes:
        raise BatchUnsupported(
            "the reference pack is in the dynamic regime or carries a "
            "budget tree; the port replays the cap-only regime only")
    n_cells = arrays["on"].shape[0]
    return BatchedSimulator.from_pack(
        arrays, names=[f"cell{i}" for i in range(n_cells)],
        tag_names=[f"tag{g}" for g in range(static.n_tags)],
        has_window=np.asarray(arrays["win_mask"]).any(axis=0),
        tick_s=static.tick_s,
        balance=BalanceParams(**static.balance._asdict()),
        waterfill_iters=static.waterfill_iters,
        keep_timeseries=static.keep_timeseries, device=device)
