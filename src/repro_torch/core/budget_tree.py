"""Hierarchical power-budget trees.

A datacenter stacks budgets -- host -> rack -> row -> room -- and every
watt a host receives must fit under every limit on its root path.
:class:`BudgetTree` describes that hierarchy densely:

* ``parent`` -- ``(n_nodes,)`` parent index, the root at 0 with parent -1;
  parents precede children;
* ``limit`` -- ``(n_nodes,)`` Watts a node's subtree may hold;
* ``host_node`` -- ``(n_hosts,)`` node each host hangs off, in snapshot
  host order.

The constructor flattens it into an ancestor incidence matrix (``host x
node``), so every tree question is a masked reduction
(:mod:`repro_torch.core.kernels`' ``tree_*`` functions).  A trivial tree
(one node whose limit is at least the scalar budget) adds nothing to the
flat budget, and the engines skip the tree code for it, so flat
configurations stay bitwise the scalar protocol.  The reference is
``repro.core.budget_tree``; its per-node sums are NumPy ``bincount``s in
host order, and so are these.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.core import kernels

__all__ = ["BudgetTree"]


class BudgetTree:
    """Immutable budget hierarchy over the cluster's hosts (shared, never
    copied, across snapshot clones)."""

    def __init__(self, parent: Iterable[int], limit: Iterable[float],
                 host_node: Iterable[int]):
        self.parent = np.asarray(parent, dtype=np.int64)
        self.limit = np.asarray(limit, dtype=np.float64)
        self.host_node = np.asarray(host_node, dtype=np.int64)
        n = self.parent.shape[0]
        if n == 0:
            raise ValueError("budget tree needs at least a root node")
        if self.limit.shape != (n,):
            raise ValueError("parent/limit length mismatch")
        if self.parent[0] != -1:
            raise ValueError("node 0 must be the root (parent == -1)")
        if n > 1:
            kids = self.parent[1:]
            if np.any(kids < 0) or np.any(kids >= np.arange(1, n)):
                raise ValueError(
                    "parents must precede children (parent[i] in [0, i))")
        if np.any(self.limit < 0.0):
            raise ValueError("node limits must be non-negative")
        if self.host_node.size and (
                self.host_node.min() < 0 or self.host_node.max() >= n):
            raise ValueError("host_node references an unknown node")
        # Ancestor-or-self incidence, closed in one forward pass.
        anc = np.eye(n, dtype=bool)
        for m in range(1, n):
            anc[m] |= anc[self.parent[m]]
        self.host_anc = anc[self.host_node]                   # (H, N)
        self.depth = anc.sum(axis=1).astype(np.int64) - 1     # root 0
        ph, pn = np.nonzero(self.host_anc)
        self.pair_host = ph.astype(np.int64)
        self.pair_node = pn.astype(np.int64)

    # ------------------------------------------------------------ builders
    @classmethod
    def two_rows(cls, budget: float, n_hosts: int, row0_limit: float,
                 row1_limit: float | None = None) -> "BudgetTree":
        """Root and two rows; the first half of the hosts on row 0."""
        if row1_limit is None:
            row1_limit = float(budget)
        host_node = np.where(np.arange(n_hosts) < n_hosts // 2, 1, 2)
        return cls([-1, 0, 0], [float(budget), float(row0_limit),
                                float(row1_limit)], host_node)

    # ------------------------------------------------------------- queries
    @property
    def n_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_hosts(self) -> int:
        return int(self.host_node.shape[0])

    def is_trivial(self, budget: float) -> bool:
        """True when the tree adds nothing to the scalar budget."""
        return self.n_nodes == 1 and float(self.limit[0]) >= budget - 1e-9

    def cols(self, device="cpu") -> kernels.TreeCols:
        """The ``(S = 1, ...)`` kernel columns of this tree, on ``device``."""
        return kernels.TreeCols(
            *(torch.as_tensor(c[None], device=device)
              for c in (self.host_anc, self.limit, self.depth)))

    def node_sums(self, caps: np.ndarray, on: np.ndarray) -> np.ndarray:
        """Per-node subtree cap-sum (powered-off hosts add 0)."""
        caps_on = np.where(on, caps, 0.0)
        return np.bincount(self.pair_node, weights=caps_on[self.pair_host],
                           minlength=self.n_nodes)

    def headroom(self, caps: np.ndarray, on: np.ndarray) -> np.ndarray:
        """Per-node Watts left under the node limit."""
        return self.limit - self.node_sums(caps, on)

    def host_slack(self, caps: np.ndarray, on: np.ndarray) -> np.ndarray:
        """Per-host tightest headroom along the root path (may be < 0)."""
        out = np.full(self.n_hosts, np.inf)
        np.minimum.at(out, self.pair_host,
                      self.headroom(caps, on)[self.pair_node])
        return out

    def max_overshoot(self, caps: np.ndarray, on: np.ndarray) -> float:
        """Largest per-node limit violation in Watts (<= 0 when clean)."""
        return float(np.max(self.node_sums(caps, on) - self.limit))

    def project(self, caps: np.ndarray, on: np.ndarray,
                floors: np.ndarray | None = None) -> np.ndarray:
        """Caps scaled down until every node limit holds
        (:func:`repro_torch.core.kernels.tree_project_caps`)."""
        if floors is None:
            floors = np.zeros_like(caps)
        return kernels.tree_project_caps(
            self.cols(), *(torch.as_tensor(np.asarray(x)[None])
                           for x in (on, caps, floors)))[0].numpy()
