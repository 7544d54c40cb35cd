"""AdamW with a configurable state dtype (the reference's
``repro.optim.adamw``).

Updates are computed in float32, with the reference's clip, bias
correction and order of operations, and decay on leaves of two or more
dimensions only (so a stacked ``(n_layers, d)`` norm scale decays, as in
the reference).  Two departures, both for memory on one card: the update
runs in place on the parameters and moments (the reference returns new
trees), and a leaf is updated in slices of at most ``SLICE`` elements, so
its float32 temporaries stay small.  The step count, the clip scale and
the learning rate stay tensors on the device: an update reads nothing
back to the host.  On a rank's blocks of a split model the update is
elementwise on the blocks, and only the clip's norm is summed over the
ranks (:func:`global_norm`'s ``layout``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.runtime.sharding import all_reduce
from repro_torch.tree import leaves, map_tree

#: Elements a slice of the update touches at once.
SLICE = 1 << 24


@dataclasses.dataclass
class OptState:
    m: dict
    v: dict
    count: torch.Tensor           # int32 scalar on the parameters' device


def _slices(t: torch.Tensor, inplace: bool = False):
    """``t`` flat in slices of ``SLICE``; views of ``t`` when ``inplace``
    (which needs ``t`` contiguous)."""
    return (t.view(-1) if inplace else t.reshape(-1)).split(SLICE)


def global_norm(grads: dict, layout: Optional[tuple] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32 (a slice at
    a time).

    ``layout = (mesh, dims)``: ``grads`` are this rank's blocks, leaf
    ``i`` split over the mesh dims ``dims[i]`` (``()``: whole on every
    rank).  The squares are summed a group of leaves of equal dims at a
    time, in the tree's order, each group's sum all-reduced over its
    dims, and the groups added in a fixed order: a leaf stored whole
    counts once, and every rank gets the whole model's norm, bit for
    bit."""
    if layout is None:
        total = None
        for g in leaves(grads):
            for part in _slices(g):
                sq = part.float().square().sum()
                total = sq if total is None else total + sq
        return torch.sqrt(total)
    mesh, dims = layout
    groups: dict = {}
    for g, d in zip(leaves(grads), dims):
        for part in _slices(g):
            sq = part.float().square().sum()
            groups[d] = sq if d not in groups else groups[d] + sq
    total = None
    for d in sorted(groups):
        part = all_reduce(groups[d].clone(), mesh, d)
        total = part if total is None else total + part
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"

    def init(self, params: dict) -> OptState:
        dt = getattr(torch, self.state_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        device = leaves(params)[0].device
        return OptState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=device))

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, params: dict,
               grad_norm: Optional[torch.Tensor] = None
               ) -> tuple[dict, OptState]:
        """One step, in place on ``params``, ``state.m`` and ``state.v``;
        returns them with the count advanced.  ``grad_norm`` is the
        gradients' global norm when the caller has it already (on a
        rank's blocks, the whole model's: :func:`global_norm`'s
        ``layout``)."""
        scale = None
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(self.grad_clip_norm
                                / torch.clamp_min(gnorm, 1e-12), max=1.0)
        count = state.count + 1
        cf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.full_like(cf, self.b1), cf)
        b2c = 1.0 - torch.pow(torch.full_like(cf, self.b2), cf)
        lr = self._lr(count)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            decay = p.dim() >= 2
            for ps, gs, ms, vs in zip(_slices(p, True), _slices(g),
                                      _slices(m, True), _slices(v, True)):
                g32 = gs.float()
                if scale is not None:
                    g32 = g32 * scale
                m32 = self.b1 * ms.float() + (1 - self.b1) * g32
                v32 = self.b2 * vs.float() + (1 - self.b2) * g32 * g32
                step = (m32 / b1c) / (torch.sqrt(v32 / b2c) + self.eps)
                p32 = ps.float()
                if decay:
                    step = step + self.weight_decay * p32
                ps.copy_(p32 - lr * step)
                ms.copy_(m32)
                vs.copy_(v32)
        return params, OptState(m=state.m, v=state.v, count=count)
