"""Elastic resize: DPM-driven scale-down and scale-up by checkpoint and
restore (the reference's ``repro.runtime.elastic``).

When CloudPowerCap's DPM powers pods off (sustained low demand) or on (a
hot cluster), the training job resizes: the controller checkpoints,
builds the new mesh, restores every leaf onto the new layout, and the
job resumes.  The same path is the *failure* path: losing a pod is a
scale-down whose checkpoint is the last completed save.

One process a rank, and the world is the largest job: every rank of the
world calls :meth:`ElasticController.resize` at the same point.  Rank 0
saves while the others wait at a barrier; the new mesh spans the first
``to_pods x ranks_per_pod`` ranks, each of which restores the checkpoint
onto its own device and keeps its block of each leaf under the layout
``make_shardings`` gives.  A rank outside the new mesh gets no state and
waits, at the next resize's barrier, until a resize takes it back.  The
controller is synchronous and explicit: resize is a rare, heavyweight
transition, where no lost optimizer state and a reproducible data cursor
matter more than overlap.  A state split over the old mesh (tensor
parallelism, FSDP storage: ``resize(..., mesh=old_mesh)``) is gathered
whole first, so the checkpoint is the one-rank state's, and the new mesh
may take any layout: ZeRO-3 on two ranks resizes to one whole rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import (Checkpointer, map_leaves,
                                                 whole_state)
from repro_torch.runtime.sharding import barrier, rank, rank_device

PyTree = Any


@dataclasses.dataclass
class ResizeEvent:
    step: int
    from_pods: int
    to_pods: int
    reason: str                    # "dpm-poweroff" | "dpm-poweron" | "failure"


def _abstract(tree):
    """``tree`` with each tensor leaf a meta-device tensor of its shape
    and dtype (``requires_grad`` kept), other leaves as they are."""
    def meta(_, leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta"
                               ).requires_grad_(leaf.requires_grad)
        return leaf
    return map_leaves(meta, tree)


class ElasticController:
    """Owns the resize protocol.

    ``make_mesh(n_pods)`` (a collective: every rank calls it) and
    ``make_shardings(mesh, target)`` (a tree of specs of ``target``'s
    structure, :mod:`repro_torch.launch.shardspecs`) are injected so that
    the controller is independent of model and config.
    """

    def __init__(self, checkpointer: Checkpointer,
                 make_mesh: Callable[[int], Any],
                 make_shardings: Callable[[Any, PyTree], PyTree]):
        self.checkpointer = checkpointer
        self.make_mesh = make_mesh
        self.make_shardings = make_shardings
        self.history: list[ResizeEvent] = []
        self._target: Optional[PyTree] = None

    def _restore(self, step: int, mesh, target: PyTree) -> Optional[PyTree]:
        """The checkpoint's tree on this rank's device, each leaf its block
        under ``make_shardings``' layout; None outside ``mesh``."""
        if mesh.get_coordinate() is None:
            return None
        return self.checkpointer.restore(
            step, target, device=rank_device(),
            shardings=self.make_shardings(mesh, target), mesh=mesh)

    def resize(self, state: Optional[PyTree], step: int, from_pods: int,
               to_pods: int, reason: str,
               extra_metadata: Optional[dict] = None, mesh=None
               ) -> tuple[Any, Optional[PyTree]]:
        """Checkpoint -> new mesh -> restore onto it.  Every rank calls
        it; a rank outside the old mesh passes ``state=None``.  ``mesh``:
        the old mesh, where ``state`` is each rank's blocks under
        ``make_shardings(mesh, state)`` (every rank of it gathers the
        leaves whole first); None where each rank holds the whole state.
        Returns ``(new_mesh, new_state)``, the state None on a rank
        outside the new mesh."""
        if state is not None and mesh is not None:
            state = whole_state(state, self.make_shardings(mesh, state),
                                mesh)
        if state is not None:
            self._target = _abstract(state)
        if rank() == 0:
            if state is None:
                raise ValueError("rank 0 holds the state to save")
            self.checkpointer.save(step, state, extra_metadata)
        barrier()
        if self._target is None:
            raise RuntimeError("this rank has never held the state, so it "
                               "has no target to restore onto")
        mesh = self.make_mesh(to_pods)
        new_state = self._restore(step, mesh, self._target)
        self.history.append(ResizeEvent(step, from_pods, to_pods, reason))
        return mesh, new_state

    def recover(self, target: PyTree, to_pods: int, reason: str = "failure"
                ) -> tuple[Any, Optional[PyTree], int]:
        """Restart from the last completed checkpoint onto ``to_pods``
        (``target``: the state's structure, meta-device leaves will do).
        Every rank calls it."""
        step = self.checkpointer.latest_step()
        if step is None:
            raise RuntimeError("no checkpoint to recover from")
        self._target = _abstract(target)
        mesh = self.make_mesh(to_pods)
        state = self._restore(step, mesh, self._target)
        self.history.append(ResizeEvent(step, -1, to_pods, reason))
        return mesh, state, step
