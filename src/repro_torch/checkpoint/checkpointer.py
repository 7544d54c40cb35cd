"""Checkpointing in the reference's format (``repro.checkpoint``).

One ``.npz`` per checkpoint step holds every leaf by its tree path, plus a
JSON sidecar (step, data-pipeline cursor, completion marker).  The paths
are the ones the reference's ``_path_str`` gives the same train state
(``0/blocks/wq`` for a parameter, ``1/0/...`` and ``1/1/...`` for the
moments, ``1/2`` for the count, ``2`` for the step, ``3/...`` for the
compression residual), so a checkpoint written by either package restores
in the other.  bfloat16 leaves are stored as the reference stores them
(NumPy's 2-byte void type, ``|V2``, the bits of ``ml_dtypes.bfloat16``)
and read back through an int16 view, bit for bit.

Writes are atomic (tmp + rename, marker last) and can run on a background
thread (``save_async``); ``wait`` joins the write in flight.

A state split over ranks (tensor parallelism, FSDP storage: each rank's
blocks under :mod:`repro_torch.launch.shardspecs`' specs) is saved whole:
every rank of the mesh calls :meth:`Checkpointer.save` with its blocks
and the specs, the leaves are gathered whole (:func:`whole_state`), and
rank 0 writes the same bytes a one-rank save of the whole state writes.
:meth:`Checkpointer.restore` with specs gives each rank its block under
any layout.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import OptState
from repro_torch.runtime.sharding import gather_whole, local_shard, rank
from repro_torch.runtime.train_loop import TrainState

BF16_STORED = np.dtype("V2")


def _children(node) -> Optional[list]:
    """A node's ``(name, child)`` pairs in the reference's tree layout, or
    None for a leaf."""
    if isinstance(node, TrainState):
        return [("0", node.params), ("1", node.opt_state), ("2", node.step),
                ("3", node.compress_residual)]
    if isinstance(node, OptState):
        return [("0", node.m), ("1", node.v), ("2", node.count)]
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``path -> leaf`` (None subtrees have no leaves, as in JAX)."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for name, child in kids:
        if child is not None:
            out.update(_flatten(child, f"{prefix}/{name}" if prefix
                                else name))
    return out


def map_leaves(fn, tree, prefix: str = ""):
    """``tree`` with each leaf ``x`` at path ``p`` replaced by ``fn(p,
    x)`` (None subtrees stay None)."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = {name: None if child is None else
           map_leaves(fn, child, f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if isinstance(tree, TrainState):
        return TrainState(params=out["0"], opt_state=out["1"],
                          step=out["2"], compress_residual=out["3"])
    if isinstance(tree, OptState):
        return OptState(m=out["0"], v=out["1"], count=out["2"])
    return {k: out[str(k)] for k in tree}


def whole_state(tree, shardings, mesh):
    """``tree`` of this rank's blocks with every leaf gathered whole under
    ``shardings`` (a tree of specs of its structure) on ``mesh``: a
    collective that every rank of the mesh calls."""
    specs = _flatten(shardings)

    def whole(path, leaf):
        spec = specs.get(path, ())
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        return gather_whole(leaf.detach(), spec, mesh).requires_grad_(
            leaf.requires_grad)
    return map_leaves(whole, tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_STORED)
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == BF16_STORED or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra_metadata: Optional[dict] = None,
             shardings=None, mesh=None) -> Optional[str]:
        """Write ``tree``; with ``shardings`` and ``mesh``, ``tree`` is this
        rank's blocks: every rank of the mesh calls, the leaves are
        gathered whole, and rank 0 writes (the others return None)."""
        self.wait()
        if shardings is not None:
            tree = whole_state(tree, shardings, mesh)
            if rank() != 0:
                return None
        flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        return self._write(step, flat, extra_metadata or {})

    def save_async(self, step: int, tree,
                   extra_metadata: Optional[dict] = None) -> None:
        self.wait()
        # The device-to-host copy happens here (a consistent view);
        # serialization and disk I/O happen on the thread.
        flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        meta = dict(extra_metadata or {})
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, meta: dict) -> str:
        base = os.path.join(self.directory, f"step_{step:010d}")
        tmp = base + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, base + ".npz")
        meta = dict(meta, step=step, leaves=len(flat))
        with open(base + ".json.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(base + ".json.tmp", base + ".json")   # completion marker
        self._gc()
        return base + ".npz"

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory,
                                           f"step_{s:010d}{ext}"))
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name[len("step_"):-len(".json")])
                      for name in os.listdir(self.directory)
                      if name.endswith(".json") and name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self.directory,
                               f"step_{step:010d}.json")) as f:
            return json.load(f)

    def restore(self, step: int, target, device=None, shardings=None,
                mesh=None):
        """A tree of ``target``'s structure (whole shapes) from checkpoint
        ``step``: each tensor leaf in the dtype, on the device and with
        the ``requires_grad`` of ``target``'s leaf; an ``int`` leaf (the
        step) as an ``int``.  ``device`` puts every leaf there instead (a
        target of meta-device tensors needs it).  With ``shardings`` (a
        tree of specs) and ``mesh``, each leaf is this rank's block."""
        self.wait()
        data = np.load(os.path.join(self.directory,
                                    f"step_{step:010d}.npz"))
        specs = {} if shardings is None else _flatten(shardings)

        def build(path, node):
            arr = data[path]
            if isinstance(node, int):
                return int(arr)
            if arr.shape != tuple(node.shape):
                raise ValueError(f"{path}: checkpoint shape {arr.shape} "
                                 f"!= target {tuple(node.shape)}")
            t = _to_tensor(arr).to(dtype=node.dtype,
                                   device=device or node.device)
            if specs.get(path):
                t = local_shard(t, specs[path], mesh)
            return t.requires_grad_(node.requires_grad)

        return map_leaves(build, target)
