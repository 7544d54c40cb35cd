"""Logical-axis sharding: rules, context, and constraint helpers (the
reference's ``repro.runtime.sharding``).

Model code names tensor dimensions by *logical* axes; a launcher binds a
mesh and a rule table mapping logical names to mesh axes.  Outside a
bound context every annotation is a no-op, so the same model code runs in
the CPU tests, on one card and across ranks.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
a tensor dimension, each ``None`` (replicated), a mesh axis name, or a
tuple of them (one tensor dimension sharded over several mesh axes, the
first the slowest).  DTensor's placements list the other way round, one
entry a *mesh* dimension: :func:`to_placements` turns one into the
other.  A mesh is a ``DeviceMesh`` or a :class:`MeshAxes` (names and
sizes alone, for specs of meshes larger than the process group).

The collectives the port runs over a ``DeviceMesh``
(:func:`all_reduce`, :func:`all_gather`, :func:`all_gather_objects`,
:func:`barrier`) live here too, with this process's rank and device: the
meshes are built, and the ranks started, by
:mod:`repro_torch.launch.mesh`.  A collective takes the names of the
mesh dimensions to run over and passes tensors to the backend where they
lie: gloo takes CUDA tensors for ``all_reduce`` and ``all_gather`` and
moves them through host memory itself (checked on the H100 by
``chip_smoke.py``'s path ME).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class MeshAxes(NamedTuple):
    """A mesh's axis names and sizes, without ranks."""
    names: tuple
    sizes: tuple

    def size(self, name: str) -> int:
        return self.sizes[self.names.index(name)]


def axes_of(mesh) -> MeshAxes:
    """``mesh``'s names and sizes (a ``DeviceMesh`` or a ``MeshAxes``)."""
    if isinstance(mesh, MeshAxes):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return MeshAxes(names, tuple(mesh.size(i) for i in range(len(names))))


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical axis -> mesh axes (None = replicated)."""
    batch: tuple = ("pod", "data")       # data parallel (pods x hosts)
    seq: Optional[tuple] = None          # between-block activations' sequence
    inner_seq: Optional[tuple] = None    # sequence *inside* attention/MLP
    kv_seq: Optional[tuple] = None       # KV-cache sequence (long-context)
    heads: tuple = ("model",)            # attention heads / tensor parallel
    kv_heads: tuple = ("model",)
    ffn: tuple = ("model",)              # MLP hidden
    vocab: tuple = ("model",)
    expert: tuple = ("model",)           # MoE expert parallelism
    fsdp: Optional[tuple] = ("data",)    # parameter storage sharding
    embed: Optional[tuple] = None        # d_model activations
    embed_p: Optional[tuple] = ("data",) # d_model axis of *parameters* (FSDP)
    layer: Optional[tuple] = None        # stacked-layer axis of parameters

    def lookup(self, name: Optional[str]):
        if name is None:
            return None
        return getattr(self, name)

    def mesh_axes(self, name: Optional[str], mesh):
        """The mesh axes of logical ``name`` that ``mesh`` has: ``None``,
        one name, or a tuple of names."""
        axes = self.lookup(name)
        if axes is None:
            return None
        present = tuple(a for a in axes if a in axes_of(mesh).names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]


def entry_axes(entry) -> tuple:
    """A spec entry's mesh axes as a tuple (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_ctx", default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Rules):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_context() -> Optional[tuple]:
    """The bound ``(mesh, rules)``, or None."""
    return _CTX.get()


def logical_spec(*names: Optional[str]) -> Optional[tuple]:
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    return tuple(rules.mesh_axes(n, mesh) for n in names)


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dimension,
    ``Shard(d)`` where the spec puts tensor dimension ``d`` on it, else
    ``Replicate()``.  A tensor dimension over several mesh dimensions
    shards over them in mesh order, the first the slowest, as the spec's
    tuple entry does."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: d for d, entry in enumerate(spec) for a in entry_axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axes_of(mesh).names)


def shard(x, *names: Optional[str]):
    """Constrain a DTensor to the layout the logical ``names`` give it
    (a redistribution); a plain tensor, or any tensor outside a bound
    context, passes through unchanged."""
    from torch.distributed.tensor import DTensor

    spec = logical_spec(*names)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` on a
    ``DeviceMesh`` (``t`` itself where the spec replicates it)."""
    out = t
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = dims_size(mesh, axes) if axes else 1
        if n > 1:
            out = out.chunk(n, dim=d)[dims_coordinate(mesh, axes)]
    return out if out is t else out.contiguous()


# -------------------------------------------------------- ranks and collectives
#: This process's rank device, set by :func:`repro_torch.launch.mesh.spawn`
#: when it starts the rank.
_RANK_DEVICE: list = []


def world_size() -> int:
    """The current process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> torch.device:
    """The device :func:`repro_torch.launch.mesh.spawn` gave this rank."""
    if not _RANK_DEVICE:
        raise RuntimeError("not a rank started by repro_torch.launch.mesh"
                           ".spawn")
    return _RANK_DEVICE[0]


def dims_size(mesh, dims: Sequence[str]) -> int:
    """The number of ranks along ``dims`` of ``mesh``."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)


def dims_coordinate(mesh, dims: Sequence[str]) -> int:
    """This rank's row-major position along ``dims`` (the first dim the
    slowest, as a ``PartitionSpec`` entry ``("pod", "data")`` orders its
    shards)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is outside the mesh")
    pos = 0
    for d in dims:
        i = mesh.mesh_dim_names.index(d)
        pos = pos * mesh.size(i) + coord[i]
    return pos


def all_reduce(t: torch.Tensor, mesh, dims: Sequence[str]) -> torch.Tensor:
    """Sum ``t`` in place over the mesh ``dims``: one ``all_reduce`` a dim
    larger than 1, in the order given, each rank ending with the same
    bits.  Returns ``t``."""
    for d in dims:
        if mesh.size(mesh.mesh_dim_names.index(d)) == 1:
            continue
        dist.all_reduce(t, group=mesh.get_group(d))
    return t


def all_gather(t: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` along the mesh ``dim``, in
    coordinate order, on ``t``'s device."""
    src = t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(mesh.size(mesh.mesh_dim_names.index(dim)))]
    dist.all_gather(parts, src, group=mesh.get_group(dim))
    return torch.stack(parts)


def barrier() -> None:
    """Wait for every rank of the world (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def all_gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, over the world (the
    sweep's per-cell results; ``[obj]`` without a process group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
