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
lie: gloo takes CUDA tensors for ``all_reduce``, ``all_gather`` and
``reduce_scatter`` and moves them through host memory itself (checked on
the H100 by ``chip_smoke.py``'s paths ME, ST and TT), so no caller stages
a tensor through the host.

**Split layers** (tensor parallelism and FSDP storage).  Each rank holds
its block of every parameter under :func:`spec_for`'s layout
(:func:`repro_torch.launch.shardspecs.local_params`).  A parameter whose
``embed_p`` dim is sharded (FSDP) is gathered whole where it is used
(:func:`gather_param`: an all-gather forward, a reduce-scatter of its
gradient backward, the ZeRO-3 pair); a block's plan of those gathers is
:func:`gather_plan`.  A ``heads``, ``kv_heads``, ``ffn``, ``vocab`` or
``expert`` dim stays split, and the layer computes on its block with
Megatron's conjugate pair around it: :func:`copy_to` (the identity
forward, the sum of the ranks' gradients backward) where a replicated
activation enters the rank's block, and :func:`sum_over` (the sum
forward, the identity backward) where the ranks' partial outputs leave
it.  :func:`split_over` says whether, and
over which mesh dims, this rank holds a block of a logical axis.

**Split sequences** (Megatron-SP, the distributed flash-decode).  Under
``seq`` the between-block activations are each rank's block of the
sequence (:func:`seq_split`); a layer either computes on that block
(``inner_seq`` over the same dims: the odd-head archs' layout) or
gathers it whole at its entry and leaves by a reduce-scatter
(:func:`gather_seq` and :func:`scatter_seq`, the sequence's conjugate
pair, in place of ``copy_to`` and ``sum_over`` where the layer is split
over the same dims).  Under ``kv_seq`` a rank holds its block of the
decode cache's positions (:func:`kv_seq_split`).  A sum that decides a
greedy token (the split RMSNorm's, the decode's log-sum-exp combine)
adds the ranks' parts in rank order (:func:`sum_in_rank_order`).
Every collective's gradient adds in a fixed order: gloo's ring, no float
atomics (ROADMAP trap T1).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
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


def axis_size(mesh, entry) -> int:
    """The number of ranks along a spec ``entry``'s mesh axes."""
    m = axes_of(mesh)
    return math.prod(m.size(a) for a in entry_axes(entry))


def spec_for(mesh, rules: Rules, axes, shape=None) -> tuple:
    """Logical ``axes`` -> spec; ``shape`` (if given) drops the sharding
    of each dim that the mesh axes do not divide (it stays replicated: an
    odd vocabulary, kv heads that do not divide the model axis)."""
    entries = [rules.mesh_axes(a, mesh) for a in axes]
    if shape is not None:
        entries = [e if (e is None or shape[i] % axis_size(mesh, e) == 0)
                   else None for i, e in enumerate(entries)]
    return tuple(entries)


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


def all_reduce(t: torch.Tensor, mesh, dims: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the largest) ``t`` in place over the mesh
    ``dims``: one ``all_reduce`` a dim larger than 1, in the order given,
    each rank ending with the same bits.  Returns ``t``."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for d in dims:
        if mesh.size(mesh.mesh_dim_names.index(d)) == 1:
            continue
        dist.all_reduce(t, op=red, group=mesh.get_group(d))
    return t


def reduce_scatter(t: torch.Tensor, mesh, dim: str,
                   tensor_dim: int) -> torch.Tensor:
    """This rank's chunk (its coordinate along the mesh ``dim``) of the
    sum over ``dim``'s ranks of ``t``, chunked evenly along
    ``tensor_dim``."""
    n = mesh.size(mesh.mesh_dim_names.index(dim))
    parts = [c.contiguous() for c in t.chunk(n, dim=tensor_dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.get_group(dim))
    return out


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


# ------------------------------------------------------------ split layers
#: The logical axis that FSDP stores sharded and gathers on use.
FSDP_AXES = ("embed_p",)


def live_dims(mesh, entry) -> tuple:
    """A spec ``entry``'s mesh axes of more than one rank."""
    return tuple(a for a in entry_axes(entry) if axis_size(mesh, a) > 1)


@functools.lru_cache(maxsize=256)
def _axis_split(mesh, rules: Rules, name: str) -> Optional[tuple]:
    dims = live_dims(mesh, rules.mesh_axes(name, mesh))
    if not dims:
        return None
    return mesh, dims, dims_coordinate(mesh, dims), dims_size(mesh, dims)


def split_over(name: str, local: int, whole: int) -> Optional[tuple]:
    """``(mesh, dims, index, n)`` when this rank holds block ``index`` of
    ``n`` (``local`` of ``whole`` entries) of the logical axis ``name``
    over the mesh ``dims``; None when it holds the whole axis."""
    if local == whole:
        return None
    ctx = _CTX.get()
    split = None if ctx is None else _axis_split(*ctx, name)
    if split is None or local * split[3] != whole:
        raise ValueError(f"a block of {local} of the {whole} entries of "
                         f"{name!r}, and the bound context does not split "
                         f"{name!r} {whole // max(local, 1)} ways")
    return split


def _split_of(name: str) -> Optional[tuple]:
    ctx = _CTX.get()
    return None if ctx is None else _axis_split(*ctx, name)


def batch_split_dims() -> Optional[tuple]:
    """``(mesh, dims, index, n)`` of the batch's split in the bound context
    (its mesh dims larger than 1), or None."""
    return _split_of("batch")


def seq_split() -> Optional[tuple]:
    """``(mesh, dims, index, n)`` of the between-block sequence's split
    (logical ``seq``) in the bound context, or None: this rank holds block
    ``index`` of ``n`` of every activation's positions."""
    return _split_of("seq")


def inner_seq_split() -> Optional[tuple]:
    """:func:`seq_split` of the sequence inside attention and the MLP
    (logical ``inner_seq``)."""
    return _split_of("inner_seq")


def kv_seq_split() -> Optional[tuple]:
    """:func:`seq_split` of the decode cache's positions (logical
    ``kv_seq``): this rank holds block ``index`` of ``n`` of them."""
    return _split_of("kv_seq")


def check_seq_blocks(length: int, split: tuple, what: str) -> None:
    """``ValueError`` naming the dim ``what`` where the ranks of ``split``
    (:func:`seq_split`'s tuple) do not divide its ``length`` positions
    into whole blocks."""
    _, dims, _, n = split
    if length % n:
        raise ValueError(f"{what}: {length} positions do not split into "
                         f"{n} whole blocks over mesh dims {dims}")


class _CopyToRanks(torch.autograd.Function):
    """A tensor replicated over the ranks of mesh ``dims`` entering each
    rank's block of a split layer: the identity forward, the sum of the
    ranks' gradients backward (Megatron's ``f``), in float32 and rounded
    once to the gradient's type."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        whole = all_reduce(g.to(torch.float32, copy=True).contiguous(),
                           ctx.mesh, ctx.dims)
        return whole.to(g.dtype), None, None


class _SumOverRanks(torch.autograd.Function):
    """The sum of the ranks' parts over mesh ``dims``, divided by ``n``
    (the ranks' count: their mean; 1: their sum): an all-reduce forward;
    backward, each rank's part takes the gradient divided by ``n``
    (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, t, mesh, dims, n: int):
        ctx.n = n
        out = all_reduce(t.contiguous().clone(), mesh, dims)
        return out / n if n != 1 else out

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if ctx.n != 1 else g), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The whole sequence (``tensor_dim``) from the blocks of the ranks of
    mesh ``dims``: an all-gather forward; backward, each rank's block of
    the sum of the ranks' gradients (a reduce-scatter), summed in float32
    and rounded once to the gradient's type."""

    @staticmethod
    def forward(ctx, t, mesh, dims, tensor_dim: int):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, tensor_dim
        return gather_dims(t, mesh, dims, tensor_dim)

    @staticmethod
    def backward(ctx, g):
        out = scatter_dims(g.float().contiguous(), ctx.mesh, ctx.dims,
                           ctx.dim)
        return out.to(g.dtype), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """This rank's block (along ``tensor_dim``) of the sum of the ranks'
    whole partial tensors over mesh ``dims``: a reduce-scatter forward
    (summed in float32, rounded once to ``t``'s type); backward, the
    all-gather of the blocks' gradients (Megatron-SP's pair of
    :class:`_GatherSeq`)."""

    @staticmethod
    def forward(ctx, t, mesh, dims, tensor_dim: int):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, tensor_dim
        out = scatter_dims(t.float().contiguous(), mesh, dims, tensor_dim)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return gather_dims(g.contiguous(), ctx.mesh, ctx.dims, ctx.dim), \
            None, None, None


def gather_seq(t: torch.Tensor, mesh, dims: Sequence[str],
               tensor_dim: int = 1) -> torch.Tensor:
    """:class:`_GatherSeq`: all-gather forward, reduce-scatter backward."""
    return _GatherSeq.apply(t, mesh, tuple(dims), tensor_dim)


def scatter_seq(t: torch.Tensor, mesh, dims: Sequence[str],
                tensor_dim: int = 1) -> torch.Tensor:
    """:class:`_ScatterSeq`: reduce-scatter forward, all-gather backward."""
    return _ScatterSeq.apply(t, mesh, tuple(dims), tensor_dim)


def seq_block(t: torch.Tensor, split: tuple, tensor_dim: int = 1
              ) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole, a plain slice
    (its gradient is the block's, zero elsewhere: each rank's part of a
    sum over the ranks)."""
    _, _, index, n = split
    size = t.shape[tensor_dim] // n
    return t.narrow(tensor_dim, index * size, size)


def sum_in_rank_order(t: torch.Tensor, mesh, dims: Sequence[str]
                      ) -> torch.Tensor:
    """The sum over the ranks of mesh ``dims`` of ``t``, every rank's part
    gathered and added in rank order (the same bits on every rank, no
    reduction order left to the backend: ROADMAP trap T1)."""
    every = gather_dims(t[None], mesh, dims, 0)
    out = every[0]
    for part in every[1:]:
        out = out + part
    return out


def copy_to(t: torch.Tensor, mesh, dims: Sequence[str]) -> torch.Tensor:
    """:class:`_CopyToRanks`: identity forward, all-reduce backward."""
    return _CopyToRanks.apply(t, mesh, tuple(dims))


def sum_over(t: torch.Tensor, mesh, dims: Sequence[str], n: int = 1
             ) -> torch.Tensor:
    """:class:`_SumOverRanks`: all-reduce forward (over ``n``), identity
    backward."""
    return _SumOverRanks.apply(t, mesh, tuple(dims), n)


def gather_dims(t: torch.Tensor, mesh, dims: Sequence[str],
                tensor_dim: int) -> torch.Tensor:
    """The whole of ``t`` along ``tensor_dim`` from the blocks of the
    ranks of mesh ``dims`` (the first the slowest, as
    :func:`local_shard` cuts them): an all-gather a dim, the innermost
    first."""
    for d in reversed(tuple(dims)):
        if mesh.size(mesh.mesh_dim_names.index(d)) > 1:
            t = torch.cat(all_gather(t, mesh, d).unbind(0), dim=tensor_dim)
    return t


def scatter_dims(t: torch.Tensor, mesh, dims: Sequence[str],
                 tensor_dim: int) -> torch.Tensor:
    """This rank's block along ``tensor_dim`` of the sum of ``t`` over the
    ranks of mesh ``dims`` (the adjoint of :func:`gather_dims`): a
    reduce-scatter a dim, the outermost first."""
    for d in dims:
        if mesh.size(mesh.mesh_dim_names.index(d)) > 1:
            t = reduce_scatter(t, mesh, d, tensor_dim)
    return t


def _block_of(t: torch.Tensor, mesh, dims, tensor_dim: int) -> torch.Tensor:
    n = dims_size(mesh, dims)
    return t.chunk(n, dim=tensor_dim)[dims_coordinate(mesh, dims)]


class _GatherParam(torch.autograd.Function):
    """A parameter block gathered whole along its split dims, ``plan`` a
    tuple of ``(tensor dim, mesh dims)``.  Backward, the gradient's blocks
    are reduce-scattered back (the ranks' gradients summed: FSDP's
    ZeRO-3 pair), or, with ``replicated_grad``, each rank keeps its own
    block of a gradient every rank holds whole."""

    @staticmethod
    def forward(ctx, t, mesh, plan, replicated_grad: bool):
        ctx.mesh, ctx.plan, ctx.replicated = mesh, plan, replicated_grad
        for dim, dims in plan:
            t = gather_dims(t, mesh, dims, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for dim, dims in reversed(ctx.plan):
            g = (_block_of(g, ctx.mesh, dims, dim) if ctx.replicated
                 else scatter_dims(g, ctx.mesh, dims, dim))
        return g.contiguous(), None, None, None


def gather_param(t: torch.Tensor, mesh, plan: tuple,
                 replicated_grad: bool = False) -> torch.Tensor:
    """``t`` gathered whole along ``plan``'s ``(tensor dim, mesh dims)``
    (:class:`_GatherParam`); ``t`` itself for an empty plan."""
    if not plan:
        return t
    return _GatherParam.apply(t, mesh, tuple(plan), replicated_grad)


def leaf_gathers(mesh, rules: Rules, shape, axes) -> tuple:
    """The FSDP gathers of a whole leaf of ``shape`` and logical ``axes``:
    ``(tensor dim, mesh dims)`` for each dim of :data:`FSDP_AXES` that
    the layout shards over more than one rank."""
    spec = spec_for(mesh, rules, axes, shape)
    return tuple((d, live_dims(mesh, e)) for d, (a, e) in
                 enumerate(zip(axes, spec))
                 if a in FSDP_AXES and live_dims(mesh, e))


def gather_plan(specs: dict, mesh, rules: Rules) -> Optional[tuple]:
    """``(mesh, {leaf name: gathers})`` for a block of ``specs`` (name ->
    ``(whole shape, logical axes)``) under ``rules`` on ``mesh``, the
    leaves stored whole left out; None when nothing is to be gathered."""
    plan = {name: g for name, (shape, axes) in specs.items()
            if (g := leaf_gathers(mesh, rules, shape, axes))}
    return (mesh, plan) if plan else None


def gather_block(blk: dict, plan: Optional[tuple]) -> dict:
    """A block's leaves, each FSDP leaf gathered whole (:func:`gather_param`)
    as ``plan`` (:func:`gather_plan`) says; ``blk`` itself without one."""
    if plan is None:
        return blk
    mesh, leaves = plan
    return {name: gather_param(t, mesh, leaves[name]) if name in leaves
            else t for name, t in blk.items()}


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of a rank's block of a whole ``shape`` under ``spec``."""
    return tuple(n // (axis_size(mesh, spec[d]) if d < len(spec) else 1)
                 for d, n in enumerate(shape))


def gather_whole(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block under ``spec`` (the inverse
    of :func:`local_shard`; a collective over the spec's mesh dims)."""
    for d, entry in enumerate(spec):
        t = gather_dims(t, mesh, live_dims(mesh, entry), d)
    return t


def batch_block(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole batch ``t`` (dim 0) under the bound
    context's batch split; ``t`` itself without one, or where the split
    does not divide the batch (it stays replicated, as the specs' shape
    rule keeps it)."""
    split = batch_split_dims()
    if split is None or t.shape[0] % split[3]:
        return t
    _, _, index, n = split
    b = t.shape[0] // n
    return t[index * b:(index + 1) * b]


def batch_whole(t: torch.Tensor, whole: int) -> torch.Tensor:
    """The whole batch (dim 0, ``whole`` rows) from each rank's rows
    (:func:`batch_block`'s inverse)."""
    if t.shape[0] == whole:
        return t
    mesh, dims, _, _ = batch_split_dims()
    return gather_dims(t, mesh, dims, 0)


def vocab_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., V_local), this
    rank's block of the ``vocab`` entries (the whole of them: ``argmax``):
    the largest logit over every rank's block, ties to the lower global
    index, as ``lax.top_k`` orders them (ROADMAP trap T4).  One
    all-gather of each block's best value and index."""
    split = split_over("vocab", logits.shape[-1], vocab)
    if split is None:
        return torch.argmax(logits, -1)
    mesh, dims, index, _ = split
    local = torch.argmax(logits, -1, keepdim=True)
    best = torch.cat([logits.gather(-1, local).double(),
                      (local + index * logits.shape[-1]).double()], -1)
    every = gather_dims(best[..., None, :], mesh, dims, -2)  # (..., n, 2)
    # argmax takes the first of equal values: the lowest rank's block,
    # whose indices are the lowest.
    pick = torch.argmax(every[..., 0], -1, keepdim=True)
    return every[..., 1].gather(-1, pick)[..., 0].long()
