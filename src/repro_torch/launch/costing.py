"""Roofline cost extraction (the reference's ``repro.launch.costing``).

The reference walks a jaxpr; the port counts what a step dispatches.
:class:`CostCounter` is a ``TorchDispatchMode`` that applies the
reference's cost model (``jaxpr_cost``) to every aten op that reaches it:

  * **products** (``mm``, ``bmm``, ``addmm``, ``baddbmm`` and what
    ``linear``, ``matmul`` and ``einsum`` decompose to): ``2 * batch * m *
    n * k`` FLOPs, plus the bytes of their operands and result;
  * **free ops** (views, reshapes, transposes, slices, ``cat``, ``pad``,
    ``expand``, dtype casts, copies and the factories, the twins of the
    reference's ``broadcast_in_dim`` and ``iota``): nothing;
  * **gathers** (``index_select``, ``embedding``, ``gather``, indexing):
    the bytes of their output;
  * **in-place writes** (``index_put_``, ``scatter_add_``, ``index_add_``
    and ``copy_`` into a view, the decode cache's write): twice the bytes
    of the update;
  * **sorts** (``sort``, ``argsort``, ``topk``): their input and output
    bytes and ``n log2 n`` FLOPs;
  * everything else: one FLOP and one write an output element (a
    fusion-optimistic model: an elementwise chain writes each result once).

No trip count is needed: a Python loop, the microbatch loop, the SSD
scan's chunk loop and the recompute of ``torch.utils.checkpoint``'s
backward each dispatch every time they run, so the count is exact where
the reference multiplies a scan body by its length.

The reference's ``hlo_collective_bytes`` parses partitioned HLO, which the
port does not have: the same dispatch mode records the ``c10d`` ops that
:mod:`repro_torch.runtime.sharding` issues, each by the bytes of its result
(an all-reduce twice: a ring moves its result about twice a device, the
reference's wire factor), under the reference's keys.  They are this
rank's bytes, in the dtype each collective runs in: the reference's
``f32_as_bf16`` undoes an artefact of XLA's CPU backend that the port does
not have (it sums some partials in float32 on purpose).

:func:`cost_of` runs a function on stand-ins: tensors on PyTorch's ``meta``
device, which have shapes and no data, so that every kernel wrapper takes
its plain branch (:data:`repro_torch.backend.PLAIN_DEVICES`), nothing
launches and no kernel's work escapes the count.  The counter also follows
the bytes of the live tensors it sees (``Cost.peak_bytes``), the port's
estimate of a step's working set.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
             "dot", "vdot"}
#: The products that add a bias (the reference's separate ``add``).
_BIASED = {"addmm", "baddbmm", "addbmm", "addmv"}
#: Free ops whose outputs share their input's storage: not counted, not
#: tracked.
_VIEWS = {"view", "_unsafe_view", "alias", "as_strided", "t", "transpose",
          "permute", "expand", "unsqueeze", "squeeze", "select", "slice",
          "split", "split_with_sizes", "unbind", "diagonal", "detach",
          "_reshape_alias", "view_as_real", "view_as_complex", "sym_size",
          "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}
#: Free ops that allocate: concatenation and padding, dtype casts and
#: copies (the reference's ``convert_element_type``, ``copy``) and the
#: factories (``broadcast_in_dim``, ``iota``).
_ZERO_COST = {
    "cat", "stack", "constant_pad_nd", "_to_copy", "clone", "lift_fresh",
    "lift_fresh_copy", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "arange",
    "scalar_tensor", "zero_", "_local_scalar_dense"}
_GATHERS = {"index_select", "embedding", "gather", "index", "take",
            "_embedding_bag"}
_INPLACE_WRITES = {"index_put_", "index_put", "_index_put_impl_",
                   "scatter_add_", "scatter_add", "scatter_", "scatter",
                   "index_add_", "index_add", "index_copy_", "index_copy",
                   "scatter_reduce_", "scatter_reduce", "masked_scatter_",
                   "slice_scatter", "select_scatter"}
_SORTS = {"sort", "argsort", "topk"}

#: ``c10d`` ops by the reference's collective names.  An all-reduce's
#: result is its tensors, an all-gather's and a reduce-scatter's their
#: outputs, an all-to-all's its output.
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
}

#: Wire bytes a result byte (a ring all-reduce is a reduce-scatter and an
#: all-gather pass: about twice its result a device).
WIRE_FACTOR = {"all-reduce": 2}


def tensors_of(tree) -> list:
    """Every tensor in ``tree``: nested lists, tuples, dicts and dataclasses
    (a train state) of tensors and other values."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors_of(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name))]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    """A count: FLOPs and bytes, the products' share of them, the
    collectives' result bytes by kind (wire factor applied) and the peak of
    the live tensor bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    product_flops: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    def collective_bytes(self) -> dict:
        """The collectives' bytes by kind and their ``total``, the
        reference's ``hlo_collective_bytes`` keys."""
        coll = {k: int(v) for k, v in self.collectives.items()}
        coll["total"] = sum(coll.values())
        return coll


class CostCounter(TorchDispatchMode):
    """Counts the aten and ``c10d`` ops dispatched inside it (see the module
    docstring); :attr:`cost` holds the count.  Tensors given to
    :meth:`hold` count toward the live bytes from the start (a step's
    arguments)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict = {}
        self._live_bytes = 0

    # --------------------------------------------------------- live bytes
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        size = st.nbytes()
        self._live[key] = size
        self._live_bytes += size
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def hold(self, tree) -> int:
        """Count ``tree``'s tensors as live; returns their bytes."""
        before = self._live_bytes
        for t in tensors_of(tree):
            self._track(t)
        return self._live_bytes - before

    # -------------------------------------------------------------- counting
    def _count(self, func, args, kwargs, out) -> None:
        name, ns = func._opname, func.namespace
        c = self.cost
        if ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return
            # In-place collectives return their outputs (with a work
            # handle); the first argument is the result buffer.
            res = args[0] if args else None
            b = sum(nbytes(t) for t in tensors_of(res))
            c.collectives[kind] = (c.collectives.get(kind, 0)
                                   + b * WIRE_FACTOR.get(kind, 1))
            return
        if ns != "aten":
            return
        outs = tensors_of(out)
        out_b = sum(nbytes(t) for t in outs)
        if name in _PRODUCTS:
            a, b = _operands(name, args)
            f = _product_flops(name, a, b)
            c.product_flops += f
            c.flops += f
            c.bytes += nbytes(a) + nbytes(b) + out_b
            if name in _BIASED:
                c.flops += sum(t.numel() for t in outs)
                c.bytes += out_b
        elif name in _ZERO_COST:
            pass
        elif name in _GATHERS:
            c.bytes += out_b
        elif name in _INPLACE_WRITES:
            upd = _update_operand(name, args, kwargs)
            c.bytes += 2 * (nbytes(upd) if isinstance(upd, torch.Tensor)
                            else 0)
        elif name == "copy_":
            # A write into a view of a larger buffer (the decode cache's,
            # the optimizer's slices) is an in-place update; a copy of a
            # whole buffer is the reference's free ``copy``.
            dst, src = args[0], args[1]
            if _is_partial_view(dst):
                c.bytes += 2 * nbytes(src)
        elif name in _SORTS:
            c.bytes += sum(nbytes(t) for t in tensors_of(args[:1])) + out_b
            n = max(args[0].numel(), 2)
            c.flops += n * math.log2(n)
        else:
            c.bytes += out_b
            c.flops += sum(t.numel() for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or func._opname in _VIEWS:
            return out                  # no cost, no new storage
        self._count(func, args, kwargs, out)
        for t in tensors_of(out):
            self._track(t)
        return out


def _operands(name: str, args) -> tuple:
    """A product's two operands (after a biased product's bias)."""
    return (args[1], args[2]) if name in _BIASED else (args[0], args[1])


def _product_flops(name: str, a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dim() == 3:                          # (B, m, k) @ (B, k, n)
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mm", "addmm"):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("mv", "addmv"):
        return 2 * a.shape[0] * a.shape[1]
    return 2 * a.numel()                      # dot, vdot


def _update_operand(name: str, args, kwargs):
    if name in ("index_put_", "index_put", "_index_put_impl_"):
        return args[2]
    if name in ("slice_scatter", "select_scatter"):
        return args[1]
    if name == "masked_scatter_":
        return args[2]
    # scatter*(self, dim, index, src), index_add/copy(self, dim, index, src)
    return args[3] if len(args) > 3 else kwargs.get("src", args[-1])


def _is_partial_view(t: torch.Tensor) -> bool:
    return nbytes(t) < t.untyped_storage().nbytes()


# ------------------------------------------------------------ stand-ins
def stand_in(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``t``'s shape and dtype, requiring grad where
    ``t`` does."""
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"
                       ).requires_grad_(t.requires_grad)


def stand_ins(tree: Any) -> Any:
    """``tree`` (tensors in dicts, lists, tuples and dataclasses) with every
    tensor a :func:`stand_in`."""
    if isinstance(tree, torch.Tensor):
        return stand_in(tree)
    if isinstance(tree, dict):
        return {k: stand_ins(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stand_ins(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: stand_ins(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def count(fn, *args) -> Cost:
    """The :class:`Cost` of ``fn(*args)`` run on stand-ins of ``args``
    (real or ``meta`` tensors); the arguments count as live from the
    start."""
    meta = stand_ins(args)
    with CostCounter() as counter:
        counter.hold(meta)
        fn(*meta)
    return counter.cost


def cost_of(fn, *args) -> dict:
    """``{"flops", "bytes"}`` of ``fn(*args)`` (the reference's signature),
    counted on stand-ins: nothing launches."""
    c = count(fn, *args)
    return {"flops": c.flops, "bytes": c.bytes}
