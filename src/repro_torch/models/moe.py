"""Mixture-of-Experts layer (the reference's ``repro.models.moe``):
token-choice top-k routing, a sort-based dispatch into per-expert
capacity buckets, the expert FFN on kernel K7, and the gate-weighted
combine.

  router probs -> top-k -> flatten (token, k) -> stable sort by expert
  id -> slot = rank within the expert (past the capacity: dropped) ->
  scatter tokens into (E, cap, D) buckets -> K7 three times -> gather
  back, weight by gate, sum over k.

Two dispatches, as in the reference (``models/moe.py:52-73``).  The dense
one runs every expert in one process.  Under a sharding context
(:mod:`repro_torch.runtime.sharding`) whose ``expert`` axis has more than
one rank and divides ``n_experts``, and unless ``REPRO_MOE_DENSE`` is set,
the expert-parallel one runs: tokens are replicated over the expert axis,
each rank holds ``n_experts / n`` experts (:func:`expert_shard`), builds
buckets for its own experts, runs K7 on them, and one all-reduce sums the
ranks' outputs, the shared experts' ffn slices riding in the same sum.
Under autograd this needs Megatron's pair of functions: the sum is an
all-reduce forward and the identity backward
(:func:`repro_torch.runtime.sharding.sum_over`), and the replicated
inputs of each rank's part are the identity forward and an all-reduce of
their gradient backward (:func:`~repro_torch.runtime.sharding.copy_to`).
The rank's leaves are its :func:`expert_shard`, or its block under
:func:`repro_torch.launch.shardspecs.local_params`, which also splits the
router's expert columns: the dispatch then gathers the router whole (each
rank keeps its own columns' gradient, which every rank holds whole).
Attention's tensor parallelism over the same ``model`` axis composes with
it (OLMoE's cells): both read the replicated activations and sum their
outputs over the axis.  Under the dense dispatch, shared experts whose
ffn dim is split over ranks (``ffn``) run column- and row-split, their
output summed over the ranks.
Under a context whose batch axes have more than one rank and no expert
axis that qualifies, the dense dispatch routes each rank's shard of the
tokens as the whole batch would be routed: the reference's dense
dispatch sees the whole batch (GSPMD), so its capacity, drops and aux
loss are the whole batch's (:func:`_moe_ffn_dense`).  The expert-parallel
dispatch keeps the reference's per-shard routing (its ``shard_map``
routes each data shard alone and averages the aux loss over them).

The three expert products are K7
(:func:`repro_torch.kernels.moe_gmm.grouped_matmul`), where the reference
writes ``jnp.einsum("ecd,edf->ecf", ...)``: the same function, float32
sums cast to the input type.  Under autograd K7 differentiates through
its own Function (two more K7 launches a product), and the gradient
reaches the gates and the aux loss's router probabilities as the
reference's does.  The dispatch's gather of each token k times is
:class:`_TokenGather`, whose backward sums a token's k rows in a fixed
order (autograd's own index backward adds them with float atomics on
CUDA, in another order each run).

Under a ``torch.profiler`` session either dispatch records four spans
(:mod:`repro_torch.runtime.tracing`): ``repro_torch.moe.route`` (the
router and top-k), ``.moe.dispatch`` (the sort through the buckets'
scatter), ``.moe.experts`` (K7 three times and the SiLU) and
``.moe.combine`` (the gather, the unsort, the gate-weighted sum and the
shared experts), and two counters: ``repro_torch.moe.pairs_routed`` (the
(token, k) pairs routed to this process's experts) and
``.moe.pairs_kept`` (those within their expert's capacity), the latter
worked out from the per-expert counts only when the trace is collected.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import grouped_matmul
from repro_torch.runtime import tracing
from repro_torch.runtime.sharding import (all_reduce, copy_to,
                                          current_context, dims_coordinate,
                                          dims_size, entry_axes,
                                          gather_param, split_over, sum_over)


def moe_param_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": ((d, e), ("embed_p", "expert")),
        "w_gate": ((e, d, f), ("expert", "embed_p", None)),
        "w_up": ((e, d, f), ("expert", "embed_p", None)),
        "w_down": ((e, f, d), ("expert", None, "embed_p")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs.update({
            "shared_w_gate": ((d, fs), ("embed_p", "ffn")),
            "shared_w_up": ((d, fs), ("embed_p", "ffn")),
            "shared_w_down": ((fs, d), ("ffn", "embed_p")),
        })
    return specs


def expert_capacity(n_tokens: int, cfg) -> int:
    cap = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
              // cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0 .. n-1`` occurs in ``ids`` (int64).  Integer
    adds give the same result in any order; unlike ``torch.bincount`` the
    output's size is known, so the card is not waited for."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _router(params: dict, xt: torch.Tensor, cfg):
    """Router -> (probs (T, E) float32, normalized gates (T, k) float32,
    expert ids (T, k))."""
    logits = (xt @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, cfg.moe_top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def _aux(me: torch.Tensor, counts: torch.Tensor, n_pairs: int, cfg
         ) -> torch.Tensor:
    """The load-balancing aux loss, a float32 scalar, from the router's
    mean probabilities ``me`` and each expert's count of ``n_pairs``
    routed pairs."""
    return cfg.n_experts * torch.sum(me * (counts.float() / n_pairs))


def _route(params: dict, xt: torch.Tensor, cfg):
    """Router probs -> (normalized gates (T, k) float32, expert ids (T, k),
    the load-balancing aux loss of these T tokens, a float32 scalar)."""
    probs, gate_vals, expert_idx = _router(params, xt, cfg)
    aux = _aux(probs.mean(0), _counts(expert_idx.reshape(-1), cfg.n_experts),
               xt.shape[0] * cfg.moe_top_k, cfg)
    return gate_vals, expert_idx, aux


class _TokenGather(torch.autograd.Function):
    """``xt[token_of]`` for the first M (token, k) pairs in expert order
    (M = T k in the dense dispatch, each token k times); the gradient of
    token t is the sum of its k pairs' rows in pair order (``g[inv]`` is
    pair order, ``inv`` the inverse of the sort, a pair past the first M
    a zero row), a dense ``(T, k, D)`` sum over k: the same bits every
    run."""

    @staticmethod
    def forward(ctx, xt, token_of, inv, k: int):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xt[token_of]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        k, m = ctx.k, g.shape[0]
        if m < inv.shape[0]:
            g = torch.cat([g, g.new_zeros(1, g.shape[1])])
            inv = torch.clamp_max(inv, m)
        return (g[inv].reshape(inv.shape[0] // k, k, g.shape[1]).sum(1),
                None, None, None)


def _shared_experts(params: dict, xt: torch.Tensor) -> torch.Tensor:
    sh = F.silu(xt @ params["shared_w_gate"]) * (xt @ params["shared_w_up"])
    return sh @ params["shared_w_down"]


def _batch_dims(mesh, rules) -> tuple:
    """The batch's mesh dims larger than 1 (the data-parallel split)."""
    return tuple(a for a in entry_axes(rules.mesh_axes("batch", mesh))
                 if dims_size(mesh, (a,)) > 1)


def _expert_axis(cfg):
    """``(mesh, rules, axis)`` where the expert-parallel dispatch runs,
    else None."""
    ctx = current_context()
    if ctx is None or os.environ.get("REPRO_MOE_DENSE"):
        return None
    mesh, rules = ctx
    axes = entry_axes(rules.mesh_axes("expert", mesh))
    if not axes:
        return None
    n = dims_size(mesh, axes[:1])
    if n > 1 and cfg.n_experts % n == 0:
        return mesh, rules, axes[0]
    return None


def expert_shard(params: dict, cfg, index: int, n: int) -> dict:
    """Rank ``index`` of ``n``'s leaves of one MoE layer under expert
    parallelism: its ``n_experts / n`` experts, its ``1 / n`` slice of the
    shared experts' ffn dimension, the router whole (the reference's
    ``shard_map`` in_specs).  Views where the slice is contiguous."""
    e_loc = cfg.n_experts // n
    out = {"router": params["router"]}
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = params[name][index * e_loc:(index + 1) * e_loc]
    if cfg.n_shared_experts:
        f = params["shared_w_down"].shape[0] // n
        sl = slice(index * f, (index + 1) * f)
        out["shared_w_gate"] = params["shared_w_gate"][:, sl].contiguous()
        out["shared_w_up"] = params["shared_w_up"][:, sl].contiguous()
        out["shared_w_down"] = params["shared_w_down"][sl]
    return out


def moe_ffn(params: dict, x: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x.dtype, aux loss): the
    expert-parallel dispatch under a context with an expert axis (each
    rank's ``params`` its :func:`expert_shard`), else the dense one.
    Under a context whose batch axes have more than one rank, ``x`` is
    this rank's shard of the batch; the dense dispatch then routes as the
    whole batch does (:func:`_moe_ffn_dense`)."""
    ep = _expert_axis(cfg)
    if ep is not None:
        return _moe_ffn_expert_parallel(params, x, cfg, *ep)
    ctx = current_context()
    dims = () if ctx is None else _batch_dims(*ctx)
    return _moe_ffn_dense(params, x, cfg, (ctx[0], dims) if dims else None)


def _moe_ffn_expert_parallel(params: dict, x: torch.Tensor, cfg, mesh,
                             rules, ax: str
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's part of the reference's ``_moe_ffn_shard_map``
    (``models/moe.py:98-170``): route the rank's tokens (replicated over
    the expert axis), keep the pairs this rank's experts own, sort them
    stably (owned pairs first, in pair order: ROADMAP trap T1), take the
    first ``M = e_loc cap`` sorted positions into ``(e_loc, cap, D)``
    buckets, run K7 three times on the local experts, and combine the
    gated outputs in pair order, in float32; the shared experts' slice
    adds its part, one all-reduce over the expert axis sums the ranks'
    parts, and the aux loss is averaged over the batch axes (its
    gradient taken as each rank's own: the training step sums the ranks'
    gradients)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    n = dims_size(mesh, (ax,))
    e_loc = e // n
    shard = dims_coordinate(mesh, (ax,))
    xt = x.reshape(t, d)
    with tracing.span("repro_torch.moe.route"):
        if params["router"].shape[1] != e:
            params = dict(params, router=gather_param(
                params["router"], mesh, ((1, (ax,)),),
                replicated_grad=True))
        gate_vals, expert_idx, aux = _route(params, xt, cfg)

    with tracing.span("repro_torch.moe.dispatch"):
        cap = expert_capacity(t, cfg)
        flat_expert = expert_idx.reshape(-1)                     # (T*k,)
        local = torch.where(flat_expert // e_loc == shard,
                            flat_expert - shard * e_loc, e_loc)  # e_loc: drop
        order = torch.argsort(local, stable=True)
        sorted_local = local[order]
        counts = _counts(sorted_local, e_loc + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(t * k, device=x.device) - starts[sorted_local]
        m = min(e_loc * cap, t * k)
        # A local expert keeps its first ``cap`` pairs within the first M
        # sorted positions.
        tracing.count("repro_torch.moe.pairs_routed", counts[:e_loc])
        tracing.count("repro_torch.moe.pairs_kept", lambda: torch.minimum(
            counts[:e_loc], torch.clamp(m - starts[:e_loc], 0, cap)).sum())
        take = order[:m]
        le_m, rk_m = sorted_local[:m], rank[:m]
        keep_m = (le_m < e_loc) & (rk_m < cap)
        slot = torch.where(keep_m,
                           le_m * cap + torch.clamp_max(rk_m, cap - 1),
                           e_loc * cap)
        inv = torch.argsort(order, stable=True)

        xin = copy_to(xt, mesh, (ax,))
        gin = copy_to(gate_vals, mesh, (ax,))
        buckets = torch.zeros((e_loc * cap + 1, d), dtype=xt.dtype,
                              device=x.device)
        buckets.index_add_(0, slot, torch.where(
            keep_m[:, None], _TokenGather.apply(xin, take // k, inv, k),
            0.0))
        bk = buckets[:-1].reshape(e_loc, cap, d)

    with tracing.span("repro_torch.moe.experts"):
        h = F.silu(grouped_matmul(bk, params["w_gate"])) \
            * grouped_matmul(bk, params["w_up"])
        yb = grouped_matmul(h, params["w_down"]).reshape(e_loc * cap, d)

    with tracing.span("repro_torch.moe.combine"):
        # Back to pair order: a pair past the first M (foreign or over
        # capacity) reads the zero row at M.
        y_m = torch.cat([yb[torch.clamp_max(slot, e_loc * cap - 1)]
                         * keep_m[:, None], yb.new_zeros(1, d)])
        per_pair = y_m[torch.clamp_max(inv, m)].reshape(t, k, d)
        y = (per_pair.float() * gin.to(per_pair.dtype).float()[..., None]
             ).sum(1)
        if cfg.n_shared_experts:
            y = y + _shared_experts(params, xin).float()
        y = sum_over(y, mesh, (ax,)).to(x.dtype)

    batch = _batch_dims(mesh, rules)
    if batch:
        aux = sum_over(aux, mesh, batch, dims_size(mesh, batch))
    return y.reshape(b, s, d), aux


def _moe_ffn_dense(params: dict, x: torch.Tensor, cfg, dp=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x.dtype, aux loss).

    The reference's ``_moe_ffn_dense`` step by step.  Pairs past their
    expert's capacity add zeros to the expert's last slot (the
    reference's ``.at[slot].add``), so the scatter's result does not
    depend on the order of its adds.

    ``dp = (mesh, dims)``: data parallelism over the mesh ``dims``, ``x``
    this rank's contiguous shard of the batch, at its row-major position
    along ``dims``.  The reference's data parallelism routes the whole
    batch in one program, so the capacity, the drops and the aux loss are
    the whole batch's here too: one all-reduce gives every rank each
    rank's per-expert pair counts, a pair's place in its expert is the
    count of the ranks before it plus its place among the rank's own
    (the whole batch's stable sort), the capacity is the whole batch's,
    and the aux loss takes the router's mean probabilities summed over
    the ranks (:func:`~repro_torch.runtime.sharding.sum_over`: its
    gradient is this rank's part,
    which the training step sums over the ranks) and the summed counts.
    Each rank fills only its own pairs' rows of the ``(E, cap, D)``
    buckets; a row's expert output does not depend on the others.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    with tracing.span("repro_torch.moe.route"):
        if dp is None:
            gate_vals, expert_idx, aux = _route(params, xt, cfg)
        else:
            probs, gate_vals, expert_idx = _router(params, xt, cfg)

    # ---- dispatch: sort (token, k) pairs by expert ----------------------
    with tracing.span("repro_torch.moe.dispatch"):
        flat_expert = expert_idx.reshape(-1)                     # (T*k,)
        order = torch.argsort(flat_expert, stable=True)
        sorted_expert = flat_expert[order]
        counts = _counts(sorted_expert, e)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(t * k, device=x.device) - starts[sorted_expert]
        before = None
        if dp is None:
            cap = expert_capacity(t, cfg)
        else:
            mesh, dims = dp
            n, index = dims_size(mesh, dims), dims_coordinate(mesh, dims)
            table = counts.new_zeros(n, e)
            table[index] = counts
            all_reduce(table, mesh, dims)                        # (n, E)
            before = table[:index].sum(0)
            rank = rank + before[sorted_expert]
            cap = expert_capacity(t * n, cfg)
            me = sum_over(probs.sum(0), mesh, dims) / (t * n)
            aux = _aux(me, table.sum(0), t * n * k, cfg)
        # An expert keeps its pairs up to the room its capacity leaves
        # past the pairs of earlier ranks' shards.
        tracing.count("repro_torch.moe.pairs_routed", t * k)
        tracing.count("repro_torch.moe.pairs_kept", lambda: torch.clamp_max(
            counts, cap if before is None
            else torch.clamp_min(cap - before, 0)).sum())
        keep = rank < cap
        slot = sorted_expert * cap + torch.clamp_max(rank, cap - 1)
        token_of = order // k                                    # source token
        inv = torch.argsort(order, stable=True)                  # undo sort

        buckets = torch.zeros((e * cap, d), dtype=xt.dtype, device=x.device)
        buckets.index_add_(0, slot, torch.where(
            keep[:, None], _TokenGather.apply(xt, token_of, inv, k), 0.0))
        buckets = buckets.reshape(e, cap, d)

    # ---- expert FFN: kernel K7 three times ------------------------------
    with tracing.span("repro_torch.moe.experts"):
        h = F.silu(grouped_matmul(buckets, params["w_gate"])) \
            * grouped_matmul(buckets, params["w_up"])
        y_flat = grouped_matmul(h, params["w_down"]).reshape(e * cap, d)

    # ---- combine: gather, undo the sort, gate-weighted sum over k -------
    with tracing.span("repro_torch.moe.combine"):
        gathered = y_flat[slot] * keep[:, None]                  # (T*k, D)
        per_pair = gathered[inv].reshape(t, k, d)
        # The reference's einsum("tkd,tk->td") in x.dtype: float32
        # products and sums, rounded once.
        out = (per_pair.float()
               * gate_vals.to(per_pair.dtype).float()[..., None]
               ).sum(1).to(per_pair.dtype)

        if cfg.n_shared_experts:
            tp = split_over("ffn", params["shared_w_down"].shape[0],
                            cfg.d_ff * cfg.n_shared_experts)
            if tp is None:
                out = out + _shared_experts(params, xt)
            else:
                out = out + sum_over(_shared_experts(
                    params, copy_to(xt, tp[0], tp[1])), tp[0], tp[1])
    return out.reshape(b, s, d), aux
