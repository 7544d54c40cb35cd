"""Mixture-of-Experts layer (the dense-dispatch part of
``repro.models.moe``): token-choice top-k routing, a sort-based dispatch
into per-expert capacity buckets, the expert FFN on kernel K7, and the
gate-weighted combine.

  router probs -> top-k -> flatten (token, k) -> stable sort by expert
  id -> slot = rank within the expert (past the capacity: dropped) ->
  scatter tokens into (E, cap, D) buckets -> K7 three times -> gather
  back, weight by gate, sum over k.

The port has no mesh yet, so the reference's expert-parallel
``shard_map`` dispatch is not here: it lands with the mesh (ROADMAP queue
1, item 9).  The three expert products are K7
(:func:`repro_torch.kernels.moe_gmm.grouped_matmul`), where the reference
writes ``jnp.einsum("ecd,edf->ecf", ...)`` (``models/moe.py:226-230``):
the same function, float32 sums cast to the input type.  Under
autograd K7 differentiates through its own Function (two more K7 launches
a product), and the gradient reaches the gates and the aux loss's
router probabilities as the reference's ``_moe_ffn_dense`` does.  The
dispatch's gather of each token k times is :class:`_TokenGather`, whose
backward sums a token's k rows in a fixed order (autograd's own index
backward adds them with float atomics on CUDA, in another order each
run).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ops import grouped_matmul


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


def _route(params: dict, xt: torch.Tensor, cfg):
    """Router probs -> (normalized gates (T, k) float32, expert ids (T, k),
    the load-balancing aux loss, a float32 scalar)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = (xt @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)
    ce = _counts(expert_idx.reshape(-1), e).float() / (t * k)
    aux = e * torch.sum(me * ce)
    return gate_vals, expert_idx, aux


class _TokenGather(torch.autograd.Function):
    """``xt[token_of]`` for the (token, k) pairs in expert order, each
    token k times; the gradient of token t is the sum of its k pairs' rows
    in pair order (``g[inv]`` is pair order, ``inv`` the inverse of the
    sort), a dense ``(T, k, D)`` sum over k: the same bits every run."""

    @staticmethod
    def forward(ctx, xt, token_of, inv, k: int):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xt[token_of]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        k = ctx.k
        return (g[inv].reshape(inv.shape[0] // k, k, g.shape[1]).sum(1),
                None, None, None)


def _shared_experts(params: dict, xt: torch.Tensor) -> torch.Tensor:
    sh = F.silu(xt @ params["shared_w_gate"]) * (xt @ params["shared_w_up"])
    return sh @ params["shared_w_down"]


def moe_ffn(params: dict, x: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x.dtype, aux loss).

    The reference's ``_moe_ffn_dense`` step by step.  Pairs past their
    expert's capacity add zeros to the expert's last slot (the
    reference's ``.at[slot].add``), so the scatter's result does not
    depend on the order of its adds.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    gate_vals, expert_idx, aux = _route(params, xt, cfg)

    # ---- dispatch: sort (token, k) pairs by expert ----------------------
    cap = expert_capacity(t, cfg)
    flat_expert = expert_idx.reshape(-1)                         # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = _counts(sorted_expert, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[sorted_expert]
    keep = rank < cap
    slot = sorted_expert * cap + torch.clamp_max(rank, cap - 1)  # (T*k,)
    token_of = order // k                                        # source token
    inv = torch.argsort(order, stable=True)                      # undo sort

    buckets = torch.zeros((e * cap, d), dtype=xt.dtype, device=x.device)
    buckets.index_add_(0, slot, torch.where(
        keep[:, None], _TokenGather.apply(xt, token_of, inv, k), 0.0))
    buckets = buckets.reshape(e, cap, d)

    # ---- expert FFN: kernel K7 three times ------------------------------
    h = F.silu(grouped_matmul(buckets, params["w_gate"])) \
        * grouped_matmul(buckets, params["w_up"])
    y_flat = grouped_matmul(h, params["w_down"]).reshape(e * cap, d)

    # ---- combine: gather, undo the sort, gate-weighted sum over k -------
    gathered = y_flat[slot] * keep[:, None]                      # (T*k, D)
    per_pair = gathered[inv].reshape(t, k, d)
    # The reference's einsum("tkd,tk->td") in x.dtype: float32 products
    # and sums, rounded once.
    out = (per_pair.float() * gate_vals.to(per_pair.dtype).float()[..., None]
           ).sum(1).to(per_pair.dtype)

    if cfg.n_shared_experts:
        out = out + _shared_experts(params, xt)
    return out.reshape(b, s, d), aux
