"""Core model primitives: RMSNorm, RoPE, GQA attention with a KV cache,
MLP and the streamed cross-entropy (``repro.models.layers``).

Self-attention runs on the port's kernels: a prefill (any query length,
cursor ``q_offset``) on K4, :func:`repro_torch.kernels.flash_attention.
flash_attention`, and a one-token decode step on K6,
:func:`repro_torch.kernels.decode_attention.decode_attention`.  The
reference reaches the same functions through ``flash_attention_xla``, the
pure-JAX twin of those Pallas kernels; :func:`flash_attention_xla` here is
its plain PyTorch copy, for the tests.  Training differentiates through
the same call: its backward is K5
(:class:`repro_torch.kernels.flash_attention.ops.FlashAttention`).
:func:`rms_norm` and :func:`streamed_xent` carry the reference's backward
as ``torch.autograd.Function``s.

Tensor parallelism (the reference's ``shard(...)`` annotations over
``heads``, ``kv_heads``, ``ffn`` and ``vocab``, which GSPMD turns into
collectives) is explicit here, on each rank's blocks of the weights
(:func:`repro_torch.launch.shardspecs.local_params`): a layer finds its
split from its weights' shapes (:func:`repro_torch.runtime.sharding
.split_over`).  Attention column-splits ``wq``, ``wk`` and ``wv`` into
the rank's heads and row-splits ``wo``, its input entering through
Megatron's ``f`` (:func:`~repro_torch.runtime.sharding.copy_to`) and its
output leaving through ``g`` (:func:`~repro_torch.runtime.sharding
.sum_over`, one all-reduce); K4, K5 and K6 see only the rank's heads.
Where the kv heads stay whole (they do not divide the model axis), each
rank projects all of them and attends with the ones its q heads read.
The MLP splits its hidden dim over ``ffn`` the same way.
:func:`streamed_xent` over a vocabulary split across ranks takes each
chunk's log-sum-exp from an all-reduced max and sum of exponentials and
the gold logit from the rank that owns it; its backward recomputes the
rank's logits alone and sums the ranks' parts of the input's gradient in
float32.
Under a sequence split (:func:`repro_torch.runtime.sharding.seq_split`)
the activations between layers are each rank's block of the positions.
With ``inner_seq`` over the same dims (the odd-head archs' layout, heads
whole) attention and the MLP compute on the block: a rank projects its
block's Q, K and V, all-gathers K and V over the sequence (only the
first ``(r + 1) S / n`` positions are read: the attention is causal) and
runs K4 at ``q_offset = r S / n`` (K5 at the same offset under
autograd; the gather's backward reduce-scatters dK and dV).  Without
``inner_seq`` a layer gathers its input whole at its entry; split over
the same dims (Megatron-SP) it leaves by a reduce-scatter in place of
``g``'s all-reduce, else each rank keeps its block of the output.  Under
``kv_seq`` a rank holds a block of the decode cache's positions: the new
token's K and V go to the rank whose block holds the cursor, each rank
runs K6 on its block (:func:`repro_torch.kernels.decode_attention
.decode_attention_lse`, an empty block giving the empty partial), and
the ranks' float32 outputs are combined by their log-sum-exp in rank
order and cast once.  :func:`streamed_xent` over a split sequence sums
each rank's tokens, or, over a vocabulary split on the same dims,
gathers the hidden states and runs the split xent.
Without a bound context, or where every split is of one rank, each
function computes what it computes on one rank.  Cross attention (the
encoder-decoder's) projects only the queries, applies no RoPE and
attends non-causally over the given K/V: on K4, or on K6 for a one-token
step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (combine_over_ranks,
                                                     decode_attention,
                                                     decode_attention_lse)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.runtime.sharding import (all_reduce, copy_to,
                                          current_context, gather_dims,
                                          gather_seq, inner_seq_split,
                                          kv_seq_split, live_dims,
                                          scatter_dims, scatter_seq,
                                          seq_block, seq_split,
                                          spec_for, split_over,
                                          sum_in_rank_order, sum_over)

NEG_INF = -1e30


# ----------------------------------------------------------------- normals
class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP (``layers.py:24-58``): dx computed in
    float32 and handed back in x's dtype, dscale summed in float32.  With
    ``split = (mesh, dims, width)`` the last dim has ``width`` entries
    split across the ranks of mesh ``dims`` (``x`` and ``scale`` this
    rank's block): the sum of squares forward and the ``sum dy * scale *
    x`` term backward are summed over the ranks in rank order, and
    ``scale``'s gradient is its block's."""

    @staticmethod
    def forward(ctx, x, scale, eps, split=None):
        xf = x.float()
        if split is None:
            ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        else:
            ms = sum_in_rank_order(torch.sum(xf * xf, dim=-1, keepdim=True),
                                   split[0], split[1]) / split[2]
        r = torch.rsqrt(ms + eps)
        ctx.save_for_backward(x, scale, r)
        ctx.split = split
        return ((xf * r) * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, r = ctx.saved_tensors
        split = ctx.split
        xf = x.float()
        dyf = dy.float() * scale.float()
        dot = torch.sum(dyf * xf, dim=-1, keepdim=True)
        if split is not None:
            dot = sum_in_rank_order(dot, split[0], split[1])
        width = x.shape[-1] if split is None else split[2]
        dx = r * (dyf - xf * (r * r) * dot / width)
        dscale = torch.sum(dy.float() * xf * r, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 internals, cast back to ``x.dtype``."""
    return _RMSNorm.apply(x, scale, eps)


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, mesh,
                   dims, width: int) -> torch.Tensor:
    """:func:`rms_norm` over a dim of ``width`` entries of which this rank
    holds ``x.shape[-1]``, split over mesh ``dims``."""
    return _RMSNorm.apply(x, scale, eps, (mesh, tuple(dims), width))


# -------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _card_frequencies(head_dim: int, theta: float,
                      device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` in float32 on a CUDA device, copied there
    once: a captured decode step may not copy from the host."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    The frequencies are computed in float64 and used in float32, as the
    reference uses them with 64-bit mode off."""
    if x.device.type == "cuda":
        freqs = _card_frequencies(x.shape[-1], theta, x.device)
    else:
        freqs = torch.as_tensor(rope_frequencies(x.shape[-1], theta),
                                dtype=torch.float32, device=x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def _block_attend(q, k, v, mask, scale):
    """One (q-block x kv-block) online-softmax partial; q: (B, Hq, Sq, D),
    k/v: (B, Hkv, Bk, D), mask (Sq, Bk) or None.  Narrow-dtype operands
    with float32 products, ``p`` cast to v's dtype before ``p @ v``, as in
    the reference."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    groups = hq // hkv
    qg = q.reshape(b, hkv, groups, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (o.reshape(b, hq, sq, d), m.reshape(b, hq, sq),
            l.reshape(b, hq, sq))


def flash_attention_xla(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len: int | None = None, block_k: int = 1024):
    """Plain copy of the reference's ``flash_attention_xla`` (tests only).

    q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D) in
    q.dtype."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    dev = q.device
    scale = 1.0 / np.sqrt(d)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    q_pos = q_offset + torch.arange(sq, device=dev)

    def mask_for(k_pos):
        mask = torch.ones((sq, k_pos.numel()), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        mask &= (k_pos < skv)[None, :]
        if kv_len is not None:
            mask &= (k_pos < kv_len)[None, :]
        return mask

    if sq <= 8:
        o, m, l = _block_attend(qt, kt, vt,
                                mask_for(torch.arange(skv, device=dev)),
                                scale)
        out = o / torch.clamp_min(l, 1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)
    block_k = min(block_k, skv)
    o = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        k_pos = k0 + torch.arange(block_k, device=dev)
        kb = F.pad(kt[:, :, k0:k0 + block_k],
                   (0, 0, 0, block_k - kt[:, :, k0:k0 + block_k].shape[2]))
        vb = F.pad(vt[:, :, k0:k0 + block_k],
                   (0, 0, 0, block_k - vt[:, :, k0:k0 + block_k].shape[2]))
        ob, mb, lb = _block_attend(qt, kb, vb, mask_for(k_pos), scale)
        m_new = torch.maximum(m, mb)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(mb - m_new)
        o = o * alpha[..., None] + ob * beta[..., None]
        l = l * alpha + lb * beta
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_param_specs(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ((d, hq * hd), ("embed_p", "heads")),
        "wk": ((d, hkv * hd), ("embed_p", "kv_heads")),
        "wv": ((d, hkv * hd), ("embed_p", "kv_heads")),
        "wo": ((hq * hd, d), ("heads", "embed_p")),
    }


def _kv_for_heads(k, v, q_lo: int, hq_l: int, groups: int):
    """The K/V heads of q heads ``q_lo .. q_lo + hq_l`` (``groups`` q heads
    a kv head) from whole K/V (B, S, Hkv, hd): a slice where the grouping
    allows, else one kv head a q head."""
    if hq_l % groups == 0 and q_lo % groups == 0:
        lo = q_lo // groups
        return k[:, :, lo:lo + hq_l // groups], v[:, :, lo:lo + hq_l // groups]
    if groups % hq_l == 0:
        j = q_lo // groups
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.div(torch.arange(q_lo, q_lo + hq_l, device=k.device),
                    groups, rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _seq_mode(tp):
    """How a layer split as ``tp`` (:func:`~repro_torch.runtime.sharding
    .split_over`'s tuple, or None) meets the bound context's sequence
    split: ``(mode, split)``, ``mode`` None (no split), ``"inner"`` (the
    layer computes on the rank's block: ``inner_seq`` over the ``seq``
    dims), ``"megatron"`` (the input gathered whole, the output
    reduce-scattered: the layer is split over the ``seq`` dims) or
    ``"gather"`` (the input gathered whole, the output's block kept).
    Raises ``ValueError`` for a layout that no block of ranks computes
    whole: ``inner_seq`` without ``seq`` over the same dims, or a layer
    split over some of the dims that split its sequence."""
    sp, inner = seq_split(), inner_seq_split()
    if sp is None:
        if inner is not None:
            raise ValueError(f"inner_seq over mesh dims {inner[1]} without "
                             f"seq over them")
        return None, None
    tp_dims = () if tp is None else tuple(tp[1])
    if inner is not None:
        if tuple(inner[1]) != tuple(sp[1]):
            raise ValueError(f"inner_seq over mesh dims {inner[1]}, seq "
                             f"over {sp[1]}")
        if set(tp_dims) & set(sp[1]):
            raise ValueError(f"a layer split over mesh dims {tp_dims} that "
                             f"also split its sequence ({sp[1]})")
        return "inner", sp
    if tp_dims == tuple(sp[1]):
        return "megatron", sp
    if set(tp_dims) & set(sp[1]):
        raise ValueError(f"a layer split over mesh dims {tp_dims}, its "
                         f"sequence over {sp[1]}")
    return "gather", sp


def _enter(x, tp, mode, sp):
    """A layer's input: gathered whole over the sequence where ``mode``
    says, entering the rank's block of a ``tp`` split through Megatron's
    ``f`` (or, split over the sequence's own dims, through the gather)."""
    if mode in ("megatron", "gather"):
        x = gather_seq(x, sp[0], sp[1])
    if tp is not None and mode != "megatron":
        x = copy_to(x, tp[0], tp[1])
    return x


def _leave(out, tp, mode, sp):
    """A layer's output, :func:`_enter`'s conjugate: summed over a ``tp``
    split (``g``), reduce-scattered to the rank's block of the sequence
    (Megatron-SP), or cut to the block."""
    if mode == "megatron":
        return scatter_seq(out, sp[0], sp[1])
    if tp is not None:
        out = sum_over(out, tp[0], tp[1])
    return seq_block(out, sp) if mode == "gather" else out


def decode_kv_len(cursor: int, batch: int, cache_len: int, device
                  ) -> torch.Tensor:
    """``kv_len`` of a one-token step at host ``cursor``: ``cursor + 1`` on
    every row, or, where the bound context splits the cache's positions
    (``kv_seq``) and this rank holds block ``r`` of ``cache_len``
    positions, ``clamp(cursor + 1 - r cache_len, 0, cache_len)``."""
    ks = kv_seq_split()
    live = cursor + 1 if ks is None else \
        min(max(cursor + 1 - ks[2] * cache_len, 0), cache_len)
    return torch.full((batch,), live, dtype=torch.int32, device=device)


def row_kv_len(row: torch.Tensor, batch: int) -> torch.Tensor:
    """``kv_len`` of a one-token step that writes cache ``row`` (a (1,)
    int64 device tensor): ``row + 1`` on every row, read on the device."""
    return (row + 1).to(torch.int32).expand(batch).contiguous()


def _decode_over_ranks(q, k, v, kv_len, ks):
    """One token's attention over a cache whose positions are split across
    the ranks of ``ks`` (:func:`kv_seq_split`): K6 on this rank's block
    (its float32 output and log-sum-exp), gathered over the ranks and
    combined in rank order, cast once to q's dtype."""
    mesh, dims, _, _ = ks
    out, lse = decode_attention_lse(q, k, v, kv_len)
    every = gather_dims(torch.cat([out, lse[..., None]], -1)[None], mesh,
                        dims, 0)
    return combine_over_ranks(every[..., :-1], every[..., -1]).to(q.dtype)


def _attend_inner(q, k, v, sp, causal, kv_cache, heads_of):
    """Attention of this rank's block of queries (positions ``r s ..``)
    under ``inner_seq``: K and V all-gathered over the sequence (the
    gather's backward reduce-scatters their gradients), the causal ones cut
    at the block's last row, K4 at ``q_offset = r s``.  A cache holds the
    whole sequence on every rank."""
    mesh, dims, index, n = sp
    s = q.shape[1]
    kw, vw = gather_seq(k, mesh, dims), gather_seq(v, mesh, dims)
    if kv_cache is None:
        if not causal:
            out, _ = flash_attention(q, *heads_of(kw, vw), causal=False)
            return out, None
        end = (index + 1) * s
        out, _ = flash_attention(q, *heads_of(kw[:, :end], vw[:, :end]),
                                 causal=True, q_offset=index * s)
        return out, None
    if kv_seq_split() is not None:
        raise ValueError("a sequence split (inner_seq) and a cache split "
                         "over its positions (kv_seq) in one layout")
    cur = int(kv_cache["cursor"])
    ck, cv = kv_cache["k"], kv_cache["v"]
    if cur + s * n > ck.shape[1]:
        raise ValueError(f"cache of {ck.shape[1]} positions is full "
                         f"(cursor {cur}, {s * n} new)")
    ck[:, cur:cur + s * n] = kw.to(ck.dtype)
    cv[:, cur:cur + s * n] = vw.to(cv.dtype)
    end = cur + (index + 1) * s
    out, _ = flash_attention(q, *heads_of(ck[:, :end], cv[:, :end]),
                             causal=True, q_offset=cur + index * s)
    return out, {"k": ck, "v": cv, "cursor": cur + s * n}


def _attend_kv_seq(q, k, v, kv_cache, kv_len, ks, heads_of):
    """Attention over a cache whose positions are split across the ranks
    (``kv_seq``): this rank holds positions ``[r L, (r + 1) L)``.  The new
    rows are written by the rank whose block holds them; a one-token step
    runs K6 on every rank's block and combines the ranks
    (:func:`_decode_over_ranks`); a longer one attends whole on every rank
    (the cache's earlier rows gathered) and keeps its block."""
    mesh, dims, index, n = ks
    b, s = q.shape[:2]
    cur = int(kv_cache["cursor"])
    ck, cv = kv_cache["k"], kv_cache["v"]
    blk = ck.shape[1]
    lo = index * blk
    if cur + s > blk * n:
        raise ValueError(f"cache of {blk * n} positions is full (cursor "
                         f"{cur}, {s} new)")
    a, e = max(cur, lo), min(cur + s, lo + blk)
    if a < e:
        ck[:, a - lo:e - lo] = k[:, a - cur:e - cur].to(ck.dtype)
        cv[:, a - lo:e - lo] = v[:, a - cur:e - cur].to(cv.dtype)
    new_cache = {"k": ck, "v": cv, "cursor": cur + s}
    if s == 1:
        if kv_len is None:
            kv_len = decode_kv_len(cur, b, blk, q.device)
        out = _decode_over_ranks(q[:, 0], *heads_of(ck, cv), kv_len, ks)
        return out[:, None], new_cache
    if cur:
        k = torch.cat([gather_dims(ck, mesh, dims, 1)[:, :cur].to(k.dtype),
                       k], 1)
        v = torch.cat([gather_dims(cv, mesh, dims, 1)[:, :cur].to(v.dtype),
                       v], 1)
    out, _ = flash_attention(q, *heads_of(k, v), causal=True, q_offset=cur)
    return out, new_cache


def attention(params: dict, x: torch.Tensor, cfg, *, causal: bool = True,
              positions: torch.Tensor | None = None,
              kv_cache: dict | None = None, cross_kv: tuple | None = None,
              kv_len: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """GQA attention with an optional KV cache, or cross attention over
    ``cross_kv``; x: (B, S, D).

    With ``cross_kv = (k, v)``, each (B, S_kv, Hkv, hd), only the queries
    are projected, no RoPE is applied and every query row attends to every
    key: a one-token step runs K6 with ``S_kv`` keys on every row (``kv_len``
    is not read), a longer one K4 with ``causal=False``.  A query that
    needs a gradient takes K4 at any length.

    With a cache (``{"k", "v"}`` of shape (B, max_len, Hkv, hd) and a host
    ``int`` ``"cursor"``), the new keys and values are written into the
    cache in place at the cursor.  A one-token step runs K6 over the cache
    with ``kv_len`` (a (B,) int32 tensor, ``cursor + 1`` on every row; made
    here when not given); a longer one runs K4 with ``q_offset = cursor``
    over the cache's first ``cursor + S`` rows.  A one-token step whose
    cache also holds ``"row"`` (a (1,) int64 device tensor, the cursor
    read on the device, as a captured decode step replays it) writes that
    row instead, by an indexed copy, and its ``kv_len`` comes from the
    same tensor.  The reference updates its cache functionally; the port
    writes in place to keep one cache.  Returns ``(out, cache with the
    cursor advanced)``.

    ``params`` may be a rank's blocks (tensor parallelism): ``wq``'s
    columns and ``wo``'s rows its q heads, ``wk``'s and ``wv``'s columns
    its kv heads, or all of them where they stay whole; the cache and
    ``cross_kv`` hold the kv heads ``wk`` gives.  The output is then the
    sum over the ranks.  Under a sequence split ``x`` and the output are
    this rank's block of the positions, ``positions`` the whole
    sequence's (or the block's); under ``kv_seq`` the cache is this rank's
    block of the positions and ``kv_len`` its live rows
    (:func:`decode_kv_len`).
    """
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq_l = params["wq"].shape[1] // hd
    tp = split_over("heads", hq_l, hq)
    mode, sp = _seq_mode(tp)
    x = _enter(x, tp, mode, sp)
    s = x.shape[1]
    q = (x @ params["wq"]).reshape(b, s, hq_l, hd)

    def heads_of(k, v):
        if tp is None or k.shape[2] != hkv:
            return k, v
        return _kv_for_heads(k, v, tp[2] * hq_l, hq_l, hq // hkv)

    def leave(out):
        return _leave(out.reshape(b, s, hq_l * hd) @ params["wo"], tp, mode,
                      sp)

    if cross_kv is not None:
        k, v = heads_of(*cross_kv)
        if s == 1 and not q.requires_grad:
            every = torch.full((b,), k.shape[1], dtype=torch.int32,
                               device=x.device)
            out = decode_attention(q[:, 0], k, v, every)[:, None]
        else:
            out, _ = flash_attention(q, k, v, causal=False)
        return leave(out), kv_cache
    inner = mode == "inner"
    if positions is None:
        positions = torch.arange(s * sp[3] if inner else s,
                                 device=x.device)[None, :]
    if inner and positions.shape[-1] != s:
        positions = seq_block(positions, sp, positions.dim() - 1)
    hkv_l = params["wk"].shape[1] // hd
    k = (x @ params["wk"]).reshape(b, s, hkv_l, hd)
    v = (x @ params["wv"]).reshape(b, s, hkv_l, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if inner:
        out, kv_cache = _attend_inner(q, k, v, sp, causal, kv_cache,
                                      heads_of)
        return leave(out), kv_cache
    if kv_cache is None:
        out, _ = flash_attention(q, *heads_of(k, v), causal=causal)
        return leave(out), kv_cache
    ks = kv_seq_split()
    if ks is not None:
        out, kv_cache = _attend_kv_seq(q, k, v, kv_cache, kv_len, ks,
                                       heads_of)
        return leave(out), kv_cache
    cur = int(kv_cache["cursor"])
    ck, cv = kv_cache["k"], kv_cache["v"]
    if cur + s > ck.shape[1]:
        raise ValueError(f"cache of {ck.shape[1]} positions is full "
                         f"(cursor {cur}, {s} new)")
    row = kv_cache.get("row") if s == 1 else None
    if row is None:
        ck[:, cur:cur + s] = k.to(ck.dtype)
        cv[:, cur:cur + s] = v.to(cv.dtype)
    else:
        ck.index_copy_(1, row, k.to(ck.dtype))
        cv.index_copy_(1, row, v.to(cv.dtype))
        if kv_len is None:
            kv_len = row_kv_len(row, b)
    kv_cache = {"k": ck, "v": cv, "cursor": cur + s}
    if s == 1:
        if kv_len is None:
            kv_len = torch.full((b,), cur + 1, dtype=torch.int32,
                                device=x.device)
        out = decode_attention(q[:, 0], *heads_of(ck, cv), kv_len)[:, None]
    else:
        out, _ = flash_attention(q, *heads_of(ck[:, :cur + s],
                                              cv[:, :cur + s]),
                                 causal=True, q_offset=cur)
    return leave(out), kv_cache


def attention_partial_leaves(cfg) -> tuple:
    """The attention leaves whose gradient on a rank is its part of a sum
    over the ``heads`` split in the bound context: ``wk`` and ``wv`` where
    the q heads are split and the kv heads stay whole (each rank's q heads
    read only their kv heads).  Returns ``(names, mesh dims)``."""
    ctx = current_context()
    if ctx is None:
        return (), ()
    mesh, rules = ctx
    specs = attention_param_specs(cfg)
    q_dims, kv_dims = (
        live_dims(mesh, spec_for(mesh, rules, specs[n][1], specs[n][0])[1])
        for n in ("wq", "wk"))
    if q_dims and not kv_dims:
        return ("wk", "wv"), q_dims
    return (), ()


# --------------------------------------------------------------------- MLP
def mlp_param_specs(cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "w_gate": ((d, f), ("embed_p", "ffn")),
            "w_up": ((d, f), ("embed_p", "ffn")),
            "w_down": ((f, d), ("ffn", "embed_p")),
        }
    return {
        "w_up": ((d, f), ("embed_p", "ffn")),
        "w_down": ((f, d), ("ffn", "embed_p")),
    }


def mlp(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The MLP; ``params`` may be a rank's blocks of the hidden dim
    (tensor parallelism: the output is then summed over the ranks).  Under
    a sequence split ``x`` and the output are the rank's block of the
    positions (:func:`attention`'s modes)."""
    tp = split_over("ffn", params["w_up"].shape[1], cfg.d_ff)
    mode, sp = _seq_mode(tp)
    x = _enter(x, tp, mode, sp)
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(x @ params["w_up"]))
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return _leave(h @ params["w_down"], tp, mode, sp)


# -------------------------------------------------- streamed cross-entropy
def _chunk_logits(hh, w_out):
    """One chunk's logits in float32 from the product in the inputs' type
    (bf16 in, bf16 out, as the reference's ``hh @ w_out``)."""
    return (hh @ w_out).float()


class _StreamedXent(torch.autograd.Function):
    """Sum of weighted token losses over sequence chunks, never holding more
    than one chunk's logits: the backward recomputes each chunk's logits."""

    @staticmethod
    def forward(ctx, h, w_out, labels, weights, chunk):
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, h.shape[1], chunk):
            logits = _chunk_logits(h[:, c0:c0 + chunk], w_out)
            ll = labels[:, c0:c0 + chunk]
            gold = logits.gather(-1, ll[..., None].long())[..., 0]
            lse = torch.logsumexp(logits, dim=-1)
            del logits
            loss_sum = loss_sum + ((lse - gold)
                                   * weights[:, c0:c0 + chunk]).sum()
        ctx.save_for_backward(h, w_out, labels, weights)
        ctx.chunk = chunk
        return loss_sum

    @staticmethod
    def backward(ctx, dloss):
        h, w_out, labels, weights = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        dh = torch.empty_like(h) if need_h else None
        dw = (torch.zeros(w_out.shape, dtype=torch.float32,
                          device=w_out.device) if need_w else None)
        for c0 in range(0, h.shape[1], ctx.chunk):
            hh = h[:, c0:c0 + ctx.chunk]
            # d loss / d logits = (softmax - onehot(gold)) * weight, built
            # in place in the float32 logits.
            g = _chunk_logits(hh, w_out)
            lse = torch.logsumexp(g, dim=-1, keepdim=True)
            g.sub_(lse).exp_()
            ll = labels[:, c0:c0 + ctx.chunk, None].long()
            g.scatter_add_(-1, ll, torch.full(ll.shape, -1.0,
                                              device=g.device))
            g.mul_((weights[:, c0:c0 + ctx.chunk, None] * dloss))
            g = g.to(h.dtype)
            if need_h:
                dh[:, c0:c0 + ctx.chunk] = g @ w_out.T
            if need_w:
                dw += (hh.reshape(-1, hh.shape[-1]).T
                       @ g.reshape(-1, g.shape[-1])).float()
            del g
        return (dh, None if dw is None else dw.to(w_out.dtype), None, None,
                None)


class _VocabParallelXent(torch.autograd.Function):
    """:class:`_StreamedXent` over this rank's block of the vocabulary
    (``w_out``: (D, V_local), entries ``offset ..``) of a split over mesh
    ``dims``: each chunk's logits are the rank's own; the log-sum-exp comes
    from the all-reduced max and sum of exponentials, the gold logit from
    the rank that owns it (an all-reduce of the rank's share, zero
    elsewhere).  Every rank returns the whole loss.  The backward
    recomputes the rank's logits against the saved log-sum-exp, needs no
    other rank for them, and gives ``w_out`` its own block's gradient.
    ``h``'s gradient is the sum of the ranks' parts: each part a float32
    product of the rank's bf16 ``d logits``, summed over the ranks in
    float32 and rounded once to ``h``'s type (Megatron's ``f`` in
    float32).  Rounding each part to bf16 before the sum (``d logits`` is
    mostly the gold row, so a part is large where the sum cancels) put
    path TT's bf16 gradients twice as far from float32 as one rank's
    (``tools/tp_rounding.py``).

    With ``seq_gather`` (Megatron-SP: the sequence split over the same
    dims as the vocabulary) ``h`` is this rank's block of the positions
    and ``labels`` and ``weights`` the whole sequence's: ``h`` is
    all-gathered first, and ``h``'s gradient leaves by a float32
    reduce-scatter in place of the all-reduce."""

    @staticmethod
    def forward(ctx, h, w_out, labels, weights, chunk, mesh, dims, offset,
                seq_gather):
        if seq_gather:
            h = gather_dims(h, mesh, dims, 1)
        v_l = w_out.shape[1]
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for c0 in range(0, h.shape[1], chunk):
            logits = _chunk_logits(h[:, c0:c0 + chunk], w_out)
            ll = labels[:, c0:c0 + chunk].long() - offset
            own = (ll >= 0) & (ll < v_l)
            m = all_reduce(logits.amax(-1), mesh, dims, op="max")
            parts = torch.stack([
                torch.exp(logits - m[..., None]).sum(-1),
                torch.where(own, logits.gather(
                    -1, ll.clamp(0, v_l - 1)[..., None])[..., 0], 0.0)])
            del logits
            sum_exp, gold = all_reduce(parts, mesh, dims)
            lse = m + torch.log(sum_exp)
            lses.append(lse)
            loss_sum = loss_sum + ((lse - gold)
                                   * weights[:, c0:c0 + chunk]).sum()
        ctx.save_for_backward(h, w_out, labels, weights, torch.cat(lses, 1))
        ctx.chunk, ctx.offset, ctx.mesh, ctx.dims = chunk, offset, mesh, dims
        ctx.seq_gather = seq_gather
        return loss_sum

    @staticmethod
    def backward(ctx, dloss):
        h, w_out, labels, weights, lse = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        v_l = w_out.shape[1]
        dh = (torch.empty(h.shape, dtype=torch.float32, device=h.device)
              if need_h else None)
        w32 = w_out.float() if need_h else None
        dw = (torch.zeros(w_out.shape, dtype=torch.float32,
                          device=w_out.device) if need_w else None)
        for c0 in range(0, h.shape[1], ctx.chunk):
            sl = slice(c0, c0 + ctx.chunk)
            hh = h[:, sl]
            g = _chunk_logits(hh, w_out)
            g.sub_(lse[:, sl, None]).exp_()
            ll = labels[:, sl, None].long() - ctx.offset
            own = (ll >= 0) & (ll < v_l)
            g.scatter_add_(-1, ll.clamp(0, v_l - 1),
                           torch.where(own, -1.0, 0.0))
            g.mul_((weights[:, sl, None] * dloss))
            g = g.to(h.dtype)
            if need_h:
                dh[:, sl] = g.float() @ w32.T
            if need_w:
                dw += (hh.reshape(-1, hh.shape[-1]).T
                       @ g.reshape(-1, g.shape[-1])).float()
            del g
        if need_h and ctx.seq_gather:
            dh = scatter_dims(dh, ctx.mesh, ctx.dims, 1).to(h.dtype)
        elif need_h:
            dh = all_reduce(dh, ctx.mesh, ctx.dims).to(h.dtype)
        return (dh, None if dw is None else dw.to(w_out.dtype), None, None,
                None, None, None, None, None)


def streamed_xent(h: torch.Tensor, w_out: torch.Tensor,
                  labels: torch.Tensor, weights: torch.Tensor,
                  chunk: int = 2048, vocab: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing (B, S, V) logits.

    h: (B, S, D), w_out: (D, V), labels and weights: (B, S).  Each chunk of
    ``chunk`` positions computes (B, chunk, V) logits (the product in h's
    type, then float32), reduces them to the weighted loss of its tokens
    (log-sum-exp minus the gold logit) and frees them; the backward
    recomputes them a chunk at a time.  Returns ``(sum of losses, sum of
    weights)``, both float32.  The reference pads the sequence to a
    multiple of ``chunk``; the padded tokens weigh 0, so the port runs the
    last chunk short instead.  ``w_out`` may be this rank's block of the
    ``vocab`` entries (a vocabulary split over ranks:
    :class:`_VocabParallelXent`).

    Under a sequence split (:func:`~repro_torch.runtime.sharding
    .seq_split`) ``h``, ``labels`` and ``weights`` are this rank's block
    of the positions and both sums are the whole sequence's on every
    rank: each rank's tokens' sum added over the ranks (the identity
    backward: each rank differentiates its own tokens), or, over a
    vocabulary split on the same dims, ``h`` gathered whole into the
    split xent (``seq_gather``).
    """
    tp = (None if vocab is None
          else split_over("vocab", w_out.shape[1], vocab))
    sp = seq_split()
    if sp is not None and tp is not None and set(tp[1]) & set(sp[1]):
        if tuple(tp[1]) != tuple(sp[1]):
            raise ValueError(f"a vocabulary split over mesh dims {tp[1]}, "
                             f"the sequence over {sp[1]}")
        mesh, dims, index, _ = tp
        labels = gather_dims(labels, mesh, dims, 1)
        weights = gather_dims(weights, mesh, dims, 1)
        loss_sum = _VocabParallelXent.apply(
            h, w_out, labels, weights, min(chunk, labels.shape[1]), mesh,
            dims, index * w_out.shape[1], True)
        return loss_sum, weights.float().sum()
    chunk = min(chunk, h.shape[1])
    if tp is None:
        loss_sum = _StreamedXent.apply(h, w_out, labels, weights, chunk)
    else:
        mesh, dims, index, _ = tp
        loss_sum = _VocabParallelXent.apply(
            h, w_out, labels, weights, chunk, mesh, dims,
            index * w_out.shape[1], False)
    w_sum = weights.float().sum()
    if sp is not None:
        loss_sum = sum_over(loss_sum, sp[0], sp[1])
        w_sum = all_reduce(w_sum, sp[0], sp[1])
    return loss_sum, w_sum
