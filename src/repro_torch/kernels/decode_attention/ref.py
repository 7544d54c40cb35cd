"""Plain PyTorch versions of kernel K6, split-K flash decoding.

:func:`decode_partials_ref` is the math of the reference's Pallas body
(``repro/kernels/decode_attention/kernel.py:_decode_kernel``): for every
(batch, KV head, block of ``block_k`` cache positions) the G query rows
of the KV head's group score the block, positions at or past ``kv_len``
are masked with ``NEG_INF = -1e30``, and the block emits float32 partials
``(o, m, l)``; a block with no live position keeps ``m = NEG_INF`` and
gets ``p = 0``.  :func:`combine_partials` is the log-sum-exp combine the
reference runs outside the kernel (``kernel.py:102-108``);
:func:`combine_partials_lse` is the same combine keeping the float32
output and the rows' log-sum-exp (the distributed flash-decode's input).
:func:`decode_attention_ref` is the naive oracle (``decode_attention/
ref.py`` of the reference).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _check(q, k, v, kv_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Hq,D) and k, v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError("q and k differ in batch or head_dim, or Hq is "
                         "not a multiple of Hkv")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len: shape {tuple(kv_len.shape)}, expected "
                         f"({b},)")


def decode_partials_ref(q, k, v, kv_len, block_k: int = 512):
    """q: (B, Hq, D); k/v: (B, S, Hkv, D); kv_len: (B,) int.

    Returns float32 ``(o (B, Hkv, nk, G, D), m (B, Hkv, nk, G),
    l (B, Hkv, nk, G))`` with ``nk = ceil(S / block_k)``."""
    _check(q, k, v, kv_len)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    block_k = min(block_k, s)
    nk = -(-s // block_k)
    pad = nk * block_k - s
    qg = q.float().reshape(b, hkv, g, d)
    kt = F.pad(k.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
    vt = F.pad(v.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
    kt = kt.reshape(b, hkv, nk, block_k, d)
    vt = vt.reshape(b, hkv, nk, block_k, d)
    sc = torch.einsum("bhgd,bhnkd->bhngk", qg, kt) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(nk * block_k, device=q.device).reshape(nk, block_k)
    live = (k_pos[None] < kv_len.to(q.device).reshape(b, 1, 1)) \
        & (k_pos < s)[None]
    sc = torch.where(live[:, None, :, None, :], sc, NEG_INF)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    p = torch.where(m[..., None] <= NEG_INF / 2, 0.0, p)
    l = p.sum(-1)
    o = torch.einsum("bhngk,bhnkd->bhngd", p, vt)
    return o, m, l


def combine_partials(o, m, l, dtype):
    """Log-sum-exp combine over the KV blocks: (B, Hq, D) in ``dtype``."""
    b, hkv, _, g, d = o.shape
    m_max = m.amax(2, keepdim=True)
    alpha = torch.exp(m - m_max)
    l_tot = (l * alpha).sum(2)
    o_tot = (o * alpha[..., None]).sum(2)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    return out.reshape(b, hkv * g, d).to(dtype)


def combine_partials_lse(o, m, l):
    """:func:`combine_partials` in float32, with each row's log-sum-exp
    ``m_max + log(l_tot)``: ``(out (B, Hq, D), lse (B, Hq))``.  A row with
    no live position gives ``out = 0`` and ``lse = NEG_INF``."""
    b, hkv, _, g, d = o.shape
    m_max = m.amax(2, keepdim=True)
    alpha = torch.exp(m - m_max)
    l_tot = (l * alpha).sum(2)
    o_tot = (o * alpha[..., None]).sum(2)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    lse = torch.where(l_tot > 0, m_max[:, :, 0] + torch.log(l_tot), NEG_INF)
    return out.reshape(b, hkv * g, d), lse.reshape(b, hkv * g)


def decode_attention_lse_ref(q, k, v, kv_len, block_k: int = 512):
    """The plain version of the log-sum-exp entry: partials, then
    :func:`combine_partials_lse`."""
    return combine_partials_lse(*decode_partials_ref(q, k, v, kv_len,
                                                     block_k))


def combine_over_ranks(outs, lses):
    """The ranks' partial decodes, each over its block of the cache, as one:
    ``outs`` (n, B, Hq, D) float32 and ``lses`` (n, B, Hq), in rank order.
    Each rank's output weighs ``exp(lse_r - max lse)`` (zero for a rank
    with no live position), added in rank order; returns (B, Hq, D)
    float32.  The reference's GSPMD runs the same sums as its softmax's
    reductions over the sharded axis."""
    m = lses.amax(0)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(lses[0])
    for o, lse in zip(outs, lses):
        w = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(lse - m))
        num = num + o * w[..., None]
        den = den + w
    return num / torch.clamp_min(den, 1e-30)[..., None]


def decode_attention_split_ref(q, k, v, kv_len, block_k: int = 512):
    """The plain version of the whole op: partials, then the combine."""
    return combine_partials(*decode_partials_ref(q, k, v, kv_len, block_k),
                            q.dtype)


def decode_attention_ref(q, k, v, kv_len):
    """Naive single-token attention over a ragged cache: (B, Hq, D)."""
    _check(q, k, v, kv_len)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] \
        < kv_len.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(b, hq, d).to(q.dtype)
