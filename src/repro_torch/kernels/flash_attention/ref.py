"""Plain PyTorch versions of kernels K4 and K5, the flash-attention
forward and backward.

:func:`flash_attention_ref` is the math of the reference's Pallas body
(``repro/kernels/flash_attention/kernel.py:_flash_kernel``): an online
softmax over KV blocks of ``block_k`` keys with the running ``(m, l, acc)``
in float32, ``NEG_INF = -1e30`` for masked scores, ``l`` clamped at
``1e-30``, and the log-sum-exp beside the output.  Blocks that start past
the last query's causal limit are skipped, as the Pallas grid skips them;
a row that sees a block only through masked keys gains exact zeros from
it.  :func:`flash_attention_bwd_ref` is the math of the reference's
backward (``kernel_bwd.py``).  :func:`attention_ref` is the naive softmax
oracle (``flash_attention/ref.py`` of the reference).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Sq,Hq,D) and k, v (B,Skv,Hkv,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k differ in batch or head_dim")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"Hq={q.shape[2]} not a multiple of "
                         f"Hkv={k.shape[2]}")


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        block_k: int = 64, scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); scores scaled by
    ``scale`` (``1 / sqrt(D)`` when None).

    Returns ``(out (B, Sq, Hq, D) in q.dtype, lse (B, Hq, Sq) float32)``.
    """
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = q.device
    # (B, Hkv, G, Sq, D): query head h reads KV head h // G.
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)               # (B, Hkv, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    q_pos = q_offset + torch.arange(sq, device=dev)
    live_end = min(skv, q_offset + sq) if causal else skv
    for k0 in range(0, live_end, block_k):
        kb = kf[:, :, k0:k0 + block_k]
        vb = vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vb)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    lse = (m + torch.log(l)).reshape(b, hq, sq)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0, block_q: int = 64,
                            block_k: int = 64, scale: float | None = None):
    """The backward of :func:`flash_attention_ref` from its log-sum-exp.

    ``D = rowsum(dO * O)`` in float32; for each block of ``block_k`` keys,
    ``p = exp(s - lse)`` recomputed from q and k (0 where masked, as
    ``kernel_bwd.py:_mask`` masks), ``dv = p^T dO``, ``dp = dO v^T``,
    ``ds = p (dp - D) scale``, ``dk = ds^T q`` and ``dq += ds k``, all in
    float32, dk and dv summed over each KV head's group of query heads.  Query
    blocks of ``block_q`` rows that end before a key block starts (causal)
    are skipped.  ``scale`` is the forward's (``1 / sqrt(D)`` when None).
    Returns ``(dq, dk, dv)`` in the inputs' types.
    """
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = q.device

    def grouped(t):                      # (B, Sq, Hq, D) -> (B, Hkv, G, Sq, D)
        return t.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)

    qf, dof = grouped(q), grouped(do)
    dsum = (do.float() * o.float()).sum(-1)             # (B, Sq, Hq)
    dsum = dsum.reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    lsef = lse.float().reshape(b, hkv, g, sq)
    kf = k.float().permute(0, 2, 1, 3)                  # (B, Hkv, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    q_pos = q_offset + torch.arange(sq, device=dev)
    for k0 in range(0, skv, block_k):
        # The first query block that can see this key block.
        r0 = max(0, (k0 - q_offset) // block_q) * block_q if causal else 0
        if r0 >= sq:
            continue
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        qb, dob = qf[..., r0:, :], dof[..., r0:, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        p = torch.exp(s - lsef[..., r0:, None])
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            p = torch.where(k_pos[None, :] <= q_pos[r0:, None], p, 0.0)
        dv[:, :, k0:k0 + block_k] = torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
        ds = p * (dp - dsum[..., r0:, None]) * scale
        dk[:, :, k0:k0 + block_k] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qb)
        dq[..., r0:, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Naive softmax attention; q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D).
    Returns (B, Sq, Hq, D) in q.dtype."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    kk = torch.repeat_interleave(k, groups, dim=2)
    vv = torch.repeat_interleave(v, groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(d)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(skv, device=q.device)
        s = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None], s,
                        NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return o.to(q.dtype)
