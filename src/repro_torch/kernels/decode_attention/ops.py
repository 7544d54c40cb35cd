"""Wrapper of kernel K6: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written kernel for the per-block partials
(or raises); a CPU tensor runs their plain PyTorch version
(:func:`ref.decode_partials_ref`).  Either way the log-sum-exp combine
runs as PyTorch ops, as the reference runs it outside its Pallas kernel.
``decode_attention.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel, ref

#: Cache positions a block scores (the reference's default).
BLOCK_K = 512


def decode_attention(q, k, v, kv_len, *, block_k: int = BLOCK_K):
    """One query token per sequence against a ragged KV cache.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); kv_len: (B,) int, the live prefix
    of each row's cache.  Returns (B, Hq, D) in q.dtype.  On CUDA, k and v
    may be views into a larger cache: only their head and feature axes
    must be packed.
    """
    ref._check(q, k, v, kv_len)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device == kv_len.device):
        raise ValueError("q, k, v, kv_len are on different devices")
    if q.device.type == "cpu":
        return ref.decode_attention_split_ref(q, k, v, kv_len, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    block_k = min(block_k, s)
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"K6 takes float32 or bfloat16, not {q.dtype}")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"K6 takes head_dim in {kernel.HEAD_DIMS}, not {d}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: heads and features must be packed "
                             f"(strides {t.stride()})")
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise TypeError("kv_len must be a contiguous int32 tensor")
    nk = -(-s // block_k)
    o = torch.empty((b, hkv, nk, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, nk, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    kernel.decode_partials(q, k, v, kv_len, o, m, l, block_k=block_k)
    decode_attention.launches += 1
    return ref.combine_partials(o, m, l, q.dtype)


decode_attention.launches = 0
