"""Wrapper of kernel K6: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written kernel as :func:`kernel.plan`
sizes it, partials and log-sum-exp combine in one call (or raises); a CPU
tensor runs their plain PyTorch version
(:func:`ref.decode_attention_split_ref`: the partials, then the combine as
PyTorch ops, as the reference runs it outside its Pallas kernel).
``decode_attention.launches`` counts the calls that launch the kernel,
:func:`decode_attention_lse`'s too (the same kernel, writing its float32
output and the rows' log-sum-exp).  :func:`combine_over_ranks` joins the
ranks' outputs of a cache split over the sequence (plain PyTorch: the
reference computes it in XLA).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backend import PLAIN_DEVICES
from repro_torch.kernels.decode_attention import kernel, ref
from repro_torch.kernels.decode_attention.ref import combine_over_ranks

#: Cache positions a block scores in the plain version (the reference's
#: default).
BLOCK_K = 512


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, kv_len, with_lse: bool):
    """Check a CUDA call, then launch K6: ``out`` in q's dtype, or float32
    ``(out, lse)`` ``with_lse``."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kernel.check_dtype(q.dtype)
    kernel.check_head_dim(d)
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: heads and features must be packed "
                             f"(strides {t.stride()})")
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise TypeError("kv_len must be a contiguous int32 tensor")
    aligned = k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    p = kernel.plan(b, s, hq, hkv, d, q.dtype,
                    (k.stride()[:2], v.stride()[:2]), aligned,
                    _sms(q.device.index))
    ws = torch.empty(kernel.workspace_floats(b, hkv, hq // hkv, d, p),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((b, hq, d), dtype=torch.float32 if with_lse
                      else q.dtype, device=q.device)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel.decode(q, k, v, kv_len, ws, out, p, lse)
    decode_attention.launches += 1
    return (out, lse) if with_lse else out


def _checked(q, k, v, kv_len) -> str:
    ref._check(q, k, v, kv_len)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device == kv_len.device):
        raise ValueError("q, k, v, kv_len are on different devices")
    if q.device.type not in ("cuda",) + PLAIN_DEVICES:
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def decode_attention(q, k, v, kv_len, *, block_k: int = BLOCK_K):
    """One query token per sequence against a ragged KV cache.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); kv_len: (B,) int, the live prefix
    of each row's cache.  Returns (B, Hq, D) in q.dtype.  ``block_k`` is
    the plain version's block of cache positions; on CUDA the plan's split
    governs instead.  On CUDA, D is a multiple of 8 up to 256, and k and v
    may be views into a larger cache: only their head and feature axes
    must be packed.
    """
    if _checked(q, k, v, kv_len) in PLAIN_DEVICES:
        return ref.decode_attention_split_ref(q, k, v, kv_len, block_k)
    return _launch(q, k, v, kv_len, False)


def decode_attention_lse(q, k, v, kv_len, *, block_k: int = BLOCK_K):
    """:func:`decode_attention`'s float32 output (B, Hq, D) and each row's
    log-sum-exp (B, Hq) float32 (natural log of the softmax's
    denominator, scores scaled by ``1 / sqrt(D)``): a row with no live
    position gives ``out = 0`` and ``lse = -1e30``.  The same kernel K6,
    its combine writing both; on the CPU the plain version."""
    if _checked(q, k, v, kv_len) in PLAIN_DEVICES:
        return ref.decode_attention_lse_ref(q, k, v, kv_len, block_k)
    return _launch(q, k, v, kv_len, True)


decode_attention.launches = 0
