"""Wrapper of kernel K4: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
runs the plain PyTorch version (:func:`ref.flash_attention_ref`).
``flash_attention.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref

#: KV block of the plain version (the reference's tests run the Pallas
#: kernel with 64-row blocks; the CUDA kernel's K tiles are 64 rows too).
BLOCK_K = 64


def _check(q, k, v) -> None:
    ref._check(q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v are on different devices")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Causal GQA flash attention, forward.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); ``q_offset`` is the absolute
    position of q[:, 0] (a prefill that continues a cache).  Returns
    ``(out (B, Sq, Hq, D) in q.dtype, lse (B, Hq, Sq) float32)``.  On CUDA,
    k and v may be views into a longer cache: only their head and feature
    axes must be packed.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset, block_k=BLOCK_K)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, sq, hq, d = q.shape
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16, not {q.dtype}")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"K4 takes head_dim in {kernel.HEAD_DIMS}, not {d}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: heads and features must be packed "
                             f"(strides {t.stride()})")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    kernel.flash_fwd(q, k, v, out, lse, causal=causal, q_offset=q_offset)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
