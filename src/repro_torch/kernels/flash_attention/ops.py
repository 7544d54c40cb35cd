"""Wrappers of kernels K4 and K5: checks, launch counters, dispatch by
device, and the differentiable op that joins them.

A CUDA tensor launches the hand-written kernels (or raises); a CPU tensor
runs their plain PyTorch versions (:func:`ref.flash_attention_ref`,
:func:`ref.flash_attention_bwd_ref`).  :func:`flash_attention` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is K5,
as the reference wires its Pallas kernels with ``jax.custom_vjp``
(``repro/kernels/flash_attention/ops.py``).  ``flash_attention.launches``
counts K4's launches, ``flash_attention_bwd.launches`` K5's (each call
launches its dk/dv kernel and its dq kernel once).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, kernel_bwd, ref

#: KV block of the plain versions (the reference's tests run the Pallas
#: kernels with 64-row blocks; the CUDA kernels' tiles are 64 rows too).
BLOCK_K = 64
#: Query block of the plain backward.
BLOCK_Q = 64


def _check(q, k, v) -> None:
    ref._check(q, k, v)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v are on different devices")


def _check_cuda(q, tensors: dict, head_dims, q_offset: int,
                what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, not {q.dtype}")
    d = q.shape[3]
    if d not in head_dims:
        raise ValueError(f"{what} takes head_dim in {head_dims}, not {d}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    for name, t in tensors.items():
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name}: heads and features must be packed "
                             f"(strides {t.stride()})")


def _forward(q, k, v, causal: bool, q_offset: int):
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset, block_k=BLOCK_K)
    _check_cuda(q, {"q": q, "k": k, "v": v}, kernel.HEAD_DIMS, q_offset,
                "K4")
    b, sq, hq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    kernel.flash_fwd(q, k, v, out, lse, causal=causal, q_offset=q_offset)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        q_offset: int = 0):
    """The backward of :func:`flash_attention` from its output and
    log-sum-exp: ``(dq, dk, dv)`` in the inputs' layouts and types, dk and
    dv summed over each KV head's group.  ``D = rowsum(dO * O)`` is a
    float32 PyTorch op, outside the kernels, as the reference computes it
    in plain JAX outside its kernels."""
    _check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, q_offset=q_offset,
            block_q=BLOCK_Q, block_k=BLOCK_K)
    _check_cuda(q, {"q": q, "k": k, "v": v, "dout": dout},
                kernel_bwd.HEAD_DIMS, q_offset, "K5")
    b, sq, hq, d = q.shape
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}, expected "
                         f"{(b, hq, sq)} float32")
    dsum = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    kernel_bwd.flash_bwd(q, k, v, dout, lse.contiguous(), dsum, dq, dk, dv,
                         causal=causal, q_offset=q_offset)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K4 forward, K5 backward; saves q, k, v, out and lse (no O(S^2)
    residual).  ``lse`` is returned but not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = _forward(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        if dout is None:
            return None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Causal GQA flash attention, differentiable in q, k and v.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); ``q_offset`` is the absolute
    position of q[:, 0] (a prefill that continues a cache).  Returns
    ``(out (B, Sq, Hq, D) in q.dtype, lse (B, Hq, Sq) float32)``.  On CUDA,
    k and v may be views into a longer cache: only their head and feature
    axes must be packed.  Where nothing needs a gradient no graph is
    recorded.
    """
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, q_offset)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
