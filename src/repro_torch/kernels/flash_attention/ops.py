"""Wrappers of kernels K4 and K5: checks, launch counters, dispatch by
device, and the differentiable op that joins them.

A CUDA tensor launches the hand-written kernels in the regime that their
plans choose (``kernel.plan``, ``kernel_bwd.plan``: the tensor cores for
bf16 that TMA can read, the CUDA cores otherwise), or raises; a CPU tensor
runs their plain PyTorch versions (:func:`ref.flash_attention_ref`,
:func:`ref.flash_attention_bwd_ref`).  :func:`flash_attention` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is K5,
as the reference wires its Pallas kernels with ``jax.custom_vjp``
(``repro/kernels/flash_attention/ops.py``).  ``flash_attention.launches``
counts K4's launches, ``flash_attention_bwd.launches`` K5's (each call
launches its dk/dv kernel and its dq kernel once).

A head dim that the kernels lack is zero-padded along D to the next one
they take (:func:`padded_forward`, :func:`padded_backward`), and the
kernels run with the true ``1 / sqrt(D)``: K4 and K5 take any D up to 256.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.backend import PLAIN_DEVICES
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


def _check_cuda(q, tensors: dict, head_dims, q_offset: int, what: str,
                packed: bool) -> None:
    """The CUDA launch's checks: its head dim, a non-negative offset, each
    tensor's features contiguous and, for the CUDA-core kernels
    (``packed``), its heads too."""
    d = q.shape[3]
    if d not in head_dims:
        raise ValueError(f"{what} takes head_dim in {head_dims}, not {d}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    for name, t in tensors.items():
        if t.stride(3) != 1 or (packed and t.stride(2) != d):
            raise ValueError(f"{name}: {'heads and ' if packed else ''}"
                             f"features must be packed (strides "
                             f"{t.stride()})")


def _device(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def padded_head_dim(d: int, head_dims, what: str) -> int:
    """The smallest of ``head_dims`` at or above ``d``."""
    wider = [h for h in head_dims if h >= d]
    if not wider:
        raise ValueError(f"{what} takes head dims up to {max(head_dims)}, "
                         f"not {d}")
    return min(wider)


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` (..., D0) zero-padded along its last dim to ``d`` features, as
    a new packed tensor."""
    return F.pad(t, (0, d - t.shape[-1]))


def padded_forward(forward, q, k, v, d: int, **kwargs):
    """``forward(q, k, v, scale=..., **kwargs)`` at head dim ``d``: q, k and
    v zero-padded along D to ``d``, the scores scaled by the true ``1 /
    sqrt(D)``, the output sliced back to D.  A zero feature adds nothing
    to a score and makes a zero output column, so the output and the
    log-sum-exp are those of the unpadded call."""
    d0 = q.shape[-1]
    out, lse = forward(*(pad_head_dim(t, d) for t in (q, k, v)),
                       scale=1.0 / math.sqrt(d0), **kwargs)
    return out[..., :d0].contiguous(), lse


def padded_backward(backward, q, k, v, out, lse, dout, d: int, **kwargs):
    """``backward(q, k, v, out, lse, dout, scale=..., **kwargs)`` at head
    dim ``d``: every (..., D) operand zero-padded along D to ``d``, the
    forward's ``1 / sqrt(D)`` passed on, the gradients sliced back to D.
    The padded columns of O and dO are zero, so ``rowsum(dO O)`` and every
    gradient's first D columns are the unpadded call's."""
    d0 = q.shape[-1]
    padded = [pad_head_dim(t, d) for t in (q, k, v, out)]
    grads = backward(*padded, lse, pad_head_dim(dout, d),
                     scale=1.0 / math.sqrt(d0), **kwargs)
    return tuple(g[..., :d0].contiguous() for g in grads)


def _forward(q, k, v, causal: bool, q_offset: int):
    if q.device.type in PLAIN_DEVICES:
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset, block_k=BLOCK_K)
    _device(q)
    d = q.shape[3]
    if d not in kernel.HEAD_DIMS:
        return padded_forward(_launch_forward, q, k, v,
                              padded_head_dim(d, kernel.HEAD_DIMS, "K4"),
                              causal=causal, q_offset=q_offset)
    return _launch_forward(q, k, v, causal=causal, q_offset=q_offset,
                           scale=1.0 / math.sqrt(d))


def _launch_forward(q, k, v, *, causal: bool, q_offset: int, scale: float):
    b, sq, hq, d = q.shape
    p = kernel.plan(b, sq, k.shape[1], hq, k.shape[2], d, q.dtype,
                    tuple(kernel.bshd_strides(t) for t in (q, k, v)),
                    _aligned(q, k, v))
    _check_cuda(q, {"q": q, "k": k, "v": v}, kernel.HEAD_DIMS, q_offset,
                "K4", p.regime == "cuda_core")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    kernel.flash_fwd(q, k, v, out, lse, p, causal=causal, q_offset=q_offset,
                     scale=scale)
    flash_attention.launches += 1
    return out, lse


def _pitched(rows: torch.Tensor, pitch: int) -> torch.Tensor:
    """Float32 (B, Hq, Sq) rows at a row pitch of ``pitch`` values (a
    multiple of 4, so that TMA can read them), zeros past Sq."""
    if rows.shape[-1] == pitch:
        return rows.contiguous()
    out = torch.zeros(rows.shape[:-1] + (pitch,), dtype=torch.float32,
                      device=rows.device)
    out[..., :rows.shape[-1]] = rows
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        q_offset: int = 0):
    """The backward of :func:`flash_attention` from its output and
    log-sum-exp: ``(dq, dk, dv)`` in the inputs' layouts and types, dk and
    dv summed over each KV head's group.  ``D = rowsum(dO * O)`` is a
    float32 PyTorch op, outside the kernels, as the reference computes it
    in plain JAX outside its kernels.  K5 takes head dims up to 256; one
    that it lacks is zero-padded to the next it has."""
    _check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if q.device.type in PLAIN_DEVICES:
        return ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, q_offset=q_offset,
            block_q=BLOCK_Q, block_k=BLOCK_K)
    _device(q)
    d = q.shape[3]
    if d not in kernel_bwd.HEAD_DIMS:
        return padded_backward(
            _launch_backward, q, k, v, out, lse, dout,
            padded_head_dim(d, kernel_bwd.HEAD_DIMS, "K5"), causal=causal,
            q_offset=q_offset)
    return _launch_backward(q, k, v, out, lse, dout, causal=causal,
                            q_offset=q_offset, scale=1.0 / math.sqrt(d))


def _launch_backward(q, k, v, out, lse, dout, *, causal: bool,
                     q_offset: int, scale: float):
    b, sq, hq, d = q.shape
    p = kernel_bwd.plan(b, sq, k.shape[1], hq, k.shape[2], d, q.dtype,
                        tuple(kernel.bshd_strides(t)
                              for t in (q, k, v, dout)),
                        _aligned(q, k, v, dout))
    _check_cuda(q, {"q": q, "k": k, "v": v, "dout": dout},
                kernel_bwd.HEAD_DIMS, q_offset, "K5",
                p.regime == "cuda_core")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}, expected "
                         f"{(b, hq, sq)} float32")
    # One float32 copy of dO, multiplied by O in place (``.float()`` would
    # alias a float32 dO and overwrite the caller's gradient).
    dsum = dout.to(torch.float32, copy=True).mul_(out).sum(-1)
    dsum = dsum.transpose(1, 2)
    pitch = -(-sq // 4) * 4 if p.regime == "tensor_core" else sq
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    kernel_bwd.flash_bwd(q, k, v, dout, _pitched(lse, pitch),
                         _pitched(dsum, pitch), dq, dk, dv, p,
                         causal=causal, q_offset=q_offset, scale=scale)
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
    k and v may be views into a longer cache: their features must be
    contiguous, and their heads packed too unless the tensor-core kernels
    take the call.  Where nothing needs a gradient no graph is
    recorded.
    """
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, q_offset)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
