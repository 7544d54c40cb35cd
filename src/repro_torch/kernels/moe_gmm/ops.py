"""Wrapper of kernel K7: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written grouped GEMM in the regime that
:func:`kernel.plan` chooses (or raises); a CPU tensor runs its plain
PyTorch version (:func:`ref.grouped_matmul_ref`).
:class:`GroupedMatmul` differentiates it, where the reference
differentiates its ``einsum``: the backward is two more K7 launches,
``dX = dY @ W^T`` as ``(E, C, F) @ (E, F, D)`` and ``dW = X^T @ dY`` as
``(E, D, C) @ (E, C, F)``, on copies of the transposed operands made
contiguous first (K7 reads a last dimension that is packed); on the CPU
its plain version, :func:`ref.grouped_matmul_bwd_ref`.
``grouped_matmul.launches`` counts every K7 launch, the backward's too.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One product on the tensors' device: the plain version on the CPU,
    one K7 launch on the card (or a raise)."""
    dev = x.device
    if dev.type == "cpu":
        return ref.grouped_matmul_ref(x, w)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, not {x.dtype}")
    (e, c, d), f = x.shape, w.shape[2]
    xs, ws = x.stride(), w.stride()
    if (d > 1 and xs[2] != 1) or (f > 1 and ws[2] != 1):
        raise ValueError("x's and w's last dimensions must be contiguous")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    p = kernel.plan(e, c, d, f, x.dtype, (xs[:2], ws[:2]), aligned,
                    _sms(dev.index))
    out = torch.empty((e, c, f), dtype=x.dtype, device=dev)
    kernel.gmm(x, w, out, p)
    grouped_matmul.launches += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """K7 forward; K7 twice in the backward (the plain versions on the
    CPU).  Saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.set_materialize_grads(False)
        return _gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        x, w = ctx.saved_tensors
        if x.device.type == "cpu":
            return ref.grouped_matmul_bwd_ref(x, w, dy)
        dy = dy.contiguous()
        dx = _gmm(dy, w.transpose(1, 2).contiguous()) \
            if ctx.needs_input_grad[0] else None
        dw = _gmm(x.transpose(1, 2).contiguous(), dy) \
            if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x.dtype, the products
    summed in float32; differentiable in x and w.  On the card x and w may
    be views with any expert and row strides whose last dimension is
    contiguous."""
    ref._check(x, w)
    if x.dtype != w.dtype:
        raise TypeError(f"x and w differ in dtype: {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w are on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return _gmm(x, w)


grouped_matmul.launches = 0
