"""Wrapper of kernel K7: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written grouped GEMM in the regime that
:func:`kernel.plan` chooses (or raises); a CPU tensor runs its plain
PyTorch version (:func:`ref.grouped_matmul_ref`).
:class:`GroupedMatmul` differentiates it, where the reference
differentiates its ``einsum``: the backward is two more K7 launches,
``dX = dY @ W^T`` as ``(E, C, F) @ (E, F, D)`` and ``dW = X^T @ dY`` as
``(E, D, C) @ (E, C, F)``, with ``W^T`` and ``X^T`` transposed views of
the saved operands that K7 reads in place (:func:`transposed_operands`;
its plan takes either inner axis packed); on the CPU its plain version,
:func:`ref.grouped_matmul_bwd_ref`.
``grouped_matmul.launches`` counts every K7 launch, the backward's too.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.backend import PLAIN_DEVICES
from repro_torch.kernels.moe_gmm import kernel, ref


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One product on the tensors' device: the plain version on the CPU,
    one K7 launch on the card (or a raise)."""
    dev = x.device
    if dev.type in PLAIN_DEVICES:
        return ref.grouped_matmul_ref(x, w)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, not {x.dtype}")
    (e, c, d), f = x.shape, w.shape[2]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    # Raises on an operand with neither inner axis packed.
    p = kernel.plan(e, c, d, f, x.dtype, (x.stride(), w.stride()), aligned,
                    _sms(dev.index))
    out = torch.empty((e, c, f), dtype=x.dtype, device=dev)
    kernel.gmm(x, w, out, p)
    grouped_matmul.launches += 1
    return out


def transposed_operands(x: torch.Tensor, w: torch.Tensor):
    """``(W^T, X^T)``, the backward's right operand of dX and left
    operand of dW: views of ``w`` (E, F, D) and ``x`` (E, D, C) sharing
    their storage, no copy (K7 reads the packed inner axis where it is)."""
    return w.transpose(1, 2), x.transpose(1, 2)


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
        if x.device.type in PLAIN_DEVICES:
            return ref.grouped_matmul_bwd_ref(x, w, dy)
        dy = dy.contiguous()
        wt, xt = transposed_operands(x, w)
        dx = _gmm(dy, wt) if ctx.needs_input_grad[0] else None
        dw = _gmm(xt, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x.dtype, the products
    summed in float32; differentiable in x and w.  On the card x and w may
    be views with any expert stride and either inner axis packed."""
    ref._check(x, w)
    if x.dtype != w.dtype:
        raise TypeError(f"x and w differ in dtype: {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w are on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return _gmm(x, w)


grouped_matmul.launches = 0
