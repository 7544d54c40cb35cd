"""Wrapper of kernel K7: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written grouped GEMM in the regime that
:func:`kernel.plan` chooses (or raises); a CPU tensor runs its plain
PyTorch version (:func:`ref.grouped_matmul_ref`).
``grouped_matmul.launches`` counts the kernel launches.  K7 has no
backward: with grad mode on and an input that requires grad, the wrapper
raises rather than return a result that autograd cannot differentiate.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x.dtype, the products
    summed in float32.  On the card x and w may be views with any expert
    and row strides whose last dimension is contiguous."""
    ref._check(x, w)
    if x.dtype != w.dtype:
        raise TypeError(f"x and w differ in dtype: {x.dtype}, {w.dtype}")
    dev = x.device
    if dev != w.device:
        raise ValueError("x and w are on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_matmul has no backward: MoE training comes with its "
            "autograd Function (ROADMAP queue 1, item 13)")
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


grouped_matmul.launches = 0
