"""Wrapper of kernel K7: checks, launch counter, dispatch by device.

A CUDA tensor launches the hand-written grouped GEMM (or raises); a CPU
tensor runs its plain PyTorch version (:func:`ref.grouped_matmul_ref`).
``grouped_matmul.launches`` counts the kernel launches.  K7 has no
backward: with grad mode on and an input that requires grad, the wrapper
raises rather than return a result that autograd cannot differentiate.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x.dtype, the products
    summed in float32."""
    ref._check(x, w)
    if x.dtype != w.dtype:
        raise TypeError(f"x and w differ in dtype: {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w are on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_matmul has no backward: MoE training comes with its "
            "autograd Function (ROADMAP queue 1, item 13)")
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, not {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    kernel.gmm(x, w, out)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
