"""Plain PyTorch version of kernel K7, the grouped expert GEMM.

:func:`grouped_matmul_ref` is the reference's oracle
(``repro/kernels/moe_gmm/ref.py``) and the math of its Pallas body
(``repro/kernels/moe_gmm/kernel.py:_gmm_kernel``): every expert's token
bucket times that expert's weight, ``(E, C, D) @ (E, D, F)``, with the
products summed in float32 and the result cast to ``x.dtype``.  It runs on
any device; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected x (E,C,D) and w (E,D,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         f"in experts or contraction width")


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), w: (E, D, F) -> (E, C, F) in x.dtype (float32
    accumulation)."""
    _check(x, w)
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor):
    """The gradient of :func:`grouped_matmul_ref` at ``x`` (E, C, D), ``w``
    (E, D, F) for the cotangent ``dy`` (E, C, F): ``(dx = dy @ w^T, dw =
    x^T @ dy)``, each summed in float32 and cast to its operand's dtype."""
    _check(x, w)
    dy = dy.float()
    dx = torch.einsum("ecf,edf->ecd", dy, w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy).to(w.dtype)
    return dx, dw
