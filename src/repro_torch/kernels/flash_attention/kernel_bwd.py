"""Plan and bind kernel K5 (``csrc/flash_bwd.cu``, ``csrc/flash_bwd_tc.cu``),
the flash-attention backward.

Its kernels live in the package's library, built beside K4 by
:data:`repro_torch.kernels.flash_attention.kernel.LIBRARY`.  A call is two
launches, the dk/dv kernel and then the dq kernel, in the regime that
:func:`plan` chooses by the rule of K4's plan (``kernel.tma_readable``):
``"tensor_core"`` (``flash_bwd_tc.cu``: wgmma fed by TMA, bf16 at D 64,
112 or 128 with pitches and bases TMA can read) or ``"cuda_core"``
(``flash_bwd.cu``: float32 on the CUDA cores, heads and features packed).
Multiply-adds may contract and the tensor cores sum in their own order: the
kernels are held to float32 and bfloat16 tolerances, not to the plain
version's bits.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels._build import stream
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.kernel import DTYPES, LIBRARY

#: Head dims K5 takes (129-255 reach 256 zero-padded by the wrapper).
HEAD_DIMS = (16, 32, 64, 112, 128, 256)

# The tensor-core kernels' geometry (csrc/flash_bwd_tc.cu): the dk/dv
# kernel's blocks of 128 keys with ring stages of 64 query rows (32 at D
# 112 and 128; Q, dO and their lse and D rows, the boxes 8,192 bytes apart
# either way), the dq kernel's blocks of 192 query rows at D 64 (three
# consumer warpgroups) and 128 at D 112 and 128, with ring stages of 64
# keys (K and V); 4 stages at D 64, 3 at 112 and 128.
_BOX = 64 * 128
_ALIGN = 1024
_BLOCK_ROWS = 128


def core_rows(d: int) -> int:
    """The CUDA-core kernels' row block at head dim ``d``
    (``row_block`` in csrc/flash_bwd.cu): 64, or 32 above D 128, where
    64 rows of D 256 take 296,960 bytes of shared memory a block."""
    return 32 if d > 128 else 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call of K5 runs: its regime and, for its two launches (the
    dk/dv kernel, then the dq kernel), their grids ``(x, y, z)`` and
    dynamic shared memory a block (bytes)."""

    regime: str
    grid: tuple[tuple[int, int, int], tuple[int, int, int]]
    smem_bytes: tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
         dtype: torch.dtype, strides: tuple | None = None,
         aligned: bool = True) -> Plan:
    """The plan of K5 on q, dO (b, sq, hq, d) and k, v (b, skv, hkv, d) in
    ``dtype``.  ``strides`` is ``(q's, k's, v's, dO's)`` (batch, row, head)
    strides in elements (packed when None); ``aligned`` says that their
    base addresses are 16-byte aligned.  Raises TypeError for a dtype that
    K5 does not take."""
    kernel.check_dtype(dtype, "K5")
    if strides is None:
        qs = kernel.packed_strides(sq, hq, d)
        ks = kernel.packed_strides(skv, hkv, d)
        strides = (qs, ks, ks, qs)
    if kernel.tma_readable(dtype, d, strides, aligned):
        nb = kernel.tc_width(d) // 64
        stages = 4 if nb == 1 else 3
        dq_rows = 192 if nb == 1 else 128
        dkdv = (2 * nb * _BLOCK_ROWS * 128 + stages * (2 * nb * _BOX + _ALIGN)
                + _ALIGN)
        dq = 2 * nb * dq_rows * 128 + stages * 2 * nb * _BOX + _ALIGN
        return Plan("tensor_core",
                    ((hkv, b, _cdiv(skv, _BLOCK_ROWS)),
                     (hq, b, _cdiv(sq, dq_rows))), (dkdv, dq))
    br = core_rows(d)
    smem = 4 * (4 * br * (d + 1) + 2 * br * (br + 1) + 2 * br)
    return Plan("cuda_core", ((_cdiv(skv, br), hkv, b),
                              (_cdiv(sq, br), hq, b)), (smem, smem))


def flash_bwd(q, k, v, dout, lse, dsum, dq, dk, dv, p: Plan, *,
              causal: bool, q_offset: int, scale: float) -> None:
    """Launch K5's dk/dv kernel, then its dq kernel, as ``p`` plans them,
    with the forward's ``scale``; the wrapper has checked shapes, types and
    strides and allocated the outputs.  ``lse`` and ``dsum`` are float32 (B, Hq, Sq) rows, their
    pitch a multiple of 4 in the tensor-core regime."""
    lib = LIBRARY.library()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    dims = (b, sq, skv, hq, hkv, d, int(q_offset), int(bool(causal)),
            float(scale))
    if p.regime == "tensor_core":
        args = (*ptrs, *kernel.bshd_strides(q), *kernel.bshd_strides(k),
                *kernel.bshd_strides(v), *kernel.bshd_strides(dout),
                lse.stride(1), *dims, stream(q), q.device.index)
        fns = (lib.flash_attention_bwd_dkdv_tc, lib.flash_attention_bwd_dq_tc)
    else:
        args = (*ptrs, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
                *dims, DTYPES[q.dtype], stream(q), q.device.index)
        fns = (lib.flash_attention_bwd_dkdv, lib.flash_attention_bwd_dq)
    LIBRARY.check(fns[0](*args), f"flash_attention_bwd dk/dv ({p.regime})")
    LIBRARY.check(fns[1](*args), f"flash_attention_bwd dq ({p.regime})")
