"""Build, plan and bind kernel K4 (``csrc/flash_fwd.cu``,
``csrc/flash_fwd_tc.cu``).

The package's sources (K4's and K5's) are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libflash_attention.so`` at first use by the
shared helper (:mod:`repro_torch.kernels._build`), with the shared Hopper
header on the include path, and loaded with ``ctypes``.

:func:`plan` is the one place that chooses how a call runs, from the dtype,
the head dim, the strides and the alignment alone (no kernel is tried and
no failure falls back):

* ``"tensor_core"``: bfloat16 at D 64, 112 or 128 whose batch, row and
  head pitches are multiples of 8 elements (16 bytes) and whose base
  addresses are 16-byte aligned, so TMA can describe every operand:
  ``flash_fwd_tc.cu``, wgmma fed by TMA, one block per (128 query rows,
  query head, batch);
* ``"cuda_core"``: float32 (held to 2e-5 and 1e-4 against the plain
  versions, which TF32 would not keep), the other head dims, and bfloat16
  that TMA cannot read: ``flash_fwd.cu`` in float32 on the CUDA cores, one
  block per (64 query rows, query head, batch), heads and features packed.

Multiply-adds may contract and the tensor cores sum in their own order: the
kernels are held to float32 and bfloat16 tolerances, not to the plain
version's bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import INCLUDE_DIR, KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: Head dims of the tensor-core kernels (112 is read as 128 columns, the
#: last 16 TMA's zeros).
TC_HEAD_DIMS = (64, 112, 128)
#: A block's dynamic shared memory on an H100 (227 KB).
SMEM_LIMIT = 232_448

# The tensor-core kernels' geometry, as csrc/flash_tc.cuh and
# csrc/flash_fwd_tc.cu set it: 64 bf16 columns of D a box row, blocks of
# 128 query rows, key tiles of 128 at D 64 and 64 at D 112 and 128, two
# ring stages, 1,024 bytes of slack to align the tiles to a swizzle atom.
_ROW_BYTES = 128
_ALIGN = 1024
_ROWS = 128
_STAGES = 2
_CORE_ROWS = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call of K4 runs: its regime, grid ``(x, y, z)`` and dynamic
    shared memory a block (bytes)."""

    regime: str
    grid: tuple[int, int, int]
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def packed_strides(s: int, h: int, d: int) -> tuple[int, int, int]:
    """The (batch, row, head) strides of a packed (B, S, H, D) tensor."""
    return (s * h * d, h * d, d)


def tma_readable(dtype: torch.dtype, d: int, strides, aligned: bool) -> bool:
    """Whether the tensor-core kernels take the call: bf16 at a head dim
    they have, every pitch a positive multiple of 8 elements, the bases
    16-byte aligned."""
    return (dtype == torch.bfloat16 and d in TC_HEAD_DIMS and aligned
            and all(p > 0 and p % 8 == 0 for t in strides for p in t))


def tc_width(d: int) -> int:
    """The columns of D that a tensor-core tile holds (64 or 128)."""
    return 64 if d == 64 else 128


def check_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype not in DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, not {dtype}")


@functools.lru_cache(maxsize=256)
def plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
         dtype: torch.dtype, strides: tuple | None = None,
         aligned: bool = True) -> Plan:
    """The plan of K4 on q (b, sq, hq, d) and k, v (b, skv, hkv, d) in
    ``dtype``.  ``strides`` is ``(q's, k's, v's)`` (batch, row, head)
    strides in elements (packed when None); ``aligned`` says that their
    base addresses are 16-byte aligned.  Raises TypeError for a dtype that
    K4 does not take."""
    check_dtype(dtype, "K4")
    if strides is None:
        strides = (packed_strides(sq, hq, d), packed_strides(skv, hkv, d),
                   packed_strides(skv, hkv, d))
    if tma_readable(dtype, d, strides, aligned):
        nb = tc_width(d) // 64
        keys = 128 if nb == 1 else 64
        kv = 2 * nb * keys * _ROW_BYTES         # a stage's K and V
        return Plan("tensor_core", (hq, b, _cdiv(sq, _ROWS)),
                    nb * _ROWS * _ROW_BYTES + _STAGES * kv + _ALIGN)
    return Plan("cuda_core", (_cdiv(sq, _CORE_ROWS), hq, b),
                4 * (3 * _CORE_ROWS * (d + 1) + _CORE_ROWS * 65))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = ([p] * 5 + [ll] * 6 + [i] * 8
                                        + [ctypes.c_float, i, i, p])
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_fwd_tc.argtypes = ([p] * 5 + [ll] * 9 + [i] * 8
                                           + [ctypes.c_float, i, p])
    lib.flash_attention_fwd_tc.restype = i
    for fn in (lib.flash_attention_bwd_dkdv, lib.flash_attention_bwd_dq):
        fn.argtypes = ([p] * 9 + [ll] * 8 + [i] * 8
                       + [ctypes.c_float, i, p, i])
        fn.restype = i
    for fn in (lib.flash_attention_bwd_dkdv_tc,
               lib.flash_attention_bwd_dq_tc):
        fn.argtypes = [p] * 9 + [ll] * 13 + [i] * 8 + [ctypes.c_float, p, i]
        fn.restype = i
    lib.flash_attention_tc_smem_bytes.argtypes = [i, i]
    lib.flash_attention_tc_smem_bytes.restype = ll


LIBRARY = KernelLibrary("flash_attention",
                        Path(__file__).resolve().parent / "csrc", _bind,
                        "flash_attention_error_string",
                        include_dirs=(INCLUDE_DIR,))


def smem_bytes(kernel: str, d: int) -> int:
    """The library's own count of a tensor-core launch's dynamic shared
    memory (``kernel`` is ``"fwd"``, ``"dkdv"`` or ``"dq"``), to hold the
    plans against."""
    return LIBRARY.library().flash_attention_tc_smem_bytes(
        ("fwd", "dkdv", "dq").index(kernel), d)


def bshd_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """A (B, S, H, D) tensor's (batch, row, head) strides."""
    return (t.stride(0), t.stride(1), t.stride(2))


def flash_fwd(q, k, v, out, lse, p: Plan, *, causal: bool,
              q_offset: int, scale: float) -> None:
    """Launch K4 as ``p`` plans it, scores scaled by ``scale``; the wrapper
    has checked shapes, types and strides."""
    lib = LIBRARY.library()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    dims = (b, sq, skv, hq, hkv, d, int(q_offset), int(bool(causal)),
            float(scale))
    if p.regime == "tensor_core":
        rc = lib.flash_attention_fwd_tc(
            *ptrs, *bshd_strides(q), *bshd_strides(k), *bshd_strides(v),
            *dims, q.device.index, stream(q))
    else:
        rc = lib.flash_attention_fwd(
            *ptrs, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), *dims, DTYPES[q.dtype],
            q.device.index, stream(q))
    LIBRARY.check(rc, f"flash_attention ({p.regime})")
