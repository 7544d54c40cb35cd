"""Build, plan and bind kernel K7 (``csrc/gmm.cu``, ``csrc/gmm_tc.cu``).

The sources are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libmoe_gmm.so`` at first use by the shared
helper (:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``.

:func:`plan` is the one place that chooses how a call runs, from the dtype,
the shape, the strides and the alignment alone (no kernel is tried and no
failure falls back):

* ``"wide"``: bfloat16 with C > 64 (a prefill's expert buckets), bound by
  operations: wgmma on the tensor cores, fed by TMA, 128 x 256 tiles of
  (C, F), one persistent block an SM;
* ``"narrow"``: bfloat16 with C <= 64 (a decode step's buckets), bound by
  bytes: the operands swapped so that 64 columns of F fill wgmma's rows and
  the C tokens, rounded up to 8, 16, 32 or 64, its N, one block per (64
  columns of F, expert), the weights streamed by TMA;
* ``"cuda_core"``: float32 (held to its plain version's tokens and routing,
  which TF32 would not keep), and bfloat16 that TMA cannot describe (a
  pitch of x, w or out that is no multiple of 16 bytes, a base address
  that is not 16-byte aligned, or D = 0): the float32 CUDA-core kernel.

Multiply-adds may contract and the tensor cores sum in their own order: the
kernel is held to float32 and bfloat16 tolerances, not to the plain
version's bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import INCLUDE_DIR, KernelLibrary

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
REGIMES = {"cuda_core": 0, "wide": 1, "narrow": 2}

#: The largest C that the narrow regime takes (wgmma's N).
NARROW_MAX_C = 64
#: A block's dynamic shared memory on an H100 (227 KB), and its SMs.
SMEM_LIMIT = 232_448
H100_SMS = 132

# The kernels' constants, as csrc/gmm.cu and csrc/gmm_tc.cu set them.
_ALIGN = 1024                      # slack to align the ring to a swizzle atom
_BOX = 64 * 128                    # a 64 x 64 bf16 TMA box, bytes
_WIDE_TILE = (128, 256)            # rows of C, columns of F of a tile
_WIDE_STAGES = 4                   # and two epilogue boxes a consumer
_NARROW_F = 64
_NARROW_STAGES = 6
_CORE_TILE = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call of K7 runs: its regime, grid ``(x, y, z)``, dynamic
    shared memory a block (bytes) and, in the narrow regime, wgmma's N (0
    otherwise)."""

    regime: str
    grid: tuple[int, int, int]
    smem_bytes: int
    n: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def narrow_n(c: int) -> int:
    """wgmma's N for a bucket of ``c`` tokens (``c <= NARROW_MAX_C``)."""
    return next(n for n in (8, 16, 32, 64) if c <= n)


@functools.lru_cache(maxsize=256)
def plan(e: int, c: int, d: int, f: int, dtype: torch.dtype,
         strides: tuple | None = None, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """The plan of ``x (e, c, d) @ w (e, d, f)`` in ``dtype``.

    ``strides`` is ``((x's expert, x's row), (w's expert, w's row))`` in
    elements (packed when None); ``aligned`` says that x's, w's and out's
    base addresses are 16-byte aligned; ``sms`` is the card's SM count (the
    wide regime's persistent grid, one block an SM).  Raises TypeError for
    a dtype that K7 does not take.
    """
    if dtype not in DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, not {dtype}")
    if strides is None:
        strides = ((c * d, d), (d * f, f))
    pitches = [s for pair in strides for s in pair] + [f]
    tma = (dtype == torch.bfloat16 and aligned and d > 0
           and all(p > 0 and p % 8 == 0 for p in pitches))
    if tma and c <= NARROW_MAX_C:
        n = narrow_n(c)
        return Plan("narrow", (_cdiv(f, _NARROW_F), e, 1),
                    _NARROW_STAGES * (_BOX + n * 128) + _ALIGN, n)
    if tma:
        tm, tn = _WIDE_TILE
        tiles = _cdiv(c, tm) * _cdiv(f, tn) * e
        return Plan("wide", (min(tiles, sms), 1, 1),
                    _WIDE_STAGES * (tm + tn) * 128 + 4 * _BOX + _ALIGN)
    return Plan("cuda_core", (_cdiv(f, _CORE_TILE), _cdiv(c, _CORE_TILE), e),
                0)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm.argtypes = [p] * 3 + [i] * 4 + [q] * 4 + [i] * 2 + [p]
    lib.moe_gmm.restype = i
    lib.moe_gmm_smem_bytes.argtypes = [i, i]
    lib.moe_gmm_smem_bytes.restype = q


LIBRARY = KernelLibrary("moe_gmm", Path(__file__).resolve().parent / "csrc",
                        _bind, "moe_gmm_error_string",
                        include_dirs=(INCLUDE_DIR,))


def smem_bytes(regime: str, c: int) -> int:
    """The library's own count of a launch's dynamic shared memory, to
    hold :func:`plan` against."""
    return LIBRARY.library().moe_gmm_smem_bytes(REGIMES[regime], c)


def gmm(x, w, out, p: Plan) -> None:
    """Launch K7 as ``p`` plans it; the wrapper has checked shapes, types
    and strides.  The current stream is read raw: a decode step makes 48
    of these calls, and a ``torch.cuda.Stream`` object for each would cost
    several microseconds of host time."""
    (e, c, d), (sxe, sxc, _), (swe, swd, _) = x.shape, x.stride(), w.stride()
    rc = LIBRARY.library().moe_gmm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, w.shape[2],
        sxe, sxc, swe, swd, DTYPES[x.dtype], REGIMES[p.regime],
        torch._C._cuda_getCurrentRawStream(x.device.index))
    LIBRARY.check(rc, f"moe_gmm ({p.regime})")
