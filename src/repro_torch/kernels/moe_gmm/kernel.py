"""Build, plan and bind kernel K7 (``csrc/gmm.cu``, ``csrc/gmm_tc.cu``).

The sources are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libmoe_gmm.so`` at first use by the shared
helper (:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``.

:func:`plan` is the one place that chooses how a call runs, from the dtype,
the shape, the strides and the alignment alone (no kernel is tried and no
failure falls back).  Each operand has one of its two inner axes packed:
x's D (K-major) or C (MN-major: the backward's ``X^T``), w's F (MN-major)
or D (K-major: the backward's ``W^T``); a transposed operand is read in
place, by the wide regime or the CUDA-core kernel:

* ``"wide"``: bfloat16 with C > 64 (a prefill's expert buckets), or a
  transposed operand at any C (the backward's products), bound by
  operations: wgmma on the tensor cores, fed by TMA, 128 x 256 tiles of
  (C, F), one persistent block an SM; each operand read in its own
  majorness (a template of the kernel);
* ``"narrow"``: bfloat16 with C <= 64 (a decode step's buckets) and
  neither operand transposed, bound by
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
    shared memory a block (bytes), in the narrow regime wgmma's N (0
    otherwise), and whether x's C axis (``x_t``) and w's D axis (``w_t``)
    are the packed ones."""

    regime: str
    grid: tuple[int, int, int]
    smem_bytes: int
    n: int = 0
    x_t: bool = False
    w_t: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def narrow_n(c: int) -> int:
    """wgmma's N for a bucket of ``c`` tokens (``c <= NARROW_MAX_C``)."""
    return next(n for n in (8, 16, 32, 64) if c <= n)


def layout(name: str, strides: tuple, rows: int, cols: int
           ) -> tuple[bool, int]:
    """``(transposed, pitch)`` of an operand with inner extents ``rows``
    and ``cols`` and element strides ``(expert, row, column)``: transposed
    when its rows are the packed axis, the pitch the other axis's stride.
    Raises ValueError where neither inner axis is packed (no regime reads
    it)."""
    if cols <= 1 or strides[2] == 1:
        return False, strides[1]
    if rows <= 1 or strides[1] == 1:
        return True, strides[2]
    raise ValueError(f"K7 reads {name} with one of its two inner axes "
                     f"packed, not strides {tuple(strides)}")


@functools.lru_cache(maxsize=256)
def plan(e: int, c: int, d: int, f: int, dtype: torch.dtype,
         strides: tuple | None = None, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """The plan of ``x (e, c, d) @ w (e, d, f)`` in ``dtype``.

    ``strides`` is ``(x's, w's)`` element strides, each ``(expert, row,
    column)`` (packed when None; :func:`layout` reads which inner axis is
    packed);
    ``aligned`` says that x's, w's and out's base addresses are 16-byte
    aligned; ``sms`` is the card's SM count (the wide regime's persistent
    grid, one block an SM).  Raises TypeError for a dtype that K7 does not
    take, ValueError for an operand with neither inner axis packed.
    """
    if dtype not in DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, not {dtype}")
    if strides is None:
        strides = ((c * d, d, 1), (d * f, f, 1))
    x_t, x_pitch = layout("x", strides[0], c, d)
    w_t, w_pitch = layout("w", strides[1], d, f)
    pitches = [strides[0][0], x_pitch, strides[1][0], w_pitch, f]
    tma = (dtype == torch.bfloat16 and aligned and d > 0
           and all(p > 0 and p % 8 == 0 for p in pitches))
    if tma and c <= NARROW_MAX_C and not (x_t or w_t):
        n = narrow_n(c)
        return Plan("narrow", (_cdiv(f, _NARROW_F), e, 1),
                    _NARROW_STAGES * (_BOX + n * 128) + _ALIGN, n)
    if tma:
        tm, tn = _WIDE_TILE
        tiles = _cdiv(c, tm) * _cdiv(f, tn) * e
        return Plan("wide", (min(tiles, sms), 1, 1),
                    _WIDE_STAGES * (tm + tn) * 128 + 4 * _BOX + _ALIGN,
                    x_t=x_t, w_t=w_t)
    return Plan("cuda_core", (_cdiv(f, _CORE_TILE), _cdiv(c, _CORE_TILE), e),
                0, x_t=x_t, w_t=w_t)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm.argtypes = [p] * 3 + [i] * 4 + [q] * 4 + [i] * 5 + [p]
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
    and strides.  The pitch passed for each operand is the stride of its
    inner axis that is not packed; the library makes x's card current on
    the calling thread (autograd's worker thread may not have used it
    yet).  The current stream is read raw: a
    decode step makes 48 of these calls, and a ``torch.cuda.Stream`` object
    for each would cost several microseconds of host time."""
    (e, c, d), xs, ws = x.shape, x.stride(), w.stride()
    rc = LIBRARY.library().moe_gmm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, w.shape[2],
        xs[0], xs[2] if p.x_t else xs[1], ws[0], ws[2] if p.w_t else ws[1],
        int(p.x_t), int(p.w_t), DTYPES[x.dtype], REGIMES[p.regime],
        x.device.index, torch._C._cuda_getCurrentRawStream(x.device.index))
    LIBRARY.check(rc, f"moe_gmm ({p.regime})")
