"""Build, plan and bind kernel K6 (``csrc/decode.cu``).

The source is compiled for ``sm_90a`` into
``build/repro_torch_kernels/libdecode_attention.so`` at first use by the
shared helper (:mod:`repro_torch.kernels._build`), with the shared Hopper
header on the include path, and loaded with ``ctypes``.

:func:`plan` is the one place that chooses how a call runs, from the dtype,
the shapes, the strides, the alignment and the SM count alone (no kernel is
tried and no failure falls back): the cache positions a block scores (the
split), the lanes that score one position, the query rows a block holds,
the grid, the shared memory, and whether K and V are copied with 16-byte
loads.  One kernel serves float32 and bfloat16; it takes any head dim that
is a multiple of 8 up to 256.  Multiply-adds may contract: the kernel is
held to float32 and bfloat16 tolerances, not to the plain version's bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import INCLUDE_DIR, KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: What K6 takes as head dim (16-byte rows in either dtype).
HEAD_DIM_RULE = "a head_dim that is a multiple of 8 up to 256"
#: A block's dynamic shared memory on an H100 (227 KB), and its SMs.
SMEM_LIMIT = 232_448
H100_SMS = 132

# csrc/decode.cu's constants: threads a block, cache positions a stage.
_THREADS = 128
_STAGE = 32
#: Splits tried, largest first: the largest whose grid gives every SM at
#: least this many blocks is taken (32 otherwise).
_SPLITS = (256, 128, 64)
_BLOCKS_PER_SM = 4
#: The most splits the combine takes (its alphas sit in shared memory).
_MAX_SPLITS = 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call of K6 runs: cache positions a block (``split``), the
    partials kernel's grid ``(splits, Hkv x row groups, B)`` and the
    combine's ``(Hkv x row groups, B, outputs / 128)``, lanes that score
    one position, query rows a block holds, dynamic shared memory a block
    (bytes), and whether K and V are copied with 16-byte loads."""

    split: int
    grid: tuple[int, int, int]
    combine_grid: tuple[int, int, int]
    lanes: int
    rows: int
    smem_bytes: int
    vector_loads: bool

    @property
    def splits(self) -> int:
        return self.grid[0]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def takes_head_dim(d: int) -> bool:
    return 0 < d <= 256 and d % 8 == 0


def check_head_dim(d: int) -> None:
    if not takes_head_dim(d):
        raise ValueError(f"K6 takes {HEAD_DIM_RULE}, not {d}")


def check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise TypeError(f"K6 takes float32 or bfloat16, not {dtype}")


def smem_bytes(d: int, esize: int, lanes: int, rows: int) -> int:
    """Two stages of K and V, or the slots' merge, whichever is larger
    (as ``csrc/decode.cu:smem_bytes`` counts them)."""
    stages = 2 * 2 * _STAGE * d * esize
    merge = 4 * (_THREADS // lanes) * rows * (3 + d)
    return max(stages, merge)


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, hq: int, hkv: int, d: int, dtype: torch.dtype,
         strides: tuple | None = None, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """The plan of K6 on q (b, hq, d) against k, v (b, s, hkv, d).

    ``strides`` is ``(k's, v's)`` (batch, position) strides in elements
    (packed when None); ``aligned`` says that k's and v's base
    addresses are 16-byte aligned; ``sms`` is the card's SM count.  The
    split is the largest of 256, 128 and 64 positions whose grid, from the
    cache's capacity ``s``, gives every SM at least four blocks (32
    otherwise), and at least ``s / 512``: the combine takes 512
    splits.  Raises TypeError for a dtype and ValueError for a head dim
    that K6 does not take."""
    check_dtype(dtype)
    check_head_dim(d)
    if strides is None:
        strides = ((s * hkv * d, hkv * d),) * 2
    g = hq // hkv
    rows = min(8, _pow2_at_least(g))
    groups = hkv * _cdiv(g, rows)
    lanes = max(4, _pow2_at_least(d // 8))
    split = next((c for c in _SPLITS
                  if b * groups * _cdiv(s, c) >= _BLOCKS_PER_SM * sms),
                 _STAGE)
    split = max(split, _STAGE * _cdiv(s, _STAGE * _MAX_SPLITS))
    esize = 4 if dtype == torch.float32 else 2
    vector = aligned and all(x % (16 // esize) == 0
                             for pair in strides for x in pair)
    return Plan(split, (_cdiv(s, split), groups, b),
                (groups, b, _cdiv(rows * d, _THREADS)), lanes, rows,
                smem_bytes(d, esize, lanes, rows), vector)


def workspace_floats(b: int, hkv: int, g: int, d: int, p: Plan) -> int:
    """The float32 partials of a call: o (B, Hkv, splits, G, D), m and l
    (B, Hkv, splits, G), in one allocation."""
    return b * hkv * p.splits * g * (d + 2)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention.argtypes = ([p] * 6 + [ll] * 4 + [i] * 9
                                     + [ctypes.c_float, i, i, p])
    lib.decode_attention.restype = i
    lib.decode_attention_lse.argtypes = lib.decode_attention.argtypes + [p]
    lib.decode_attention_lse.restype = i
    lib.decode_attention_smem_bytes.argtypes = [i] * 4
    lib.decode_attention_smem_bytes.restype = ll


LIBRARY = KernelLibrary("decode_attention",
                        Path(__file__).resolve().parent / "csrc", _bind,
                        "decode_attention_error_string",
                        include_dirs=(INCLUDE_DIR,))


def library_smem_bytes(d: int, dtype: torch.dtype, lanes: int,
                       rows: int) -> int:
    """The library's own count of a partials block's shared memory, to
    hold :func:`plan` against."""
    return LIBRARY.library().decode_attention_smem_bytes(
        d, DTYPES[dtype], lanes, rows)


def decode(q, k, v, kv_len, ws, out, p: Plan, lse=None) -> None:
    """Launch K6 (its partials kernel and the combine) as ``p`` plans it;
    the wrapper has checked shapes, types and strides.  With ``lse`` (B,
    Hq) float32, ``out`` is float32 and the combine also writes each
    row's log-sum-exp (``decode_attention_lse``)."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    lib = LIBRARY.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            ws.data_ptr(), out.data_ptr(), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), b, s, hq, hkv, d, p.split, p.lanes,
            p.rows, int(p.vector_loads), 1.0 / math.sqrt(d),
            DTYPES[q.dtype], q.device.index, stream(q))
    if lse is None:
        LIBRARY.check(lib.decode_attention(*args), "decode_attention")
    else:
        LIBRARY.check(lib.decode_attention_lse(*args, lse.data_ptr()),
                      "decode_attention_lse")
