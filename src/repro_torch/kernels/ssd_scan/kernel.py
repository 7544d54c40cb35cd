"""Build, plan and bind kernel K8 (``csrc/ssd.cu``, ``csrc/ssd_tc.cu``)
and its backward K8b (``csrc/ssd_bwd_tc.cu``, ``csrc/ssd_bwd.cu``).

The sources are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libssd_scan.so`` at first use by the shared
helper (:mod:`repro_torch.kernels._build`), with the shared Hopper header
on the include path, and loaded with ``ctypes``.

:func:`plan` is the one place that chooses how a call runs, from the dtype,
the shapes, the strides, the alignment and the SM count alone (no kernel is
tried and no failure falls back):

* ``"tensor_core"``: bfloat16 x, B and C with P and N multiples of 16 up
  to 128, Q a multiple of 64 up to 256 (a block's four key tiles of
  scores stay in shared memory), B's and C's pitches multiples of 8
  elements and their bases 16-byte aligned, so TMA can read every
  operand: ``ssd_tc.cu``.  Its state product runs on wgmma fed by TMA,
  the scaled inputs split into three bf16 parts; y_intra stays on the
  CUDA cores in the plain version's order (path P's teacher-forced logits
  take no other order, ``ssd_tc.cu`` says why).  Where B's and C's head
  strides are 0 (one row shared by the heads, as the models pass them) a
  block takes a slice of several heads and forms C_t.B_s once for all of
  them;
* ``"cuda_core"``: float32 and everything else: ``ssd.cu``, in float32 on
  the CUDA cores.

Both regimes give y_intra and total bit for bit as the plain version does
(its summation orders, ``ref.chunk_cumsum``'s for the cumulative sum); the
tensor cores sum the state product in their own order, so ``contrib`` is
held to K8's tolerance.

:func:`plan_bwd` plans K8b, from the same kind of facts, in one of two
regimes; each walks the chunk's causal triangle in 64 x 64 tiles, one
block a (head, batch x chunk):

* ``"tensor_core"``: bfloat16 x, B and C with P = 64, N = 64 or 128, Q a
  multiple of 64 up to 256, B's and C's pitches multiples of 8 elements
  and every base 16-byte aligned (TMA reads B, C and x): ``ssd_bwd_tc.cu``,
  one warpgroup a block, two blocks an SM, the products on wgmma with the
  float32 operands in bf16 parts (:func:`bwd_tc_smem`);
* ``"cuda_core"``: float32 and everything else: ``ssd_bwd.cu``, 256
  threads a block, in float32 on the CUDA cores (:func:`bwd_smem`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import INCLUDE_DIR, KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The widest head K8 takes (its y tile is at most 128 columns).
MAX_HEAD_DIM = 128
#: A block's dynamic shared memory on an H100 (227 KB), and its SMs.
SMEM_LIMIT = 232_448
H100_SMS = 132

# ssd_tc.cu's geometry: 64-column boxes of 128-byte rows, transposed
# float tiles of pitch 68, 64 query rows and up to four key tiles of 64 a
# block, slices of at most 8 heads, 32-position segments of the cumulative
# sum.
_BOX = 64 * 128
_ALIGN = 1024
_LDT = 68
_KEY_TILES = 4
_SEG = 32
#: Blocks an SM that the tensor-core slices aim for (each kernel holds one
#: block an SM): the largest slice whose grid gives every SM two.
_WAVES = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call of K8 runs: its regime, the grids ``(x, y, z)`` of its
    intra-chunk and state kernels, the heads a block of each takes (1 on
    the CUDA cores) and their dynamic shared memory (bytes)."""

    regime: str
    intra_grid: tuple[int, int, int]
    state_grid: tuple[int, int, int]
    intra_slice: int
    state_slice: int
    intra_smem: int
    state_smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def intra_smem(p: int, n: int, q: int, slice_: int) -> int:
    """``ssd_tc.cu:intra_smem``, in bytes: C's tile and a key tile of B
    transposed, or each half's weights and two bf16 x tiles that replace
    them, the scores of four key tiles, then cum, dt and the segment
    offsets of the slice."""
    head = 2 * (64 * _LDT + 64 * (64 * (1 if p <= 64 else 2) + 8))
    return 4 * (max(2 * n * _LDT, head) + _KEY_TILES * 64 * _LDT
                + 2 * slice_ * q + slice_ * (q // _SEG))


def state_smem(n: int, q: int, slice_: int) -> int:
    """``ssd_tc.cu:state_smem``: B's chunk, then for each of the two
    warpgroups 128 keys of one 64-column box of x and their three parts,
    and its w; then cum and the segment offsets of the slice (the boxes
    of P take turns)."""
    nb = 1 if n <= 64 else 2
    return ((q // 64) * nb * _BOX + 2 * 4 * 2 * _BOX
            + 4 * (2 * q + slice_ * q + slice_ * (q // _SEG)) + _ALIGN)


def _slice(blocks_per_head: int, h: int, sms: int) -> int:
    """The largest slice of at most 8 heads whose grid gives every SM
    ``_WAVES`` blocks (1 if none does)."""
    return next((s for s in (8, 4, 2)
                 if blocks_per_head * _cdiv(h, s) >= _WAVES * sms), 1)


@functools.lru_cache(maxsize=256)
def plan(b: int, l: int, h: int, p: int, n: int, q: int, dtype: torch.dtype,
         bc_strides: tuple | None = None, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """The plan of K8 on x (b, l, h, p), B and C (b, l, h, n), chunk ``q``.

    ``bc_strides`` is ``(B's, C's)`` (batch, position, head) strides in
    elements (packed when None); ``aligned`` says that x's, B's and C's
    base addresses are 16-byte aligned; ``sms`` is the card's SM count.
    Raises TypeError for a dtype that K8 does not take."""
    if dtype not in DTYPES:
        raise TypeError(f"K8 takes float32 or bfloat16, not {dtype}")
    if bc_strides is None:
        bc_strides = ((l * h * n, h * n, n),) * 2
    nc = l // q
    pitches = [s for st in bc_strides for s in st[:2]] + [
        st[2] for st in bc_strides if st[2]]
    tma = (dtype == torch.bfloat16 and aligned
           and p % 16 == 0 and 0 < p <= 128 and n % 16 == 0 and 0 < n <= 128
           and q % 64 == 0 and 0 < q <= 256 and l % q == 0
           and all(s > 0 and s % 8 == 0 for s in pitches))
    if tma:
        shared = all(st[2] == 0 for st in bc_strides)
        qt = q // 64
        si = _slice(qt * b * nc, h, sms) if shared else 1
        ss = _slice(b * nc, h, sms) if shared else 1
        return Plan("tensor_core", (qt, _cdiv(h, si), b * nc),
                    (_cdiv(h, ss), b * nc, 1), si, ss,
                    intra_smem(p, n, q, si), state_smem(n, q, ss))
    pj = 4 if p <= 64 else 8
    return Plan("cuda_core", (_cdiv(q, 64), h, b * nc),
                (_cdiv(p, 64) * _cdiv(n, 64), h, b * nc), 1, 1,
                4 * (2 * 64 * (n + 1) + 64 * (16 * pj + 1) + 64 * 65 + 64
                     + q + _cdiv(q, _SEG)),
                4 * (2 * 64 * 65 + 2 * q + _cdiv(q, _SEG)))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one call of K8b runs: its grid ``(x, y, z)``, threads a block,
    dynamic shared memory a block (bytes) and regime."""

    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    regime: str = "cuda_core"


#: K8b's tile (query and key rows) and threads a block (``ssd_bwd.cu``).
BWD_TILE = 64
BWD_THREADS = 256
#: The widest P and N that K8b takes (a thread's 8 columns of 16 lanes).
BWD_MAX_WIDTH = 128
#: The tensor-core regime's threads a block (``ssd_bwd_tc.cu``: one
#: warpgroup), head dim and state widths.
BWD_TC_THREADS = 128
BWD_TC_P = 64
BWD_TC_N = (64, 128)


def bwd_smem(p: int, n: int, q: int) -> int:
    """``ssd_bwd.cu:bwd_smem_floats`` in bytes: B's and C's tiles (64 x
    (N + 1)), x's and dy's (64 x (P + 1)), the w, dS and A tiles (64 x
    65), cum, dt and dcum (Q each), the segment offsets, a key tile's
    column sums and R (64 each) and one running sum."""
    t = BWD_TILE
    return 4 * (2 * t * (n + 1) + 2 * t * (p + 1) + 3 * t * (t + 1)
                + 3 * q + _cdiv(q, _SEG) + 2 * t + 1)


def bwd_tc_smem(n: int, q: int) -> int:
    """``ssd_bwd_tc.cu:tc_smem`` in bytes: the alignment slack, B's and
    C's tiles (N / 64 boxes of 64 x 64 bf16 each), x's, dy's three parts
    and dS's two (one box each), then cum, dt and dcum (Q floats each), the
    segment offsets, four warps' column sums, a key tile's R and their
    total."""
    return (_ALIGN + (2 * (n // 64) + 6) * _BOX
            + 4 * (3 * q + q // _SEG + 4 * 64 + 64 + 1))


@functools.lru_cache(maxsize=256)
def plan_bwd(b: int, l: int, h: int, p: int, n: int, q: int,
             dtype: torch.dtype = torch.float32,
             bc_strides: tuple | None = None,
             aligned: bool = True) -> BwdPlan:
    """The plan of K8b on x (b, l, h, p), B and C (b, l, h, n) in
    ``dtype``, chunk ``q``; ``bc_strides`` is ``(B's, C's)`` (batch,
    position, head) strides in elements (packed when None), ``aligned``
    says that x's, B's and C's bases are 16-byte aligned.  Raises
    TypeError for a dtype that K8b does not take, ValueError where it
    cannot take the shape: P or N above :data:`BWD_MAX_WIDTH`, L no
    multiple of Q, a grid past CUDA's limits, or shared memory past
    :data:`SMEM_LIMIT`."""
    if dtype not in DTYPES:
        raise TypeError(f"K8b takes float32 or bfloat16, not {dtype}")
    if not (0 < p <= BWD_MAX_WIDTH and 0 < n <= BWD_MAX_WIDTH):
        raise ValueError(f"K8b takes P and N up to {BWD_MAX_WIDTH}, not "
                         f"{p} and {n}")
    if q <= 0 or l % q:
        raise ValueError(f"L={l} is not a multiple of chunk={q}")
    if b * (l // q) > 65535:
        raise ValueError(f"K8b's grid takes at most 65535 batch x chunks, "
                         f"not {b * (l // q)}")
    if bc_strides is None:
        bc_strides = ((l * h * n, h * n, n),) * 2
    pitches = [s for st in bc_strides for s in st[:2]] + [
        st[2] for st in bc_strides if st[2]]
    if (dtype == torch.bfloat16 and aligned and p == BWD_TC_P
            and n in BWD_TC_N and q % 64 == 0 and q <= 256
            and all(s > 0 and s % 8 == 0 for s in pitches)):
        return BwdPlan((h, b * (l // q), 1), BWD_TC_THREADS,
                       bwd_tc_smem(n, q), "tensor_core")
    smem = bwd_smem(p, n, q)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K8b at P {p}, N {n}, Q {q} needs {smem} bytes "
                         f"of shared memory, past {SMEM_LIMIT}")
    return BwdPlan((h, b * (l // q), 1), BWD_THREADS, smem)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk.argtypes = [p] * 8 + [ll] * 6 + [i] * 8 + [p]
    lib.ssd_chunk.restype = i
    lib.ssd_chunk_tc.argtypes = [p] * 8 + [ll] * 6 + [i] * 9 + [p]
    lib.ssd_chunk_tc.restype = i
    lib.ssd_tc_smem_bytes.argtypes = [i] * 5
    lib.ssd_tc_smem_bytes.restype = ll
    lib.ssd_chunk_bwd.argtypes = [p] * 13 + [ll] * 6 + [i] * 8 + [p]
    lib.ssd_chunk_bwd.restype = i
    lib.ssd_bwd_smem_bytes.argtypes = [i] * 3
    lib.ssd_bwd_smem_bytes.restype = ll
    lib.ssd_chunk_bwd_tc.argtypes = [p] * 13 + [ll] * 6 + [i] * 7 + [p]
    lib.ssd_chunk_bwd_tc.restype = i
    lib.ssd_bwd_tc_smem_bytes.argtypes = [i] * 2
    lib.ssd_bwd_tc_smem_bytes.restype = ll


LIBRARY = KernelLibrary("ssd_scan", Path(__file__).resolve().parent / "csrc",
                        _bind, "ssd_scan_error_string",
                        include_dirs=(INCLUDE_DIR,))


def smem_bytes(kernel: str, p: int, n: int, q: int, slice_: int) -> int:
    """The library's own count of a tensor-core launch's dynamic shared
    memory (``kernel`` is ``"intra"`` or ``"state"``), to hold the plans
    against."""
    return LIBRARY.library().ssd_tc_smem_bytes(
        ("intra", "state").index(kernel), p, n, q, slice_)


def ssd_chunk(x, log_decay, dt, b_mat, c_mat, y, contrib, total, p: Plan,
              *, chunk: int) -> None:
    """Launch K8 (its two kernels) as ``p`` plans it; the wrapper has
    checked shapes, types and strides and allocated the outputs."""
    bsz, l, h, hp = x.shape
    n = b_mat.shape[-1]
    ptrs = (x.data_ptr(), log_decay.data_ptr(), dt.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
            contrib.data_ptr(), total.data_ptr(), *b_mat.stride()[:3],
            *c_mat.stride()[:3], bsz, l, h, hp, n, chunk)
    lib = LIBRARY.library()
    if p.regime == "tensor_core":
        rc = lib.ssd_chunk_tc(*ptrs, p.intra_slice, p.state_slice,
                              x.device.index, stream(x))
    else:
        rc = lib.ssd_chunk(*ptrs, DTYPES[x.dtype], x.device.index,
                           stream(x))
    LIBRARY.check(rc, f"ssd_scan ({p.regime})")


def bwd_smem_bytes(p: int, n: int, q: int,
                   regime: str = "cuda_core") -> int:
    """The library's own count of a K8b launch's dynamic shared memory in
    ``regime``, to hold :func:`plan_bwd` against."""
    lib = LIBRARY.library()
    if regime == "tensor_core":
        return lib.ssd_bwd_tc_smem_bytes(n, q)
    return lib.ssd_bwd_smem_bytes(p, n, q)


def ssd_chunk_bwd(x, log_decay, dt, b_mat, c_mat, dy, dcontrib, dtotal,
                  dx, dld, ddt, db, dc, p: BwdPlan, *, chunk: int) -> None:
    """Launch K8b in the regime ``p`` plans; the wrapper has checked
    shapes, types and strides and allocated the outputs."""
    bsz, l, h, hp = x.shape
    n = b_mat.shape[-1]
    ptrs = (x.data_ptr(), log_decay.data_ptr(), dt.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), dy.data_ptr(),
            dcontrib.data_ptr(), dtotal.data_ptr(), dx.data_ptr(),
            dld.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
            *b_mat.stride()[:3], *c_mat.stride()[:3], bsz, l, h, hp, n,
            chunk)
    lib = LIBRARY.library()
    if p.regime == "tensor_core":
        rc = lib.ssd_chunk_bwd_tc(*ptrs, x.device.index, stream(x))
    else:
        rc = lib.ssd_chunk_bwd(*ptrs, DTYPES[x.dtype], x.device.index,
                               stream(x))
    LIBRARY.check(rc, f"ssd_scan backward ({p.regime})")
