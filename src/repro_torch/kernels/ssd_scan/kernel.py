"""Build and bind kernel K8 (``csrc/ssd.cu``).

The source is compiled for ``sm_90a`` into
``build/repro_torch_kernels/libssd_scan.so`` at first use by the shared
helper (:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``.
Multiply-adds may contract and the in-chunk cumulative sum runs in
another order than ``torch.cumsum``: the kernel is held to float32 and
bfloat16 tolerances, not to the plain version's bits.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The widest head K8 takes (its y tile is at most 128 columns).
MAX_HEAD_DIM = 128


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk.argtypes = [p] * 8 + [ll] * 6 + [i] * 7 + [p]
    lib.ssd_chunk.restype = i


LIBRARY = KernelLibrary("ssd_scan", Path(__file__).resolve().parent / "csrc",
                        _bind, "ssd_scan_error_string")


def ssd_chunk(x, log_decay, dt, b_mat, c_mat, y, contrib, total, *,
              chunk: int) -> None:
    """Launch K8 (its two kernels); the wrapper has checked shapes, types
    and strides and allocated the outputs."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    rc = LIBRARY.library().ssd_chunk(
        x.data_ptr(), log_decay.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), y.data_ptr(), contrib.data_ptr(),
        total.data_ptr(), b_mat.stride(0), b_mat.stride(1), b_mat.stride(2),
        c_mat.stride(0), c_mat.stride(1), c_mat.stride(2), bsz, l, h, p, n,
        chunk, DTYPES[x.dtype], stream(x))
    LIBRARY.check(rc, "ssd_scan")
