"""Build and bind kernel K4 (``csrc/flash_fwd.cu``).

The package's sources (K4 and K5's ``csrc/flash_bwd.cu``) are compiled for
``sm_90a`` into ``build/repro_torch_kernels/libflash_attention.so`` at
first use by the shared helper (:mod:`repro_torch.kernels._build`) and
loaded with ``ctypes``.  Multiply-adds may contract: the kernel is held to float32 and
bfloat16 tolerances, not to the plain version's bits.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = ([p] * 5 + [ll] * 6 + [i] * 8
                                        + [ctypes.c_float, i, p])
    lib.flash_attention_fwd.restype = i
    for fn in (lib.flash_attention_bwd_dkdv, lib.flash_attention_bwd_dq):
        fn.argtypes = [p] * 9 + [ll] * 8 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = i


LIBRARY = KernelLibrary("flash_attention",
                        Path(__file__).resolve().parent / "csrc", _bind,
                        "flash_attention_error_string")


def flash_fwd(q, k, v, out, lse, *, causal: bool, q_offset: int) -> None:
    """Launch K4; the wrapper has checked shapes, types and strides."""
    lib = LIBRARY.library()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), b, sq, skv, hq, hkv, d, int(q_offset),
        int(bool(causal)), 1.0 / math.sqrt(d), DTYPES[q.dtype], stream(q))
    LIBRARY.check(rc, "flash_attention")
