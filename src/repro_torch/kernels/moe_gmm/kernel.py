"""Build and bind kernel K7 (``csrc/gmm.cu``).

The source is compiled for ``sm_90a`` into
``build/repro_torch_kernels/libmoe_gmm.so`` at first use by the shared
helper (:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``.
Multiply-adds may contract: the kernel is held to float32 and bfloat16
tolerances, not to the plain version's bits.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, stream

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gmm.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.moe_gmm.restype = i


LIBRARY = KernelLibrary("moe_gmm", Path(__file__).resolve().parent / "csrc",
                        _bind, "moe_gmm_error_string")


def gmm(x, w, out) -> None:
    """Launch K7; the wrapper has checked shapes, types and strides."""
    e, c, d = x.shape
    rc = LIBRARY.library().moe_gmm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, w.shape[2],
        DTYPES[x.dtype], stream(x))
    LIBRARY.check(rc, "moe_gmm")
