"""Build and bind kernel K6 (``csrc/decode.cu``).

The source is compiled for ``sm_90a`` into
``build/repro_torch_kernels/libdecode_attention.so`` at first use by the
shared helper (:mod:`repro_torch.kernels._build`) and loaded with
``ctypes``.  Multiply-adds may contract: the kernel is held to float32 and
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
    lib.decode_attention_partials.argtypes = ([p] * 7 + [ll] * 4 + [i] * 6
                                              + [ctypes.c_float, i, p])
    lib.decode_attention_partials.restype = i


LIBRARY = KernelLibrary("decode_attention",
                        Path(__file__).resolve().parent / "csrc", _bind,
                        "decode_attention_error_string")


def decode_partials(q, k, v, kv_len, o, m, l, *, block_k: int) -> None:
    """Launch K6; the wrapper has checked shapes, types and strides."""
    lib = LIBRARY.library()
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rc = lib.decode_attention_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), b, s, hq, hkv, d, block_k,
        1.0 / math.sqrt(d), DTYPES[q.dtype], stream(q))
    LIBRARY.check(rc, "decode_attention")
