"""Bind kernel K5 (``csrc/flash_bwd.cu``), the flash-attention backward.

Its two kernels live in the package's library, built beside K4 by
:data:`repro_torch.kernels.flash_attention.kernel.LIBRARY`.  Multiply-adds
may contract: the kernels are held to float32 and bfloat16 tolerances, not
to the plain version's bits.
"""

from __future__ import annotations

import math

from repro_torch.kernels._build import stream
from repro_torch.kernels.flash_attention.kernel import DTYPES, LIBRARY

#: Head dims K5 takes: at 256 its tiles pass a block's shared memory.
HEAD_DIMS = (16, 32, 64, 128)


def flash_bwd(q, k, v, dout, lse, dsum, dq, dk, dv, *, causal: bool,
              q_offset: int) -> None:
    """Launch K5's dk/dv kernel, then its dq kernel; the wrapper has
    checked shapes, types and strides and allocated the outputs."""
    lib = LIBRARY.library()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), dout.stride(0),
            dout.stride(1), b, sq, skv, hq, hkv, d, int(q_offset),
            int(bool(causal)), 1.0 / math.sqrt(d), DTYPES[q.dtype],
            stream(q))
    LIBRARY.check(lib.flash_attention_bwd_dkdv(*args),
                  "flash_attention_bwd (dk/dv)")
    LIBRARY.check(lib.flash_attention_bwd_dq(*args),
                  "flash_attention_bwd (dq)")
