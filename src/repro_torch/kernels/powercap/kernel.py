"""Build and bind the powercap CUDA kernels (``csrc/``).

At first use the ``.cu`` sources are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libpowercap.so`` at the repository root by the
shared helper (:mod:`repro_torch.kernels._build`) and loaded with
``ctypes`` through their plain C entry points.  A failed build raises;
nothing falls back to the plain versions.

``--fmad=false`` keeps every rounding of the kernels where the plain
PyTorch versions have it (no multiply-add is contracted), so the two
differ only in the order of their sums.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import KernelLibrary, stream as _stream

#: Dynamic shared memory one block may take on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.powercap_waterfill.argtypes = [p] * 6 + [ll, i, i, p]
    lib.powercap_waterfill.restype = i
    lib.powercap_balance_caps.argtypes = [p] * 16 + [ll, i, i, i, d, i, d,
                                                     p]
    lib.powercap_balance_caps.restype = i
    lib.powercap_waterfill_segmented.argtypes = [p] * 8 + [ll, i, i, p]
    lib.powercap_waterfill_segmented.restype = i
    lib.powercap_balance_smem_bytes.argtypes = [i]
    lib.powercap_balance_smem_bytes.restype = ll


LIBRARY = KernelLibrary("powercap", Path(__file__).resolve().parent / "csrc",
                        _bind, "powercap_error_string",
                        extra_flags=("--fmad=false",))


def build() -> tuple[float, str]:
    """Compile and link the library; returns ``(seconds, ptxas log)``."""
    return LIBRARY.build()


def library() -> ctypes.CDLL:
    """The loaded library, built first if missing or older than a source."""
    return LIBRARY.library()


def waterfill(cap, fl, ce, w, act, out, iters: int) -> None:
    """Launch K1 over ``rows = cap.numel()`` rows of ``J`` slots."""
    lib = library()
    rows, j = cap.numel(), fl.shape[-1]
    rc = lib.powercap_waterfill(cap.data_ptr(), fl.data_ptr(),
                                ce.data_ptr(), w.data_ptr(), act.data_ptr(),
                                out.data_ptr(), rows, j, iters, _stream(fl))
    LIBRARY.check(rc, "waterfill")


def waterfill_segmented(cap, layout, fl, ce, w, out, iters: int) -> None:
    """Launch K3 over the ``layout.starts.numel()`` rows of a CSR layout
    (:class:`repro_torch.kernels.powercap.segments.SegmentLayout`)."""
    lib = library()
    rc = lib.powercap_waterfill_segmented(
        cap.data_ptr(), layout.starts.data_ptr(), layout.counts.data_ptr(),
        layout.order.data_ptr(), fl.data_ptr(), ce.data_ptr(), w.data_ptr(),
        out.data_ptr(), layout.starts.numel(), layout.jb, iters,
        _stream(out))
    LIBRARY.check(rc, "waterfill_segmented")


def balance_smem_bytes(n_hosts: int) -> int:
    return int(library().powercap_balance_smem_bytes(n_hosts))


def balance_caps(tensors, caps_out, did_out, rounds_out, *, iters: int,
                 params) -> None:
    """Launch K2; ``tensors`` are the 13 inputs in the C entry's order."""
    lib = library()
    s, h = caps_out.shape
    j = tensors[5].shape[-1]
    rc = lib.powercap_balance_caps(
        *(t.data_ptr() for t in tensors), caps_out.data_ptr(),
        did_out.data_ptr(), rounds_out.data_ptr(), s, h, j, iters,
        float(params.imbalance_threshold), int(params.max_iters),
        float(params.min_transfer), _stream(caps_out))
    LIBRARY.check(rc, "balance_caps")
