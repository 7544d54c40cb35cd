"""Build and bind the powercap CUDA kernels (``csrc/``).

At first use the ``.cu`` sources are compiled for ``sm_90a`` with ``nvcc``
(one process per source, all started together), linked into
``build/repro_torch_kernels/libpowercap.so`` at the repository root, and
loaded with ``ctypes`` through their plain C entry points.  A failed build
raises; nothing falls back to the plain versions.

``--fmad=false`` keeps every rounding of the kernels where the plain
PyTorch versions have it (no multiply-add is contracted), so the two
differ only in the order of their sums.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[4] / "build"
             / "repro_torch_kernels")
LIB_PATH = BUILD_DIR / "libpowercap.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

#: Dynamic shared memory one block may take on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the powercap kernels are built "
                           "with the CUDA toolkit at first use")
    return path


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in SRC_DIR.iterdir())


def build() -> tuple[float, str]:
    """Compile and link the library; returns ``(seconds, ptxas log)``."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking libpowercap.so failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded library, built first if missing or older than a source."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_double
        lib.powercap_waterfill.argtypes = [p] * 6 + [ll, i, i, p]
        lib.powercap_waterfill.restype = i
        lib.powercap_balance_caps.argtypes = [p] * 16 + [ll, i, i, i, d, i,
                                                         d, p]
        lib.powercap_balance_caps.restype = i
        lib.powercap_waterfill_segmented.argtypes = [p] * 8 + [ll, i, i, p]
        lib.powercap_waterfill_segmented.restype = i
        lib.powercap_balance_smem_bytes.argtypes = [i]
        lib.powercap_balance_smem_bytes.restype = ll
        lib.powercap_error_string.argtypes = [i]
        lib.powercap_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.powercap_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def waterfill(cap, fl, ce, w, act, out, iters: int) -> None:
    """Launch K1 over ``rows = cap.numel()`` rows of ``J`` slots."""
    lib = library()
    rows, j = cap.numel(), fl.shape[-1]
    rc = lib.powercap_waterfill(cap.data_ptr(), fl.data_ptr(),
                                ce.data_ptr(), w.data_ptr(), act.data_ptr(),
                                out.data_ptr(), rows, j, iters, _stream(fl))
    _check(lib, rc, "waterfill")


def waterfill_segmented(cap, layout, fl, ce, w, out, iters: int) -> None:
    """Launch K3 over the ``layout.starts.numel()`` rows of a CSR layout
    (:class:`repro_torch.kernels.powercap.segments.SegmentLayout`)."""
    lib = library()
    rc = lib.powercap_waterfill_segmented(
        cap.data_ptr(), layout.starts.data_ptr(), layout.counts.data_ptr(),
        layout.order.data_ptr(), fl.data_ptr(), ce.data_ptr(), w.data_ptr(),
        out.data_ptr(), layout.starts.numel(), layout.jb, iters,
        _stream(out))
    _check(lib, rc, "waterfill_segmented")


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
    _check(lib, rc, "balance_caps")
