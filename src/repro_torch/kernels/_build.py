"""Build a kernel package's CUDA sources into a shared library and load it.

Each kernel package (``powercap``, ``flash_attention``,
``decode_attention``, ``moe_gmm``, ``ssd_scan``) owns one
:class:`KernelLibrary`.  At
first use its ``csrc/*.cu`` sources are compiled for ``sm_90a`` with
``nvcc`` (one process per source, all started together), linked into
``build/repro_torch_kernels/lib<name>.so`` at the repository root, and
loaded with ``ctypes`` through their plain C entry points; processes that
find a library stale at once (ranks sharing a card) take turns on a file
lock, and only the first builds it.  Headers shared
between packages live in ``kernels/include/`` (:data:`INCLUDE_DIR`); a
library that names it is rebuilt when any of its files changes.  A package
builds only its own sources, so a run that launches only the powercap
kernels compiles no attention code.  A failed build raises; nothing falls
back to the plain versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
#: Headers shared by several packages' sources (``sm90.cuh``).
INCLUDE_DIR = Path(__file__).resolve().parent / "include"


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a ``ctypes`` int
    (read raw: a ``torch.cuda.Stream`` object for each launch costs
    microseconds of host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


class KernelLibrary:
    """One package's ``csrc/`` built into ``lib<name>.so``.

    ``bind(lib)`` declares the entry points' ``argtypes`` and ``restype``;
    ``error_fn`` names the library's ``const char *(int)`` that spells a
    CUDA error code; ``include_dirs`` are passed to ``nvcc`` as ``-I``.
    """

    def __init__(self, name: str, src_dir: Path, bind: Callable,
                 error_fn: str, extra_flags: tuple = (),
                 include_dirs: tuple = ()):
        self.name = name
        self.src_dir = src_dir
        self.include_dirs = tuple(Path(p) for p in include_dirs)
        self.lib_path = BUILD_DIR / f"lib{name}.so"
        self.flags = (BASE_FLAGS + tuple(extra_flags)
                      + tuple(f"-I{p}" for p in self.include_dirs))
        self._bind = bind
        self._error_fn = error_fn
        self._lib = None

    def _stale(self) -> bool:
        if not self.lib_path.exists():
            return True
        built = self.lib_path.stat().st_mtime
        return any(p.stat().st_mtime > built
                   for d in (self.src_dir, *self.include_dirs)
                   for p in d.iterdir())

    def build(self) -> tuple[float, str]:
        """Compile and link the library; returns ``(seconds, ptxas log)``."""
        exe = nvcc()
        obj_dir = self.lib_path.parent / self.name
        obj_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in sorted(self.src_dir.glob("*.cu")):
            obj = obj_dir / (src.stem + ".o")
            cmd = [exe, *self.flags, "-Xptxas", "-v", "-c", str(src),
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
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [exe, *self.flags, "-shared", *(str(o) for _, o, _ in procs),
             "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {self.lib_path.name} failed:\n"
                               f"{link.stdout}")
        os.replace(tmp, self.lib_path)
        return time.perf_counter() - t0, "\n".join(logs)

    def ensure_built(self) -> bool:
        """Build the library if it is missing or older than a source;
        returns whether this call built it.  The check and the build run
        under an exclusive ``flock`` on ``<name>.lock`` beside the library,
        and the check runs again once the lock is held, so of several
        processes that find the library stale only the first builds it and
        none links or loads another's half-written objects."""
        if not self._stale():
            return False
        self.lib_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.lib_path.parent / f"{self.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not self._stale():
                return False
            self.build()
            return True

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if missing or older than a
        source (:meth:`ensure_built`)."""
        if self._lib is None:
            self.ensure_built()
            lib = ctypes.CDLL(str(self.lib_path))
            self._bind(lib)
            err = getattr(lib, self._error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise on a nonzero launch code."""
        if rc != 0:
            msg = getattr(self.library(), self._error_fn)(rc).decode()
            raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                               f"{rc} ({msg})")
