"""Build and bind the powercap CUDA kernels (``csrc/``).

At first use the ``.cu`` sources are compiled for ``sm_90a`` into
``build/repro_torch_kernels/libpowercap.so`` at the repository root by the
shared helper (:mod:`repro_torch.kernels._build`) and loaded with
``ctypes`` through their plain C entry points.  A failed build raises;
nothing falls back to the plain versions.

``--fmad=false`` keeps every rounding of the kernels where the plain
PyTorch versions have it (no multiply-add is contracted), so the two
differ only in the order of their sums.

The three kernels share one row routine (``csrc/waterfill.cuh``), whose
layout :func:`row_shape` names.  :func:`balance_plan` is the one place
that chooses how K2 runs: the cluster of blocks a cell takes, the threads
a block and its shared memory, from the shape and the clusters the card
can hold at once (:func:`max_active_clusters`, asked of the library once
for each size); nothing is chosen by trying.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary, stream as _stream

#: Dynamic shared memory one block may take on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448
#: The largest thread-block cluster Hopper launches (sizes above 8 are
#: non-portable, allowed by a function attribute).
MAX_CLUSTER = 16
# K2's shared memory (csrc/balance.cu: smem_bytes): 32 warps' partials of
# exchanges of up to 4 sums, two exchange slots and the exchange's result,
# then 14 doubles and one flag a host.
_SMEM_FIXED_DOUBLES = 32 * 4 + 3 * 4
_HOST_BYTES = 14 * 8 + 1


def row_shape(j: int) -> tuple[int, int]:
    """``(G, K)`` of a row of ``j >= 1`` slots in the shared row routine:
    ``G`` lanes a row (the next power of two at or above ``j``, 4 to 32)
    and ``K`` slots a lane held in registers (``j / 32`` up to 256 slots;
    0 past that: the row is streamed from memory on every trip)."""
    if j < 1:
        raise ValueError(f"a row needs at least one slot, not {j}")
    g = 4
    while g < min(j, 32):
        g *= 2
    if j <= 32:
        return g, 1
    for k in (2, 4, 8):
        if j <= 32 * k:
            return 32, k
    return 32, 0


def balance_threads(j: int) -> int:
    """K2's threads a block for rows of ``j`` slots: 1,024, or 512 where a
    lane holds 4 or 8 slots in registers (their fp64 values need more than
    the 64 registers a thread of a 1,024-thread block has)."""
    return 512 if row_shape(j)[1] in (4, 8) else 1024


def balance_smem_bytes(hosts: int) -> int:
    """K2's dynamic shared memory for a block that owns ``hosts`` hosts."""
    return 8 * _SMEM_FIXED_DOUBLES + _HOST_BYTES * hosts


#: The most hosts one block of K2 holds in its shared memory.
MAX_HOSTS_A_BLOCK = (MAX_SMEM_BYTES - 8 * _SMEM_FIXED_DOUBLES) // _HOST_BYTES


@dataclasses.dataclass(frozen=True)
class BalancePlan:
    """How one launch of K2 runs: ``cluster`` blocks a cell (a
    thread-block cluster), each owning ``hosts`` consecutive hosts (the
    last may own fewer) with ``threads`` threads and ``smem_bytes`` of
    dynamic shared memory (the launch checks both against the kernel's
    own counts)."""

    cluster: int
    hosts: int
    threads: int
    smem_bytes: int


def balance_limit(max_active_clusters: tuple) -> int:
    """The most hosts a cell may have: the largest cluster that the card
    can hold at all, times :data:`MAX_HOSTS_A_BLOCK`."""
    sizes = [c for c, n in enumerate(max_active_clusters, 1) if n >= 1]
    return max(sizes, default=0) * MAX_HOSTS_A_BLOCK


@functools.lru_cache(maxsize=256)
def balance_plan(s: int, h: int, j: int,
                 max_active_clusters: tuple) -> BalancePlan:
    """The plan of K2 for ``s`` cells of ``h`` hosts and rows of ``j``
    slots, given ``max_active_clusters[c - 1]``, the clusters of ``c``
    blocks the card can hold at once (``c`` up to :data:`MAX_CLUSTER`).

    The cluster is the smallest whose blocks hold ``ceil(h / c)`` hosts
    each in shared memory, then widened while ``s`` clusters of the next
    size are resident at once and every block keeps a host: fewer hosts a
    block means fewer warps sharing an SM's shuffle and fp64 issue, which
    bound the candidate-cap waterfills.  Raises ValueError above
    :func:`balance_limit`."""
    limit = balance_limit(max_active_clusters)
    if h > limit:
        raise ValueError(
            f"balance_caps kernel: {h} hosts a cell exceed the limit of "
            f"{limit} ({MAX_HOSTS_A_BLOCK} hosts in each block's shared "
            f"memory, clusters of at most "
            f"{limit // MAX_HOSTS_A_BLOCK} blocks on this card)")
    c = min(c for c, n in enumerate(max_active_clusters, 1)
            if n >= 1 and -(-h // c) <= MAX_HOSTS_A_BLOCK)
    while (c < len(max_active_clusters) and max_active_clusters[c] >= s
           and c < h):
        c += 1
    hosts = -(-h // c)
    return BalancePlan(c, hosts, balance_threads(j),
                       balance_smem_bytes(hosts))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.powercap_waterfill.argtypes = [p] * 6 + [ll, i, i, i, p]
    lib.powercap_waterfill.restype = i
    lib.powercap_balance_caps.argtypes = [p] * 16 + [ll, i, i, i, d, i, d,
                                                     i, i, ll, i, p]
    lib.powercap_balance_caps.restype = i
    lib.powercap_waterfill_segmented.argtypes = [p] * 8 + [ll, i, i, i, p]
    lib.powercap_waterfill_segmented.restype = i
    lib.powercap_balance_max_active_clusters.argtypes = [
        i, i, ll, i, ctypes.POINTER(i)]
    lib.powercap_balance_max_active_clusters.restype = i


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
                                out.data_ptr(), rows, j, iters,
                                fl.device.index, _stream(fl))
    LIBRARY.check(rc, "waterfill")


def waterfill_segmented(cap, layout, fl, ce, w, out, iters: int) -> None:
    """Launch K3 over the ``layout.starts.numel()`` rows of a CSR layout
    (:class:`repro_torch.kernels.powercap.segments.SegmentLayout`)."""
    lib = library()
    rc = lib.powercap_waterfill_segmented(
        cap.data_ptr(), layout.starts.data_ptr(), layout.counts.data_ptr(),
        layout.order.data_ptr(), fl.data_ptr(), ce.data_ptr(), w.data_ptr(),
        out.data_ptr(), layout.starts.numel(), layout.jb, iters,
        out.device.index, _stream(out))
    LIBRARY.check(rc, "waterfill_segmented")


@functools.lru_cache(maxsize=64)
def max_active_clusters(j: int, device=None) -> tuple[int, ...]:
    """Clusters of 1 to :data:`MAX_CLUSTER` blocks of K2 (rows of ``j``
    slots) that card ``device`` (an index; ``None``: the current one)
    holds at once, as the CUDA occupancy calculator answers for a block's
    largest shared memory (so each answer holds for every plan); 0 for a
    size the card cannot launch."""
    lib = library()
    if device is None:
        device = torch.cuda.current_device()
    smem = balance_smem_bytes(MAX_HOSTS_A_BLOCK)
    out = []
    for c in range(1, MAX_CLUSTER + 1):
        n = ctypes.c_int(0)
        rc = lib.powercap_balance_max_active_clusters(j, c, smem, device,
                                                      ctypes.byref(n))
        out.append(n.value if rc == 0 else 0)
    return tuple(out)


def balance_caps(tensors, caps_out, did_out, rounds_out, *, iters: int,
                 params, plan: BalancePlan) -> None:
    """Launch K2 as ``plan`` has it; ``tensors`` are the 13 inputs in the
    C entry's order."""
    lib = library()
    s, h = caps_out.shape
    j = tensors[5].shape[-1]
    rc = lib.powercap_balance_caps(
        *(t.data_ptr() for t in tensors), caps_out.data_ptr(),
        did_out.data_ptr(), rounds_out.data_ptr(), s, h, j, iters,
        float(params.imbalance_threshold), int(params.max_iters),
        float(params.min_transfer), plan.cluster, plan.threads,
        plan.smem_bytes, caps_out.device.index, _stream(caps_out))
    LIBRARY.check(rc, "balance_caps")
