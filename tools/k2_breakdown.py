#!/usr/bin/env python3
"""Where kernel K2's time goes on the card, from SM cycle counters.

Copies the powercap sources to ``build/k2_breakdown/`` with timers added
to ``balance.cu`` and builds them into
``build/repro_torch_kernels/libpowercap_timed.so`` (the library the port
runs is not touched).  In the copy, thread 0 of block 0 (rank 0 of cell
0's cluster) reads ``clock64()`` around each candidate-cap waterfill
(``entitlements``, with the barrier after it), around each cluster
exchange (``cluster_sum``) and around the whole kernel.  K2 then runs
through ``ops.balance_caps`` at paths A's, B's and V's shapes on
``chip_smoke.kernel_inputs`` (the inputs ``chip_smoke.py`` checks), each
held against its plain version first, five timed launches each, and the
script prints one JSON line a shape: cell 0's rounds, the cycles of a
launch by part (waterfills, exchanges, the rest of the round: host
columns, the strided loops and their divisions) and per call, the plan,
and the kernel's device time by ``chip_smoke.device_ms``.

    python3 tools/k2_breakdown.py
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"A": (32, 100, 10, 100), "B": (16, 1000, 10, 100),
          "V": (1, 1000, 10, 200)}


def _edit(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"balance.cu no longer has {old.strip()!r} "
                           f"{count} time(s): update this script")
    return text.replace(old, new)


def timed_sources(out: Path) -> Path:
    """The powercap sources with K2's timers, written to ``out``."""
    src = ROOT / "src/repro_torch/kernels/powercap/csrc"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lead = "if (blockIdx.x == 0 && threadIdx.x == 0)"
    for f in src.iterdir():
        t = f.read_text()
        if f.name == "balance.cu":
            t = _edit(t, "namespace {\n",
                      "__device__ unsigned long long g_cycles[6];\n"
                      "namespace {\n")
            t = _edit(t, "int& buf, int c, int live) {\n",
                      "int& buf, int c, int live) {\n"
                      "  const unsigned long long t_x = clock64();\n")
            t = _edit(t, "  buf ^= 1;\n}",
                      f"  buf ^= 1;\n  {lead} {{\n"
                      "    g_cycles[1] += clock64() - t_x;\n"
                      "    g_cycles[4] += 1;\n  }\n}")
            calls = (r"entitlements<G, K, kThreads>\([^;]*;\n"
                     r"\s*__syncthreads\(\);")
            if len(re.findall(calls, t)) != 2:
                raise RuntimeError("balance.cu's entitlements calls moved: "
                                   "update this script")
            t = re.sub(calls, lambda m: (
                "{ const unsigned long long t_e = clock64();\n"
                f"{m.group(0)}\n  {lead} {{ g_cycles[0] += clock64() - t_e;"
                " g_cycles[5] += 1; } }"), t)
            t = _edit(t, "  const int c = cluster_blocks();\n",
                      "  const unsigned long long t_k = clock64();\n"
                      "  const int c = cluster_blocks();\n")
            t = _edit(t, "  cluster_sync();\n}\n",
                      f"  cluster_sync();\n  {lead} {{\n"
                      "    g_cycles[2] += clock64() - t_k;\n"
                      "    g_cycles[3] += rounds;\n  }\n}\n")
            t += ('\nextern "C" int k2_cycles(unsigned long long* out, '
                  'int reset) {\n  unsigned long long z[6] = {0};\n'
                  '  return static_cast<int>(reset ? cudaMemcpyToSymbol('
                  'g_cycles, z, sizeof(z)) : cudaMemcpyFromSymbol(out, '
                  'g_cycles, sizeof(z)));\n}\n')
        (out / f.name).write_text(t)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.kernels import BalanceParams
    from repro_torch.kernels._build import KernelLibrary
    from repro_torch.kernels.powercap import kernel, ops, ref

    lib = KernelLibrary("powercap_timed",
                        timed_sources(ROOT / "build" / "k2_breakdown"),
                        kernel._bind, "powercap_error_string",
                        extra_flags=("--fmad=false",))
    lib.build()
    kernel.LIBRARY = lib
    kernel.max_active_clusters.cache_clear()
    counters = lib.library().k2_cycles
    counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    reps = 5
    for tag, (s, h, j, iters) in SHAPES.items():
        x = cs.kernel_inputs(s, h, j, seed=s * 7919 + h, dev=dev,
                             iters=iters)
        args = (x["hosts"], x["caps"], x["dense"], x["cpu_res"],
                x["budget"], x["enabled"], BalanceParams())
        want = ref.balance_caps_ref(*args)
        got = ops.balance_caps(*args)
        torch.cuda.synchronize()
        if not (torch.allclose(got[0], want[0], rtol=1e-9, atol=0.0)
                and torch.equal(got[2], want[2])):
            raise AssertionError(f"{tag}: the timed copy of K2 disagrees "
                                 f"with the plain version")
        buf = (ctypes.c_ulonglong * 6)()
        counters(buf, 1)
        for _ in range(reps):
            ops.balance_caps(*args)
        torch.cuda.synchronize()
        counters(buf, 0)
        ent, exch, total, rounds, n_exch, n_ent = (v / reps for v in buf)
        plan = kernel.balance_plan(s, h, j, kernel.max_active_clusters(j))
        print(json.dumps(dict(
            shape=tag, rounds_cell0=rounds, cycles=total, waterfills=ent,
            exchanges=exch, rest=total - ent - exch, waterfill_calls=n_ent,
            exchange_calls=n_exch, cycles_a_waterfill=ent / max(n_ent, 1),
            cycles_an_exchange=exch / max(n_exch, 1),
            plan=str(plan), device_ms=cs.device_ms(
                lambda: ops.balance_caps(*args), "balance_caps_kernel"))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
