#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 cpcbench/run.py --workload granite_8b.long_prompt --seed 7 \\
        --seconds 40 --trace 0

The cell's files are found by the names in ``BENCHMARK.json`` at the root
of the checkout; the program is ``src/repro_torch``, whose kernels build
into ``build/repro_torch_kernels/`` in the checkout's first run.  Prints
the numbers the correctness check compared on standard error, then one
JSON line on standard output: ``--trace 0`` the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.  Exits non-zero, printing no
result, where there is no CUDA card or too few, or where ``jax``,
``jaxlib``, ``flax``, the JAX package ``repro`` or ``benchmarks`` is
loaded once the window has closed.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def started_before() -> float:
    """Seconds from the process's start to ``CLOCK0``'s reading (0 where
    ``/proc`` does not say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0.0
    return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK")
               - (time.perf_counter() - CLOCK0))


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "cpcbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from cpcbench import harness, spec

    cell = spec.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cpcbench: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    def say(line: str) -> None:
        print(f"cpcbench: {line}", file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0),
                         CLOCK0 - started_before(), say)
    found = loaded_forbidden()
    if found:
        print(f"cpcbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
