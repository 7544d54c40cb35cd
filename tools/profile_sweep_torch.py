#!/usr/bin/env python3
"""Where the time of the port's sweep grids goes, on one GPU.

Builds path A (32 cells x 100 hosts, 60 ticks) and path B (16 cells x
1000 hosts, 120 ticks) as ``chip_smoke.py`` does, runs each engine once to
warm up, then once under ``torch.profiler`` and once without it.  For the
profiled run it reads the Chrome trace and reports the device's busy time
(union of kernel and copy intervals), its idle share of the run's wall,
kernel launches per tick, and device time by kernel name.  Prints one JSON
line per path and writes the Chrome traces to OUT_DIR (default
``build/profiles``).

    python3 tools/profile_sweep_torch.py [OUT_DIR]
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def profile(tag: str, specs, policies, out_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.sim.batch import BatchedSimulator
    from repro_torch.sim.sweep import build_batch_cells

    cells, _ = build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells)
    sim.run()                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    plain_wall = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        traced_wall = time.perf_counter() - t0
    trace = out_dir / f"trace_{tag}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    by_name = defaultdict(float)
    for e in kernels:
        name = e["name"].replace("(anonymous namespace)::", "")
        by_name[name.split("(")[0][:60]] += e["dur"]
    busy = busy_us(kernels + copies) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(path=tag, cells=len(cells), ticks=res.ticks,
                pack_s=sim.pack_s, run_s_untraced=plain_wall,
                run_s_traced=traced_wall, device_busy_s=busy,
                device_idle_share=1.0 - busy / traced_wall,
                kernel_launches=len(kernels),
                launches_per_tick=len(kernels) / res.ticks,
                device_ms_by_kernel={k: v * 1e-3 for k, v in top})


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sim.sweep import scenario_families

    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        ROOT / "build" / "profiles")
    out_dir.mkdir(parents=True, exist_ok=True)
    print(torch.cuda.get_device_name(0), flush=True)
    spikes = ("flat", "burst", "step", "prime")
    paths = {
        "A": scenario_families(sizes=(100,), budgets_per_host_w=(230.0, 250.0),
                               spikes=spikes, heterogeneous=(False, True),
                               duration_s=600.0),
        "B": scenario_families(sizes=(1000,), budgets_per_host_w=(250.0,),
                               spikes=spikes, heterogeneous=(False, True),
                               duration_s=1200.0),
    }
    for tag, specs in paths.items():
        print(json.dumps(profile(tag, specs, ("cpc", "static"), out_dir)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
