#!/usr/bin/env python3
"""Where the time of the port's paths goes, on one GPU.

Builds path A (32 cells x 100 hosts, 60 ticks) and path B (16 cells x
1000 hosts, 120 ticks) of the batched engine, path D (``sweep_grid_dpm``'s
32 churn cells x 100 hosts, 100 ticks of 15 s, slot slack 1.5: DPM,
scripted events and Powercap Redistribution in the batched engine's churn
program), paths G and X (``sweep_grid_rules``'s and ``sweep_grid_timed``'s
32 cells x 100 hosts, 60 ticks, slot slack 1.5: constraint correction, the
hill-climb balancer and, on X, gated timed vMotions in the churn program;
they also report the loop's device-to-host reads a tick, ``any(can)`` and
the migration layer's one a round), path V (one cpc cell of 1000 hosts,
60 ticks, on the vector engine), as ``chip_smoke.py`` does (they report
K1's, K2's and K3's device ms per launch),
and path S, one replica batch of the serving path at granite-8b's full
width and depth in bf16 (8 prompts of 512, 32 tokens, a 1024-position
cache): ``S`` is the whole generation (prefill and 31 decode steps, its
"ticks" the 32 forward passes), ``Sd`` the 31 decode steps alone; ``M``
and ``Md`` the same for path M, OLMoE-1B-7B at full width and depth in
bf16 (its expert FFN on kernel K7; they also report K7's device ms per
launch for each regime's kernel: ``gmm_wide_kernel`` at prefill,
``gmm_narrow_kernel`` in the decode steps); ``P`` and ``Pd``, ``H`` and
``Hd`` the same for paths P and H, Mamba2-2.7B and Zamba2-7B at full width
and depth in bf16 (their SSD scans on kernel K8 at prefill, Zamba2's
shared attention on K4 and K6; they report K8's two kernels' device ms per
launch, and the decode paths K6's partials and combine kernels'); and
path T, one training step of MiniCPM-2B at full width and depth in bf16
(4 x 4096 tokens, remat, AdamW; its "tick" the step; it reports K4's and
K5's tensor-core kernels' device ms per launch); and paths TM, TP and TH,
one training step of OLMoE-1B-7B (8 of its 16 layers), Mamba2-2.7B (all
64) and Zamba2-7B (36 of its 81) at full width in bf16, as
``chip_smoke.py`` cuts them (4 x 4096 tokens in the configs' own
microbatches, remat, AdamW): they report K7's backward launches (the wide
kernel reading ``W^T`` for dX and ``X^T`` for dW) and K8b's, each
regime's, device ms per launch, and TP and TH the CUDA-event time at the
path's shape of what follows K8b for B and C: the cast of its per-head
float32 dB and dC to bf16 and autograd's sum over the heads that share
one row.  Each
path runs once to warm up, then five times without ``torch.profiler``
(``run_s_untraced`` is their median, beside their least and most) and
once under it.  For the profiled run it reads the Chrome trace and reports
the device's busy time (union of kernel and copy intervals,
``cpcbench.trace.busy_ns``), its idle
share of the run's wall, kernel launches per tick (per forward pass for
the serving paths), and device time by kernel name.  Prints one JSON line
per path and writes the Chrome traces to OUT_DIR (default
``build/profiles``).

    python3 tools/profile_sweep_torch.py [OUT_DIR [PATH ...]]

PATH is any of A, B, D, G, X, V, S, Sd, M, Md, P, Pd, H, Hd, T, TM, TP
and TH (default all but the last three).  Every path also reports the 25
kernels with the most launches in its traced run (``launches_top``).
"""

from __future__ import annotations

import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def batch_runner(specs, policies, slot_slack: float = 2.0):
    """``(prepare, info)``: ``prepare()`` returns a run of the grid's
    simulator (with the sweeps' balancer), which returns the ticks it ran
    and leaves the loop's reads a tick in ``info``."""
    from repro_torch.sim.batch import BatchedSimulator
    from repro_torch.sim.sweep import build_batch_cells, grid_balancer

    cells, _ = build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=slot_slack,
                           balancer=grid_balancer(specs))
    info = dict(cells=len(cells), pack_s=sim.pack_s)

    def run():
        ticks = sim.run().ticks
        info.update(reads_per_tick=sim.info.get("branch_reads", 0) / ticks,
                    migration_reads=sim.info.get("migration_reads", 0))
        return ticks
    return (lambda: run), info


def vector_runner(specs, policies):
    """``(prepare, info)``: ``prepare()`` builds every cell's simulator
    anew (a simulator runs once) and returns their run."""
    from repro_torch.sim.engine import VectorSimulator
    from repro_torch.sim.sweep import _sweep_manager, build_sweep

    def prepare():
        sims = []
        for spec in specs:
            for p in policies:
                snap, traces, cfg = build_sweep(spec, p)
                sims.append(VectorSimulator(snap, _sweep_manager(p), traces,
                                            cfg))
        ticks = int(round(cfg.duration_s / cfg.tick_s))

        def run():
            for sim in sims:
                sim.run()
            return ticks * len(sims)
        return run

    return prepare, dict(cells=len(specs) * len(policies))


def serve_runner(model: dict, arch: str, decode_only: bool):
    """``(prepare, info)`` for path S (``arch`` granite_8b), M
    (olmoe_1b_7b), P (mamba2_2p7b) or H (zamba2_7b), ``decode_only`` for
    Sd, Md, Pd or Hd; ``model`` caches one arch's parameters between the
    two."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)

    dev = torch.device("cuda")
    if model.get("arch") != arch:
        model.clear()
        torch.cuda.empty_cache()
        cfg = configs.get(arch)
        model.update(arch=arch, cfg=cfg, params=tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev))
    cfg, params = model["cfg"], model["params"]
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    steps, max_len = 32, 1024

    def prepare():
        if not decode_only:
            return lambda: (generate(cfg, params, prompts, steps, max_len),
                            steps)[1]
        decode = make_decode_step(cfg)
        logits, state = make_prefill_step(cfg, max_len)(params, prompts)

        def run():
            nonlocal logits, state
            for _ in range(steps - 1):
                logits, state = decode(params, state, logits.argmax(-1))
            return steps - 1
        return run

    return prepare, dict(arch=arch, batch=8, prompt_len=512, steps=steps,
                         decode_only=decode_only)


def event_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def bc_fold_ms(cfg) -> dict:
    """What runs after K8b for B and C at a training path's shape (one
    sequence of 4096 a microbatch): ``SSDChunk.backward`` casts K8b's
    per-head float32 dB and dC to bf16, and autograd sums each over the
    heads that share one row (the expand's backward); CUDA events."""
    dev = torch.device("cuda")
    shape = (1, 4096, cfg.n_ssm_heads, cfg.ssm_state)
    db = torch.randn(shape, device=dev)
    dc = torch.randn(shape, device=dev)
    cast = [g.to(torch.bfloat16) for g in (db, dc)]
    return dict(
        bc_cast_ms=event_ms(lambda: [g.to(torch.bfloat16)
                                     for g in (db, dc)]),
        bc_head_sum_ms=event_ms(lambda: [g.sum(2, keepdim=True)
                                         for g in cast]),
        bc_fold_shape=list(shape))


def train_runner(arch: str = "minicpm_2b", n_layers: int | None = None):
    """``(prepare, info)`` for path T (or, with ``arch`` and the depth
    ``n_layers`` kept, TM, TP and TH): ``prepare()`` returns one training
    step on a fixed batch (the state carries over between steps)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_train_step)

    dev = torch.device("cuda")
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    opt = AdamW(learning_rate=3e-4, state_dtype=cfg.optimizer_state_dtype)
    state = [init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)]
    b = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4096,
                        global_batch=4, seed=1, device=dev).next_batch()
    batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    step = make_train_step(cfg, opt)

    def prepare():
        def run():
            state[0], _ = step(state[0], batch)
            return 1
        return run

    info = dict(arch=arch, batch=4, seq_len=4096, n_layers=cfg.n_layers,
                microbatches=cfg.microbatches)
    if cfg.family in ("ssm", "hybrid"):
        info.update(bc_fold_ms(cfg))
    return prepare, info


#: Kernels whose device ms per launch a profile reports, by name in the
#: trace (K1's, K2's and K3's calls are one launch each; K4's and K7's one
#: launch of one of their regimes' kernels; K5's, K6's and K8's one launch
#: of each of their two kernels: K6's partials and combine, K8's
#: intra-chunk and state kernels: on bf16 paths the tensor-core regime's,
#: in float32 the CUDA-core ones; K7's wide kernel also by its layout, the
#: forward's and the backward's dX and dW; K8b's one launch of a regime's
#: kernel).
PER_LAUNCH = {"k1": "waterfill_kernel", "k2": "balance_caps_kernel",
              "k3": "segmented_kernel",
              "k7_wide": "gmm_wide_kernel", "k7_narrow": "gmm_narrow_kernel",
              "k7_wide_fwd": "gmm_wide_kernel<0, 0>",
              "k7_wide_dx": "gmm_wide_kernel<0, 1>",
              "k7_wide_dw": "gmm_wide_kernel<1, 0>",
              "k8b_tc": "ssd_bwd_tc_kernel", "k8b_cuda_core": "ssd_bwd_kernel",
              "k7_cuda_core": "gmm_kernel",
              "k8_intra": "ssd_intra_shared_kernel",
              "k8_state": "ssd_state_tc_kernel",
              "k8_intra_cuda_core": "ssd_intra_kernel",
              "k8_state_cuda_core": "ssd_state_kernel",
              "k4": "flash_fwd_tc_kernel",
              "k4_cuda_core": "flash_fwd_kernel",
              "k5_dkdv": "flash_bwd_dkdv_tc_kernel",
              "k5_dq": "flash_bwd_dq_tc_kernel",
              "k6_partials": "decode_partials_kernel",
              "k6_combine": "decode_combine_kernel"}


#: Untraced runs of a path; ``run_s_untraced`` is their median.
UNTRACED_RUNS = 5


def timed(run) -> tuple[int, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = run()
    torch.cuda.synchronize()
    return ticks, time.perf_counter() - t0


def profile(tag: str, runner, out_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from cpcbench.trace import busy_ns

    prepare, info = runner
    timed(prepare())                           # warm-up
    runs = [timed(prepare()) for _ in range(UNTRACED_RUNS)]
    ticks = runs[0][0]
    plain = sorted(wall for _, wall in runs)
    run = prepare()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        _, traced_wall = timed(run)
    trace = out_dir / f"trace_{tag}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in kernels:
        name = e["name"].replace("(anonymous namespace)::", "")
        key = name.split("(")[0][:60]
        by_name[key] += e["dur"]
        count[key] += 1
    busy = busy_ns((e["ts"], e["ts"] + e["dur"])
                   for e in kernels + copies) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    most = sorted(count.items(), key=lambda kv: -kv[1])[:25]
    for key, pattern in PER_LAUNCH.items():
        durs = [e["dur"] for e in kernels if pattern in e["name"]]
        if durs:
            info = dict(info, **{
                f"{key}_launches": len(durs),
                f"{key}_device_ms_per_launch": sum(durs) * 1e-3 / len(durs),
                f"{key}_device_ms": sum(durs) * 1e-3})
    return dict(path=tag, ticks=ticks,
                run_s_untraced=plain[len(plain) // 2],
                run_s_untraced_min=plain[0], run_s_untraced_max=plain[-1],
                run_s_traced=traced_wall, device_busy_s=busy,
                device_idle_share=1.0 - busy / traced_wall,
                kernel_launches=len(kernels),
                launches_per_tick=len(kernels) / ticks,
                device_ms_by_kernel={k: v * 1e-3 for k, v in top},
                launches_by_kernel={k: count[k] for k, _ in top},
                launches_top=dict(most), **info)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch.sim.sweep import scale_ladder, scenario_families

    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        ROOT / "build" / "profiles")
    out_dir.mkdir(parents=True, exist_ok=True)
    wanted = sys.argv[2:] or ["A", "B", "D", "G", "X", "V", "S", "Sd", "M",
                              "Md", "P", "Pd", "H", "Hd", "T"]
    model: dict = {}
    print(torch.cuda.get_device_name(0), flush=True)
    spikes = ("flat", "burst", "step", "prime")
    paths = {
        "A": lambda: batch_runner(scenario_families(
            sizes=(100,), budgets_per_host_w=(230.0, 250.0), spikes=spikes,
            heterogeneous=(False, True), duration_s=600.0),
            ("cpc", "static")),
        "B": lambda: batch_runner(scenario_families(
            sizes=(1000,), budgets_per_host_w=(250.0,), spikes=spikes,
            heterogeneous=(False, True), duration_s=1200.0),
            ("cpc", "static")),
        "D": lambda: batch_runner(scenario_families(
            sizes=(100,), budgets_per_host_w=(250.0,),
            spikes=("burst", "prime"), heterogeneous=(False, True),
            churns=("none", "dpm", "maintenance", "failure"),
            duration_s=1500.0, tick_s=15.0), ("cpc", "static"),
            slot_slack=1.5),
        "G": lambda: batch_runner(scenario_families(
            sizes=(100,), budgets_per_host_w=(250.0,), spikes=spikes,
            heterogeneous=(False, True),
            rules=("violation_burst", "cap_blocked"), duration_s=600.0,
            tick_s=10.0), ("cpc", "static"), slot_slack=1.5),
        "X": lambda: batch_runner(scenario_families(
            sizes=(100,), budgets_per_host_w=(250.0,),
            spikes=("burst", "prime"), heterogeneous=(False, True),
            churns=("timed_churn", "failure_cascade"),
            rules=("none", "violation_burst"), duration_s=600.0,
            tick_s=10.0), ("cpc", "static"), slot_slack=1.5),
        "V": lambda: vector_runner(scale_ladder(
            sizes=(1000,), spike="burst", duration_s=600.0), ("cpc",)),
        "S": lambda: serve_runner(model, "granite_8b", decode_only=False),
        "Sd": lambda: serve_runner(model, "granite_8b", decode_only=True),
        "M": lambda: serve_runner(model, "olmoe_1b_7b", decode_only=False),
        "Md": lambda: serve_runner(model, "olmoe_1b_7b", decode_only=True),
        "P": lambda: serve_runner(model, "mamba2_2p7b", decode_only=False),
        "Pd": lambda: serve_runner(model, "mamba2_2p7b", decode_only=True),
        "H": lambda: serve_runner(model, "zamba2_7b", decode_only=False),
        "Hd": lambda: serve_runner(model, "zamba2_7b", decode_only=True),
        "T": train_runner,
        "TM": lambda: train_runner("olmoe_1b_7b", 8),
        "TP": lambda: train_runner("mamba2_2p7b"),
        "TH": lambda: train_runner("zamba2_7b", 36),
    }
    for tag in wanted:
        if tag.startswith("T"):
            model.clear()              # the serving weights, 14-17 GB
            gc.collect()               # the last training state, if any
            torch.cuda.empty_cache()
        print(json.dumps(profile(tag, paths[tag](), out_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
