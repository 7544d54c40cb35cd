#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which raises (and so exits non-zero) when it fails:

1. the card: its name and power limit, as ``nvidia-smi`` prints them;
2. the build: ``nvcc`` compiles the five kernel libraries from their
   ``csrc/`` (powercap, flash_attention, decode_attention, moe_gmm,
   ssd_scan), every source at once;
3. each powercap kernel against its plain PyTorch version on the card, in
   fp64, at the main paths' shapes, timed with CUDA events (median of 20)
   and, for K1 and K2, by their device time under ``torch.profiler`` (the
   profile tool's reading), with K2's plan (cluster size, threads, shared
   memory): K1 and K2 at paths A, B, D and R, at path U's widest pad
   bucket ``(12, 1024, 16)`` and at path C's ``(2, 16384, 16)``, K2 at
   paths V and W (one cell) and on one cell of 10,000 hosts (the
   reference's ``datacenter_cell``), each with round counts and ``did``
   flags equal to the plain version's; K3 at paths V and W and on a
   ragged case
   (empty hosts, a host whose floors exceed its capacity, a 256-wide row,
   huge values in the rows next to each row); K3 and K2 (bitwise) at each
   of path E's shapes, on the inputs that E's CPU runs of ``headroom``
   and ``flexible`` on the legacy engine gave them; then rows of every shape
   the row routine has: K1 and K2 at 3, 40, 100 and 300 slots a row, K3
   at rows of 300 and 1,000 items (streamed from memory);
4. main path A, the ``sweep_grid`` grid (32 cells x 100 hosts x 10 VMs),
   through ``run_sweep_batched`` (the exact pack) on the card, held against
   the same grid run on the CPU (plain versions), with every kernel's
   launch count checked;
5. main path B, 16 cells x 1000 hosts x 10 VMs over 120 ticks, with one
   spec's two cells held against a CPU run of those two cells alone;
6. main path V, the top rung of the ``sweep_scale`` ladder (1000 hosts x
   10 VMs, burst, 60 ticks, policies cpc and static) through
   ``run_sweep(..., engine="vector")`` on the card, held against the same
   cells on the CPU and against the batched engine on the card, with the
   launch counts of K3 (one a tick, two more for each committed balance's
   note) and K2 (one a cpc invocation) checked;
6b. main path D, ``sweep_grid_dpm``'s grid (``benchmarks/run.py:282``,
   32 cells x 100 hosts x 10 VMs: churn none, dpm, maintenance and
   failure, 1500 s at 15 s ticks, slot slack 1.5) through
   ``run_sweep_batched`` on the card (the churn program: DPM, Powercap
   Redistribution, evacuations, scripted events), held against the same
   grid on the CPU: exact counts, payload and energy 1e-9, final power
   states, occupancy and caps equal, the budget within 1e-6, power-offs,
   power-ons and
   vMotions in the grid, K1's and K2's launches equal to the CPU run's
   plain calls; its cells/s, branch reads a tick, launches a tick and
   the device's idle share (one traced run) printed;
6c. path W, the vector engine on that grid's first two ``dpm`` specs and
   its burst homogeneous ``maintenance`` and ``failure`` specs, cpc and
   static, held against the CPU and against path D, K3 and K2 launches
   equal to the CPU run's plain calls, ticks/s printed;
6d. path R, ``row_contention_specs(sizes=(100,))`` (a two-row budget
   tree) on both engines, each held against the CPU, ``over_tree``
   within 1e-6;
6e. main path G, ``sweep_grid_rules``'s grid (``benchmarks/run.py:347``,
   32 cells x 100 hosts x 10 VMs: rules violation_burst and cap_blocked,
   4 spikes, both host mixes, 600 s at 10 s ticks, slot slack 1.5), and
   main path X, ``sweep_grid_timed``'s (``:409``: churn timed_churn and
   failure_cascade, rules none and violation_burst, gated timed vMotions
   of 2 slots a host and a bandwidth of 8) through ``run_sweep_batched``
   on the card (the churn program with constraint
   correction, the hill-climb balancer and, on X, the in-flight table),
   each held against the same grid on the CPU as path D is (the counts
   the grid must show: cap changes and vMotions, on X power-ons too), K1
   and K2 launches equal to the CPU run's plain calls; cells/s, branch and
   migration reads a tick, launches a tick and the idle share printed;
   then K1 at the balancer's shapes (its ``(32, 100, 15)`` entitlement
   waterfill and its ``(32, 2, 15)`` pair refill, 100 trips) on the
   inputs G's and X's CPU runs gave it, bitwise against its plain
   version, timed, with device time and bound;
6f. path Q, both benchmarks' sequential baselines (``specs[:2]`` of each
   grid, cpc and static: 8 cells) on the vector engine (K3 a tick; K1 and
   K2 in the manager), held against the CPU, K1-K3 launches equal to the
   CPU run's plain calls, K1 at the manager's balancer shapes and K3 and
   K2 at Q's against their plain versions;
6g. path E, the paper's evaluation: ``run_all`` of ``headroom``,
   ``standby`` and ``flexible`` (three policies each) on the legacy and the
   vector engine on the card (18 runs), each held against the same run on
   the CPU (counts and event strings exact, accumulators and window
   accumulators 1e-9, final states and placement equal, K1-K3 launches
   equal to its plain calls), legacy against vector on the card; Table
   II and the Table III-V lines printed and held to EXPERIMENTS.md's;
6h. path U, the bucketed front door: ``run_sweep(scenario_families(),
   engine="batch", on_unsupported="fallback")`` (12 specs of 10, 100 and
   1000 hosts x 3 policies, 120 ticks: pad buckets (16, 16), (128, 16)
   and (1024, 16), each 120 K1 and 3 K2 launches) and one cell on another
   time grid, which falls back to the vector engine with its warning;
   held against the CPU run of the same call (exact counts, 1e-9, final
   states) and against ``run_sweep_batched`` on the card (equal counts,
   1e-12); the bucket records, launches a bucket and idle share printed;
6i. path C, ``datacenter_cell`` (10,000 hosts x 10 VMs, 230 W a host,
   burst, 600 s at 30 s, cpc and static) through ``run_sweep(...,
   engine="batch")``: one pad bucket of (16384, 16), held against its CPU
   run, the cpc cell changing caps; wall, bucket record and idle share
   printed.  The CPU runs of E, U and C run in two worker processes from
   the build on, while the card runs the paths before them;
6j. the budget service: the ``budget_service`` benchmark's replay (50
   hosts, the two-row tree, 4,000 events from seed 0), headroom against
   brute force within 1e-9 and the reference's decision and error counts,
   its host latencies printed beside the card's name and power limit;
7. K4 (flash attention forward) and K6 (flash decoding) against their
   plain versions on the card: K4 at path S's prefill (8 x 512 tokens,
   32 query and 8 KV heads of 128, bf16), on bf16 cases of its
   tensor-core regime (ragged lengths 100/164 with a query offset of 64,
   the same as views into caches whose positions past Skv and features
   past D hold NaN, MQA, non-causal at D 112; each two launches bitwise
   equal) and on a float32 case with a query offset and lengths that are
   no multiple of its blocks (the CUDA-core kernel), each in the regime
   its plan must choose; K6 (one kernel for both dtypes: split-K
   partials and the combine in one call) over a 1024-position cache with
   ragged lengths in bf16 and float32, a case whose splits are all fully
   masked but one, and a bf16 cache whose position pitch is no multiple
   of 16 bytes (element copies), each two launches bitwise equal, its plan's
   shared memory the library's own count.  Tolerances: 2e-5 in float32,
   2e-2 in bf16, relative to the values' scale (the absolute term is the
   tolerance times the RMS of the plain output where that is under 1).
   Each is timed beside its plain version and
   ``scaled_dot_product_attention`` on the same inputs;
8. main path S, ``launch.serve``'s driver at granite-8b's full width and
   depth in bf16 (2 replicas, 16 requests, prompts of 512, 32 tokens, a
   1024-position cache): the exact launch counts (K4 once a layer a
   prefill, K6 once a layer a decode step, K1, K2 and K3 as the same cap
   event's CPU run calls their plain versions), the routing, caps and note of the cap event identical to the
   CPU run of the same event, and one replica's batch fed back (teacher
   forcing) through the plain versions on the card, logits within 2e-2
   relative L2; then prefill and decode-step times;
9. granite-8b at full width and 4 layers in float32: identical greedy
   tokens through the kernels and through the plain versions, logits
   within 1e-4 relative L2;
10. K5 (flash attention backward) against its plain version on the card
    in eight cases: path T's layer (4 x 4096 tokens, 36/36 heads of 64,
    causal, bf16), GQA (8 x 512, 32/8 heads of 128, bf16), MQA in float32
    with a query offset of 64 and lengths 100/164 (also against autograd
    of ``attention_ref``), float32 non-causal, and phase 7's four bf16
    cases; bf16 in the tensor-core regime (two launches bitwise equal),
    float32 on the CUDA cores, as the plan must choose.  Tolerances: 1e-4
    in float32, 2e-2 in bf16, relative to the values' scale as in 7.
    Timed at path T's layer beside its plain version and
    ``scaled_dot_product_attention``'s backward, with K4 at the same
    shape; then K5 at head dims 192 (Nemotron-4-340B's, zero-padded to
    256) and 256 on the CUDA cores (32-row blocks), causal, 2 x 256
    tokens, 8 query heads over 8 and 2 KV heads, bf16 and float32, two
    launches bitwise equal, timed beside SDPA's backward;
11. main path T, ``launch.train``'s driver at MiniCPM-2B's full width and
    depth in bf16 (40 layers, 2.725e9 parameters, 6 steps of 4 x 4096
    tokens, 2 pods, the budget cut at step 1 and the straggler from step
    2, the final checkpoint in a temporary directory that is removed):
    exact launch counts (K4 twice a layer a step under remat, K5 once a
    layer a step, K1, K2 and K3 as often as the same events' CPU run
    calls their plain versions, outermost calls only), plans and caps
    identical to the same driver's CPU run at the smoke size, finite
    losses and gradient norms, and one batch's loss and gradients through
    the kernels against the plain versions on the card (1e-2 relative and
    5e-2 relative L2); then warm step, layer and AdamW times;
12. MiniCPM-2B at full width and 4 layers in float32: two steps' losses
    and gradients through the kernels within 1e-4 of the plain versions;
13. K7 (the grouped expert GEMM) against its plain version on the card:
    path M's three products in bf16 (its prefill's ``(64, 640, 2048) @
    (64, 2048, 1024)`` and ``(64, 640, 1024) @ (64, 1024, 2048)`` in the
    wide tensor-core regime, a decode step's ``(64, 8, 2048) @ (64, 2048,
    1024)`` in the narrow one), a ragged float32 case at DeepSeekMoE's d_ff
    of 1408 and C = 1 (the CUDA-core kernel), a D that is no multiple of
    the depth tiles, C = 64 and C = 72 at path M's D and F (the regime
    boundary), a bf16 shape whose pitches TMA cannot read (the CUDA-core
    kernel), and a view a regime into a larger allocation whose rows past
    C and columns past D and F hold NaN; each in the regime the plan must
    choose, two launches bitwise equal; tolerances as in 7; each timed
    beside its plain version and ``torch.bmm``; then K4 and K6 at path M's
    shapes (16/16 heads of 128, bf16: K4 on the prefill of 8 x 512, K6 over
    a 1024-position cache), held as in 7 and timed beside their plain
    versions and SDPA, with their bounds;
14. main path M, ``launch.serve``'s driver at OLMoE-1B-7B's full width and
    depth in bf16 (16 layers, 64 experts top-8, 6.919e9 parameters), with
    path S's replicas, requests, prompts, tokens and cache: the exact
    launch counts (K7 three times a layer a forward, K4 once a layer a
    prefill, K6 once a layer a decode step, K1-K3 as the same cap event's
    CPU run calls their plain versions), the cap event identical to its
    CPU run, the first layer's MoE on the path's prefill through K7 and its
    plain version within 2e-2, and one replica's batch fed back through
    the plain versions on the card, logits within 5e-2 relative L2 (the
    reference's MoE bar: routing near ties flips in bf16) with the share
    of top-k sets that differ printed; then prefill and decode-step times;
15. DeepSeekMoE-16B at full width and 4 layers in float32 (shared experts,
    top-6): identical greedy tokens and routing through the kernels and
    through the plain versions, logits within 1e-4 relative L2;
16. K8 (the SSD intra-chunk step) against its plain version on the card:
    at path P's and path H's prefill call in bf16 (8 x 512 tokens, chunk
    256; 80 heads of 64 with N 128, and 112 heads of 64 with N 64; B and C
    one row shared by the heads, as the model passes them) in the
    tensor-core regime, as the plan must choose (its shared memory the
    library's own count), two launches bitwise equal, each timed beside
    its plain version, the same calls with B and C packed (bitwise equal),
    and a float32 scan (the CUDA-core kernels) with a ragged tail and an
    initial state through ``ops.ssd_scan`` against the sequential oracle
    (L 40, chunk 16); tolerance 1e-4 relative to the values' scale;
17. K4, K5 and K6 at head dim 112 (Zamba2-7B's shared attention)
    against their plain versions in bf16 and float32 at path H's shapes:
    K4 and K5 on a prefill of 8 x 512 with 32/32 heads (the tensor cores
    in bf16, the CUDA cores in float32, two launches bitwise equal), K6
    over a 1024-position cache with ragged lengths, at Phi-2's head dim 80
    (32 heads over 512 positions) and on a case whose splits are all fully
    masked but one, two launches bitwise equal each; K4 and K5 at head dim
    80 too (2 x 256 tokens, 8 heads: zero-padded to 112 by their wrappers);
    tolerances as in 7 and 10, the bf16 calls timed beside the plain
    versions and SDPA;
18. main path P, ``launch.serve``'s driver at Mamba2-2.7B's full width and
    depth in bf16 (64 layers, 80 SSD heads of 64, N 128, 2.7e9
    parameters), with path S's replicas, requests, prompts, tokens and
    cache: the exact launch counts (K8 once a layer a prefill, K4-K7 none,
    K1-K3 as the same cap event's CPU run calls their plain versions), the
    cap event identical to its CPU run, one replica's batch fed back
    through the plain versions on the card, logits within 2e-2 relative
    L2; then prefill and decode-step times;
19. main path H, the same at Zamba2-7B's full width and depth (81 layers,
    112 SSD heads of 64, N 64, 13 sites of the shared attention block with
    32 heads of 112, 6.75e9 parameters): K8 once a layer a prefill, K4
    once a site a prefill, K6 once a site a decode step;
20. Mamba2-2.7B at full width and 4 layers and Zamba2-7B at full width
    and 7 layers (one site, then one more layer) in float32: identical
    greedy tokens through the kernels and through the plain versions,
    logits within 1e-4 relative L2.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): fp64 and float32 outside the tensor
#: cores, bf16 on them, and HBM3 bandwidth.  K1-K3 are fp64 vector code.
PEAK_FP64_FLOPS = 34e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
REPS = 20
RTOL = ATOL = 1e-9
F64 = torch.float64
#: The attention kernels' tolerances (the reference's own ``_tol``),
#: relative to the values' scale (:func:`attn_close`).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: Path S: the serving driver at granite-8b's full width and depth.
SERVE_ARGV = ["--arch", "granite_8b", "--replicas", "2", "--requests", "16",
              "--prompt-len", "512", "--decode-steps", "32",
              "--max-len", "1024"]
#: Path T: the training driver at MiniCPM-2B's full width and depth; its
#: power plane is held against the same events at the smoke size on the
#: CPU.
TRAIN_EVENTS = ["--global-batch", "4", "--pods", "2", "--steps", "6",
                "--power-budget-drop-at", "1", "--straggler-at", "2",
                "--checkpoint-every", "0"]
TRAIN_ARGV = ["--arch", "minicpm_2b", "--seq-len", "4096"] + TRAIN_EVENTS
TRAIN_CPU_ARGV = ["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
                  "--seq-len", "32"] + TRAIN_EVENTS


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn) -> float:
    """Median wall of ``fn`` on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, pattern: str, reps: int = 6) -> float | None:
    """Mean device time (ms) of one launch of the kernel whose name holds
    ``pattern``, over the last ``reps`` of ``2 * reps`` calls of ``fn``
    under ``torch.profiler``, read from the trace's kernel events as
    ``tools/profile_sweep_torch.py`` reads them.  Each call launches it
    once.  The trace may miss the launches of a profile's first moments
    (for launches of about 0.03 ms, as many as eight of twelve), so the
    profile idles 0.2 s before the calls, and a trace with fewer than
    ``reps`` of them is taken again, three times at most; a trace that
    holds none although it holds kernel events fails (a wrong pattern).

    A process whose device activity the profiler cannot see (CUPTI held
    by another tracer) gets a trace with no kernel event at all.  When the
    tries find no kernel event, or never ``reps`` of this one, the device
    time is not measured: the result is None, and the run goes on on its
    CUDA-event times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        durs = [e["dur"] for e in sorted(kernels, key=lambda e: e["ts"])
                if pattern in e["name"]]
        if kernels and not durs:
            raise AssertionError(f"{pattern}: no such kernel in a trace of "
                                 f"{len(kernels)} kernel events")
        if len(durs) > 2 * reps:
            raise AssertionError(f"{pattern}: {len(durs)} kernel events in "
                                 f"the trace of {2 * reps} calls")
        if len(durs) >= reps:
            return sum(durs[-reps:]) / reps * 1e-3
        seen = max(seen, len(durs))
    log(f"{pattern}: device time not measured (the profiler's traces held "
        f"at most {seen} of {2 * reps} launches in three tries)")
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_FP64_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def bisection_trips(cap, fl, ce, w, act, iters: int) -> torch.Tensor:
    """The bisection trips each ``(..., J)`` row runs in the kernels' row
    routine (``csrc/waterfill.cuh``: none on a degenerate row, else up to
    the first whose midpoint meets an end of the bracket), found in the
    plain version's arithmetic: the work the kernels' bounds count."""
    from repro_torch.core.kernels import clip

    fl = torch.where(act, fl, 0.0)
    ce = torch.maximum(torch.where(act, ce, 0.0), fl)
    w = torch.where(act, w, 1e-12)
    target = torch.minimum(cap, ce.sum(-1))
    hi = (ce / w).amax(-1) + 1.0
    lo = torch.zeros_like(hi)
    running = fl.sum(-1) < cap
    trips = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        under = clip(w * mid[..., None], fl, ce).sum(-1) < target
        collapsed = (mid == lo) | (mid == hi)
        lo = torch.where(running & under, mid, lo)
        hi = torch.where(running & ~under, mid, hi)
        trips += running
        running &= ~collapsed
    return trips


def kernel_inputs(S: int, H: int, J: int, seed: int, dev, iters: int):
    """Random cells with both host types, some hosts off, some cells (never
    the first) with the policy disabled, reservations, limits, hot hosts,
    and poisoned (large, stale) values in the inactive slots; ``iters``
    bisection trips for K2's waterfills."""
    from repro_torch.core import kernels as ck

    rng = np.random.RandomState(seed)
    small = rng.rand(S, H) < 0.5
    idle = np.where(small, 120.0, 160.0)
    peak = np.where(small, 240.0, 320.0)
    cpk = np.where(small, 19_200.0, 34_800.0)
    hyp = np.where(rng.rand(S, H) < 0.3, rng.uniform(0, 400, (S, H)), 0.0)
    on = rng.rand(S, H) < 0.95
    caps = np.where(on, rng.uniform(idle + 5, peak - 5), 0.0)
    budget = (caps * on).sum(-1)
    active = (rng.rand(S, H, J) < 0.9) & on[..., None]
    res = np.where(rng.rand(S, H, J) < 0.3, rng.uniform(0, 300, (S, H, J)),
                   0.0)
    hot = 1.0 + 2.0 * (rng.rand(S, H, 1) < 0.2)
    dem = rng.uniform(200, 3000, (S, H, J)) * hot
    limit = np.where(rng.rand(S, H, J) < 0.1,
                     rng.uniform(1000, 3000, (S, H, J)), np.inf)
    weights = rng.choice([1000.0, 2000.0], (S, H, J))
    poison = rng.uniform(1e6, 1e9, (S, H, J))
    floors = np.where(active, np.minimum(res, limit), poison)
    ceils = np.where(active, np.clip(dem, res, limit), poison)
    t = {k: torch.as_tensor(v, dtype=F64, device=dev) for k, v in dict(
        idle=idle, peak=peak, cpk=cpk, hyp=hyp, caps=caps, budget=budget,
        floors=floors, ceils=ceils, weights=weights,
        cpu_res=(res * active).sum(-1),
        dem=np.where(active, np.minimum(dem, limit), poison),
        dfl=np.where(active, np.minimum(res, np.minimum(dem, limit)),
                     poison)).items()}
    hosts = ck.HostCols(torch.as_tensor(on, device=dev), t["idle"],
                        t["peak"], t["cpk"], t["hyp"])
    act = torch.as_tensor(active, device=dev)
    enabled = rng.rand(S) < 0.9
    enabled[0] = True
    enabled = torch.as_tensor(enabled, device=dev)
    return dict(
        hosts=hosts, caps=t["caps"], budget=t["budget"], enabled=enabled,
        cpu_res=t["cpu_res"],
        dense=ck.DenseCols(t["floors"], t["ceils"], t["weights"], act,
                           iters),
        wf=(ck.managed_capacity(hosts, t["caps"]), t["dfl"], t["dem"],
            t["weights"], act))


def k3_inputs(case: str, dev, seed: int = 11, m_path: int = 1000):
    """``(capacity, floors, ceilings, weights, seg_ids, n_segs)`` for K3.

    ``path``: the main path's shape, ``m_path`` hosts x 10 VMs placed round
    robin (so the CSR permutation is not the identity), demand 200-3000
    MHz, some reservations, capacity of a host capped near 250 W.
    ``ragged``: 300 hosts with 0-24 items each, some empty, one of 256
    items, one whose floors exceed its capacity, and every other host's
    items 1e6-1e9 MHz, so that each row borders huge values.
    """
    rng = np.random.RandomState(seed)
    if case == "path":
        m, n = m_path, 10 * m_path
        seg = np.arange(n) % m
        counts = np.bincount(seg, minlength=m)
    else:
        m = 300
        counts = rng.randint(0, 25, m)
        counts[rng.rand(m) < 0.1] = 0
        counts[7] = 256
        counts[8] = 5
        seg = rng.permutation(np.repeat(np.arange(m), counts))
        n = seg.size
    res = np.where(rng.rand(n) < 0.3, rng.uniform(0, 300, n), 0.0)
    dem = rng.uniform(200, 3000, n)
    floors = np.minimum(res, dem)
    weights = rng.choice([1000.0, 2000.0], n)
    cap = rng.uniform(0.4, 1.1, m) * np.maximum(
        np.bincount(seg, weights=dem, minlength=m), 1.0)
    if case == "ragged":
        floors[seg == 8] = 500.0
        dem[seg == 8] = 800.0
        cap[8] = 1000.0
        odd = seg % 2 == 1
        big = rng.uniform(1e6, 1e9, n)
        floors = np.where(odd, 0.1 * big, floors)
        dem = np.where(odd, big, dem)
        cap = np.where(np.arange(m) % 2 == 1, 3e9, cap)
    t = [torch.as_tensor(x, dtype=F64, device=dev)
         for x in (cap, floors, dem, weights)]
    return (*t, seg, m)


def k3_cost(cap, fl, ce, w, lay, iters: int) -> tuple:
    """K3's and its plain version's CUDA-event times on these inputs and
    K3's bound: ``(ms, plain_ms, bound_ms, bound_by, trips)``."""
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import to_rows

    m, n = lay.n_segs, fl.numel()
    ms = time_ms(lambda: ops.waterfill_segmented(cap, fl, ce, w, iters=iters,
                                                 layout=lay))
    pms = time_ms(lambda: ref.waterfill_segmented_ref(cap, fl, ce, w, lay,
                                                      iters))
    active = (torch.arange(lay.jb, device=fl.device) < lay.counts[:, None])
    trips = bisection_trips(cap, to_rows(lay, fl), to_rows(lay, ce),
                            to_rows(lay, w, fill=1e-12), active, iters)
    bound, by = bound_ms(8 * m + 16 * m + 8 * n + 3 * 8 * n + 8 * n,
                         float(((4 * trips + 12) * lay.counts).sum()))
    return ms, pms, bound, by, trips


def k3_record(m: int, n: int, **fields) -> dict:
    return dict(name=f"waterfill_segmented {m}x{n}", route="cuda",
                source="src/repro_torch/kernels/powercap/csrc/segmented.cu",
                replaces="src/repro/kernels/powercap/kernel.py:181",
                library_ms=None, **fields)


def check_k3(dev, m_path: int = 1000, tag: str = "V") -> dict:
    """K3 against its plain version: the path's shape (``m_path`` hosts,
    timed, with its bound) and the ragged case."""
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import segment_layout

    errs = {}
    for case in ("ragged", "path"):
        cap, fl, ce, w, seg, m = k3_inputs(case, dev, m_path=m_path)
        lay = segment_layout(seg, m, dev)
        got = ops.waterfill_segmented(cap, fl, ce, w, layout=lay)
        want = ref.waterfill_segmented_ref(cap, fl, ce, w, lay, 200)
        torch.cuda.synchronize()
        errs[case] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K3 {case}: kernel and plain version "
                                 f"differ (max abs err {errs[case]})")
        if not torch.isfinite(got).all():
            raise AssertionError(f"K3 {case}: non-finite allocation")
    ms, pms, bound, by, trips = k3_cost(cap, fl, ce, w, lay, 200)
    log(f"{tag}: K3 err {errs['path']:.3e} (ragged {errs['ragged']:.3e}) "
        f"{ms:.4f} ms (plain {pms:.3f} ms), rows of {lay.jb} slots")
    return k3_record(m, fl.numel(), max_abs_err=errs["path"],
                     ragged_max_abs_err=errs["ragged"], rtol=RTOL,
                     atol=ATOL, ms=ms, plain_ms=pms, bound_ms=bound,
                     bound_by=by, mean_trips=float(trips.double().mean()))


def balance_plan(S: int, H: int, J: int) -> dict:
    """K2's plan for the shape, with the card's occupancy answers and the
    limit they set."""
    from repro_torch.kernels.powercap import kernel

    clusters = kernel.max_active_clusters(J)
    return dict(dataclasses.asdict(kernel.balance_plan(S, H, J, clusters)),
                max_active_clusters=list(clusters),
                limit_hosts=kernel.balance_limit(clusters))


def check_kernels(shapes, dev) -> dict:
    """K2 (and K1, where ``shapes`` flags it) against their plain versions
    at each ``(S, H, J, with_k1, iters)``: K1 runs 100 bisection trips, as
    the batched engine's delivery does; K2 runs ``iters``, with round
    counts and ``did`` flags equal to the plain version's."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import kernel, ops, ref

    params = ck.BalanceParams()
    out = {}
    for tag, (S, H, J, with_k1, iters) in shapes.items():
        x = kernel_inputs(S, H, J, seed=S * 7919 + H, dev=dev, iters=iters)
        n = S * H * J
        out[tag] = []
        if with_k1:
            cap, fl, ce, w, act = x["wf"]
            k1 = ops.waterfill_dense(cap, fl, ce, w, 100, active=act)
            p1 = ref.waterfill_dense_ref(cap, fl, ce, w, 100, act)
            torch.cuda.synchronize()
            err1 = float((k1 - p1).abs().max())
            if not torch.allclose(k1, p1, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"K1 {tag}: kernel and plain version "
                                     f"differ (max abs err {err1})")
            ms1 = time_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, 100,
                                                      active=act))
            pms1 = time_ms(lambda: ref.waterfill_dense_ref(cap, fl, ce, w,
                                                           100, act))
            dms1 = device_ms(lambda: ops.waterfill_dense(
                cap, fl, ce, w, 100, active=act), "waterfill_kernel")
            trips1 = bisection_trips(cap, fl, ce, w, act, 100)
            b1, by1 = bound_ms(8 * S * H + 3 * 8 * n + n + 8 * n,
                               float((4 * trips1 + 12).sum()) * J)
            g, k = kernel.row_shape(J)
            log(f"{tag}: K1 err {err1:.3e} {ms1:.4f} ms, device "
                f"{fmt_ms(dms1)} (plain {pms1:.3f} ms), {g} lanes a row")
            out[tag].append(dict(
                name=f"waterfill_dense {S}x{H}x{J}", route="cuda",
                source="src/repro_torch/kernels/powercap/csrc/waterfill.cu",
                replaces="src/repro/kernels/powercap/kernel.py:48",
                max_abs_err=err1, rtol=RTOL, atol=ATOL, ms=ms1,
                device_ms=dms1, plain_ms=pms1, bound_ms=b1, bound_by=by1,
                library_ms=None, row_lanes=g, row_slots_a_lane=k,
                mean_trips=float(trips1.double().mean())))

        out[tag].append(check_k2(tag, (
            x["hosts"], x["caps"], x["dense"], x["cpu_res"], x["budget"],
            x["enabled"], params)))
    return out


def check_k2(tag: str, args: tuple, bitwise: bool = False,
             **extra) -> dict:
    """K2 against its plain version on ``args`` (``balance_caps``'), timed
    beside it by CUDA events and the profiler, with its bound: caps within
    ``RTOL`` (no absolute slack), or bitwise where ``bitwise``, round
    counts and ``did`` flags equal."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import ops, ref

    hosts, caps, dense = args[:3]
    S, H, J = dense.floors.shape
    n, iters = S * H * J, dense.iters
    kc, kd, kr = ops.balance_caps(*args)
    pc, pd, pr = ref.balance_caps_ref(*args)
    torch.cuda.synchronize()
    err2 = float((kc - pc).abs().max())
    if not (torch.equal(kc, pc) if bitwise
            else torch.allclose(kc, pc, rtol=RTOL, atol=0.0)):
        raise AssertionError(f"K2 {tag}: caps differ (max abs err "
                             f"{err2})")
    if not torch.equal(kd, pd):
        raise AssertionError(f"K2 {tag}: did flags differ")
    if not torch.equal(kr, pr):
        raise AssertionError(f"K2 {tag}: rounds {kr.tolist()[:16]} on "
                             f"the card, {pr.tolist()[:16]} in the "
                             f"plain version")
    plan = balance_plan(S, H, J)
    ms2 = time_ms(lambda: ops.balance_caps(*args))
    dms2 = device_ms(lambda: ops.balance_caps(*args),
                     "balance_caps_kernel")
    pms2 = time_ms(lambda: ref.balance_caps_ref(*args))
    # Each round's waterfills run about as many trips as the first
    # (at the input caps) does.
    trips2 = float(bisection_trips(
        ck.managed_capacity(hosts, caps), dense.floors,
        dense.ceils, dense.weights, dense.active,
        iters).double().mean())
    waterfills = float((1 + pr.double()).sum()) * H
    b2, by2 = bound_ms((1 + 4 * 8 + 8 + 8 + 8) * S * H + 25 * n + 9 * S
                       + 5 * S, waterfills * (4 * trips2 + 12) * J
                       + float(pr.double().sum()) * 40 * H)
    log(f"{tag}: K2 err {err2:.3e} rounds {pr.tolist()[:16]} (equal) "
        f"{ms2:.4f} ms, device {fmt_ms(dms2)} (plain {pms2:.3f} ms), "
        f"plan {json.dumps(plan)}")
    return dict(
        name=f"balance_caps {S}x{H}x{J}", route="cuda",
        source="src/repro_torch/kernels/powercap/csrc/balance.cu",
        replaces="src/repro/kernels/powercap/kernel.py:109", **extra,
        max_abs_err=err2, bitwise=bool(torch.equal(kc, pc)),
        rtol=0.0 if bitwise else RTOL, atol=0.0, ms=ms2, device_ms=dms2, plain_ms=pms2, bound_ms=b2,
        bound_by=by2, library_ms=None, rounds_equal_plain=True,
        rounds=int(pr.sum()), mean_trips=trips2,
        cluster=plan["cluster"], plan=plan)


def check_row_shapes(dev) -> dict:
    """K1 and K2 at rows of 3, 40, 100 and 300 slots (the row routine's
    4-lane, two-slot, four-slot and streamed shapes) and K3 at rows of 300
    and 1,000 items, each against its plain version at 1e-9 (K2 with equal
    rounds and ``did`` flags); returns the largest errors."""
    from repro_torch.core.kernels import BalanceParams
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import segment_layout

    errs = {"K1": {}, "K2": {}, "K3": {}}
    for J in (3, 40, 100, 300):
        x = kernel_inputs(3, 70, J, seed=J, dev=dev, iters=100)
        cap, fl, ce, w, act = x["wf"]
        got = ops.waterfill_dense(cap, fl, ce, w, 100, active=act)
        want = ref.waterfill_dense_ref(cap, fl, ce, w, 100, act)
        torch.cuda.synchronize()
        errs["K1"][J] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K1 J {J}: max abs err {errs['K1'][J]}")
        args = (x["hosts"], x["caps"], x["dense"], x["cpu_res"], x["budget"],
                x["enabled"], BalanceParams())
        (kc, kd, kr), (pc, pd, pr) = (ops.balance_caps(*args),
                                      ref.balance_caps_ref(*args))
        errs["K2"][J] = float((kc - pc).abs().max())
        if not (torch.allclose(kc, pc, rtol=RTOL, atol=0.0)
                and torch.equal(kd, pd) and torch.equal(kr, pr)):
            raise AssertionError(f"K2 J {J}: max abs err {errs['K2'][J]}, "
                                 f"rounds {kr.tolist()} / {pr.tolist()}")
    rng = np.random.RandomState(17)
    for width in (300, 1000):
        counts = np.array([width, 3, 0, width // 2 + 1, 7])
        seg = rng.permutation(np.repeat(np.arange(counts.size), counts))
        n = seg.size
        dem = rng.uniform(200, 3000, n)
        fl = np.where(rng.rand(n) < 0.3, rng.uniform(0, 150, n), 0.0)
        cap = rng.uniform(0.3, 1.2, counts.size) * np.maximum(
            np.bincount(seg, weights=dem, minlength=counts.size), 1.0)
        t = [torch.as_tensor(a, dtype=F64, device=dev)
             for a in (cap, fl, dem, rng.choice([1000.0, 2000.0], n))]
        lay = segment_layout(seg, counts.size, dev)
        got = ops.waterfill_segmented(*t, layout=lay)
        want = ref.waterfill_segmented_ref(*t, lay, 200)
        torch.cuda.synchronize()
        errs["K3"][width] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K3 rows of {width}: max abs err "
                                 f"{errs['K3'][width]}")
    log(f"row shapes: {json.dumps(errs)}")
    return errs


def compare(tag, gpu, cpu, keys, rtol: float = RTOL) -> None:
    """Exact cap-change, vMotion and power-event counts, ``rtol`` (1e-9)
    on payload and energy."""
    for spec_name, policy in keys:
        g, c = gpu[spec_name][policy], cpu[spec_name][policy]
        for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(
                    f"{tag} {spec_name}/{policy}: {f} {getattr(g, f)} on "
                    f"the card, {getattr(c, f)} in the comparison run")
        for f in ("cpu_payload_mhz_s", "energy_j"):
            a, b = getattr(g, f), getattr(c, f)
            if not abs(a - b) <= rtol * abs(b):
                raise AssertionError(f"{tag} {spec_name}/{policy} {f}: "
                                     f"{a!r} vs {b!r}")
        if not np.isfinite(g.cpu_payload_mhz_s) or g.cpu_payload_mhz_s <= 0:
            raise AssertionError(f"{tag} {spec_name}/{policy}: no payload")


KERNELS = ("waterfill_dense", "balance_caps", "waterfill_segmented")


def _model_wrappers() -> dict:
    """The model kernels' wrappers (K4, K5, K6, K7, K8) by name."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "decode_attention": da_ops.decode_attention,
            "grouped_matmul": gmm_ops.grouped_matmul,
            "ssd_scan": ssd_ops.ssd_scan}


def reset_launches() -> None:
    from repro_torch.kernels.powercap import ops
    for name in KERNELS:
        getattr(ops, name).launches = 0
    for fn in _model_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Every wrapper's count: K1-K3, then the model kernels."""
    from repro_torch.kernels.powercap import ops
    return dict({name: getattr(ops, name).launches for name in KERNELS},
                **{n: fn.launches for n, fn in _model_wrappers().items()})


def no_model_launches() -> dict:
    """The model kernels' counts on a path that runs no model."""
    return dict.fromkeys(_model_wrappers(), 0)


def build_all() -> float:
    """Build the five kernel libraries at once (every ``nvcc`` process
    started together) and load them; returns the wall seconds."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.powercap import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    t0 = time.perf_counter()
    libs = (fa_kernel.LIBRARY, da_kernel.LIBRARY, gmm_kernel.LIBRARY,
            ssd_kernel.LIBRARY)
    builds = (kernel.build,) + tuple(lib.build for lib in libs)
    with ThreadPoolExecutor(len(builds)) as pool:
        logs = [f.result()[1] for f in [pool.submit(b) for b in builds]]
    print("\n".join(logs), file=sys.stderr, flush=True)
    kernel.library()
    for lib in libs:
        lib.library()
    return time.perf_counter() - t0


def randn(shape, dtype, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def attn_close(got, want, tol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``, raising past ``tol``
    relative to the values' scale: ``rtol = tol`` and ``atol = tol`` times
    the RMS of ``want`` where that is under 1 (attention outputs and
    gradients over thousands of keys are far smaller than 1, so an
    absolute ``tol`` would pass a wrong kernel); returns the error.  The
    kernel records give ``tol`` as ``rtol`` and ``atol_per_rms``."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = tol * min(1.0, float(want.square().mean().sqrt()))
    if not (torch.allclose(got, want, rtol=tol, atol=atol)
            and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel and reference differ (max abs "
                             f"err {err}, rtol {tol}, atol {atol:.3e})")
    return err


def attn_err(got, want, dtype, what: str) -> float:
    """:func:`attn_close` at the dtype's tolerance."""
    return attn_close(got, want, ATTN_TOL[dtype], what)


#: bf16 cases of K4's and K5's tensor-core regimes (phases 7 and 10):
#: ``(B, Sq, Skv, Hq, Hkv, D, causal, q_offset)``.  "view_nan" reads k and
#: v as views into caches whose positions past Skv and whose features past
#: D in each head hold NaN.
ATTN_BF16_CASES = {
    "ragged": (2, 100, 164, 8, 2, 128, True, 64),
    "view_nan": (2, 100, 164, 8, 2, 128, True, 64),
    "mqa": (2, 256, 256, 8, 1, 64, True, 0),
    "full": (2, 192, 192, 4, 2, 112, False, 0),
}


def attn_operands(b, sq, skv, hq, hkv, d, dtype, dev, seed: int,
                  view: bool = False):
    """q, k, v and dO from ``seed``; with ``view``, k and v are views into
    NaN-filled caches of 36 more positions and 8 more features a head."""
    q = randn((b, sq, hq, d), dtype, dev, seed)
    k = randn((b, skv, hkv, d), dtype, dev, seed + 1)
    v = randn((b, skv, hkv, d), dtype, dev, seed + 2)
    do = randn((b, sq, hq, d), dtype, dev, seed + 3)
    if view:
        def poisoned(t):
            big = torch.full((b, skv + 36, hkv, d + 8), float("nan"),
                             dtype=dtype, device=dev)
            big[:, :skv, :, :d] = t
            return big[:, :skv, :, :d]
        k, v = poisoned(k), poisoned(v)
    return q, k, v, do


def attn_plan(q, k, v, dout=None, want: str | None = None, what: str = ""):
    """The plan that K4's wrapper (K5's, given ``dout``) makes for the
    call; with ``want``, raises unless it names that regime and, on the
    tensor cores, its shared memory equals the library's own count."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    b, sq, hq, d = q.shape
    ts = (q, k, v) if dout is None else (q, k, v, dout)
    p = (kernel.plan if dout is None else kernel_bwd.plan)(
        b, sq, k.shape[1], hq, k.shape[2], d, q.dtype,
        tuple(kernel.bshd_strides(t) for t in ts),
        all(t.data_ptr() % 16 == 0 for t in ts))
    if want is not None:
        lib = (kernel.smem_bytes("fwd", d) if dout is None else
               (kernel.smem_bytes("dkdv", d), kernel.smem_bytes("dq", d)))
        if p.regime != want or (want == "tensor_core"
                                and p.smem_bytes != lib):
            raise AssertionError(f"{what}: plan {p}, expected {want} "
                                 f"(library shared memory {lib})")
    return p


def k4_case(q, k, v, causal, q_offset, what: str) -> float:
    """K4 against its plain version (out and lse), two launches bitwise
    equal; returns the larger error."""
    from repro_torch.kernels.flash_attention import ops, ref
    out, lse = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    pout, plse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_offset,
                                         block_k=ops.BLOCK_K)
    err = max(attn_err(out, pout, q.dtype, what),
              attn_err(lse, plse, q.dtype, f"{what} lse"))
    again, again_lse = ops.flash_attention(q, k, v, causal=causal,
                                           q_offset=q_offset)
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{what}: two launches differ")
    return err


def check_k4(dev) -> dict:
    """K4 against its plain version: a float32 case with a query offset
    and ragged lengths (the CUDA-core kernel), the bf16 cases of
    ``ATTN_BF16_CASES`` and path S's prefill shape in bf16 (the tensor
    cores), each in the regime its plan must choose, the bf16 ones two
    launches bitwise equal; path S's timed, with its bound and SDPA's time
    on the same inputs."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    f32 = torch.float32
    q = randn((2, 100, 32, 128), f32, dev, 1)
    k, v = randn((2, 164, 8, 128), f32, dev, 2), randn((2, 164, 8, 128),
                                                       f32, dev, 3)
    attn_plan(q, k, v, want="cuda_core", what="K4 float32")
    out, lse = ops.flash_attention(q, k, v, causal=True, q_offset=64)
    pout, plse = ref.flash_attention_ref(q, k, v, causal=True, q_offset=64,
                                         block_k=ops.BLOCK_K)
    err32 = attn_err(out, pout, f32, "K4 float32, q_offset 64")
    attn_err(lse, plse, f32, "K4 float32 lse")

    bf = torch.bfloat16
    cases = {}
    for i, (case, (b, sq, skv, hq, hkv, d, causal, qoff)) in enumerate(
            ATTN_BF16_CASES.items()):
        q, k, v, _ = attn_operands(b, sq, skv, hq, hkv, d, bf, dev,
                                   100 + 4 * i, view=case == "view_nan")
        attn_plan(q, k, v, want="tensor_core", what=f"K4 {case}")
        cases[case] = k4_case(q, k, v, causal, qoff, f"K4 bf16 {case}")
    log(f"K4 tensor-core cases (errors, two launches bitwise equal): "
        f"{json.dumps(cases)}")

    b, s, hq, hkv, d = 8, 512, 32, 8, 128
    q = randn((b, s, hq, d), bf, dev, 4)
    k, v = randn((b, s, hkv, d), bf, dev, 5), randn((b, s, hkv, d), bf,
                                                    dev, 6)
    p = attn_plan(q, k, v, want="tensor_core", what="K4 path S")
    err = k4_case(q, k, v, True, 0, "K4 bf16, path S prefill")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    pms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                  block_k=ops.BLOCK_K))
    lms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = s * (s + 1) // 2
    bound, by = bound_ms(2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                         + 4 * b * hq * s, 4 * b * hq * d * pairs,
                         PEAK_BF16_FLOPS)
    log(f"S: K4 ({p.regime}) err {err:.3e} (float32 {err32:.3e}) {ms:.4f} "
        f"ms (plain {pms:.3f} ms, SDPA {lms:.4f} ms, bound {bound:.4f} ms)")
    return dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_fwd_tc.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:83",
                regime=p.regime, max_abs_err=err, float32_max_abs_err=err32,
                case_errs=cases, rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf],
                ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                library_ms=lms)


def k6_plan(q, k, v, what: str):
    """The plan that K6's wrapper makes for the call, its shared memory
    held against the library's own count."""
    from repro_torch.kernels.decode_attention import kernel
    b, hq, d = q.shape
    p = kernel.plan(b, k.shape[1], hq, k.shape[2], d, q.dtype,
                    (k.stride()[:2], v.stride()[:2]),
                    k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    lib = kernel.library_smem_bytes(d, q.dtype, p.lanes, p.rows)
    if lib != p.smem_bytes:
        raise AssertionError(f"{what}: plan {p}, library shared memory "
                             f"{lib}")
    return p


def k6_case(q, k, v, kv_len, what: str, block_k: int | None = None):
    """K6 against its plain version (the reference's blocks of ``block_k``
    positions, 512 by default), two launches bitwise equal; returns the
    error and the plan."""
    from repro_torch.kernels.decode_attention import ops, ref
    p = k6_plan(q, k, v, what)
    out = ops.decode_attention(q, k, v, kv_len)
    err = attn_err(out, ref.decode_attention_split_ref(
        q, k, v, kv_len, block_k or ops.BLOCK_K), q.dtype, what)
    if not torch.equal(out, ops.decode_attention(q, k, v, kv_len)):
        raise AssertionError(f"{what}: two launches differ")
    return err, p


def time_k6(q, k, v, kv_len) -> dict:
    """K6 beside its plain version and ``scaled_dot_product_attention``
    (masked to each row's live prefix) on the same inputs, with its bound:
    the live K and V bytes, or ``4 Hq D`` operations a live position."""
    from repro_torch.kernels.decode_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, d = q.shape[1:]
    s, hkv = k.shape[1], k.shape[2]
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, kv_len))
    pms = time_ms(lambda: ref.decode_attention_split_ref(q, k, v, kv_len,
                                                         ops.BLOCK_K))
    lms = time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask,
                               enable_gqa=hq != hkv))
    live = float(kv_len.double().sum())
    bound, by = bound_ms(2 * 2 * live * hkv * d, 4 * live * hq * d,
                         PEAK_BF16_FLOPS)
    return dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
                bound_by=by)


def k6_record(shape, err, err32, p, times, **extra) -> dict:
    b, s, hq, d = shape
    bf = torch.bfloat16
    return dict(name=f"decode_attention {b}x{s}x{hq}x{d}", route="cuda",
                source="src/repro_torch/kernels/decode_attention/csrc/"
                       "decode.cu",
                replaces="src/repro/kernels/decode_attention/kernel.py:55",
                plan=dict(split=p.split, lanes=p.lanes, rows=p.rows,
                          grid=list(p.grid), vector_loads=p.vector_loads),
                max_abs_err=err, float32_max_abs_err=err32,
                rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf], **times,
                **extra)


def check_k6(dev) -> dict:
    """K6 against its plain version over a 1024-position cache with
    ragged lengths, in float32 and bf16 (two launches bitwise equal, the
    plan's shared memory the library's; timed, with SDPA on the same
    inputs), and a case with every split but the first fully masked."""
    b, s, hq, hkv, d = 8, 1024, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(7)
    kv_len = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((b, hq, d), dtype, dev, 8)
        k, v = randn((b, s, hkv, d), dtype, dev, 9), randn((b, s, hkv, d),
                                                           dtype, dev, 10)
        errs[dtype], p = k6_case(q, k, v, kv_len, f"K6 {dtype}")
    mq = randn((2, 2, 32), torch.float32, dev, 11)
    mk = randn((2, 512, 2, 32), torch.float32, dev, 12)
    mlen = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    masked, mp = k6_case(mq, mk, mk, mlen, "K6 fully masked splits", 64)
    if mp.splits < 2 or mp.split < 3:    # kv_len 1 and 3: one live split
        raise AssertionError(f"K6 fully masked splits: plan {mp}")
    # A cache whose positions lie 8 * 128 + 4 elements apart (8 bytes past
    # a 16-byte multiple in bf16): the element copies instead of cp.async.
    wide = randn((b, s, hkv * d + 4), torch.bfloat16, dev, 13)
    uk = wide.as_strided((b, s, hkv, d), (s * (hkv * d + 4), hkv * d + 4,
                                          d, 1))
    uq = randn((b, hq, d), torch.bfloat16, dev, 14)
    unaligned, up = k6_case(uq, uk, uk, kv_len, "K6 unaligned pitch")
    if up.vector_loads:
        raise AssertionError(f"K6 unaligned pitch: plan {up}")
    times = time_k6(q, k, v, kv_len)
    err = errs[torch.bfloat16]
    log(f"S: K6 (split {p.split}, lanes {p.lanes}, rows {p.rows}) err "
        f"{err:.3e} (float32 {errs[torch.float32]:.3e}, masked "
        f"{masked:.3e}, unaligned pitch {unaligned:.3e}) "
        f"{times['ms']:.4f} ms (plain {times['plain_ms']:.3f} "
        f"ms, SDPA {times['library_ms']:.4f} ms, bound "
        f"{times['bound_ms']:.5f} ms); reruns bitwise equal; kv_len "
        f"{kv_len.tolist()}")
    return k6_record((b, s, hq, d), err, errs[torch.float32], p, times,
                     masked_max_abs_err=masked,
                     unaligned_max_abs_err=unaligned)


def check_m_attention(dev) -> list:
    """K4 and K6 at path M's shapes (OLMoE-1B-7B's 16/16 heads of 128,
    bf16): K4 on the prefill of 8 x 512 (the tensor cores), K6 over a
    1024-position cache with ragged lengths, each against its plain
    version (K6's reruns bitwise equal), timed beside its plain version
    and SDPA, with its bound.  Returns their records for path M."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    b, s, h, d, cache = 8, 512, 16, 128, 1024
    q, k, v, _ = attn_operands(b, s, s, h, h, d, bf, dev, 90)
    p4 = attn_plan(q, k, v, want="tensor_core", what="K4 path M")
    err4 = k4_case(q, k, v, True, 0, "K4 bf16, path M prefill")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms4 = time_ms(lambda: ops.flash_attention(q, k, v))
    pms4 = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                   block_k=ops.BLOCK_K))
    lms4 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound4, by4 = bound_ms(2 * 4 * b * s * h * d + 4 * b * h * s,
                           4 * b * h * d * (s * (s + 1) // 2),
                           PEAK_BF16_FLOPS)
    g = torch.Generator(device=dev).manual_seed(91)
    kv_len = torch.randint(1, cache + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    dq = randn((b, h, d), bf, dev, 92)
    dk, dv = (randn((b, cache, h, d), bf, dev, 93 + i) for i in range(2))
    err6, p6 = k6_case(dq, dk, dv, kv_len, "K6 bf16, path M")
    times6 = time_k6(dq, dk, dv, kv_len)
    log(f"M: K4 ({p4.regime}) err {err4:.3e} {ms4:.4f} ms (plain "
        f"{pms4:.3f} ms, SDPA {lms4:.4f} ms, bound {bound4:.4f} ms); K6 "
        f"(split {p6.split}) err {err6:.3e} {times6['ms']:.4f} ms (plain "
        f"{times6['plain_ms']:.3f} ms, SDPA {times6['library_ms']:.4f} ms, "
        f"bound {times6['bound_ms']:.5f} ms)")
    return [dict(name=f"flash_attention {b}x{s}x{h}x{d}", route="cuda",
                 source="src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_fwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:83",
                 regime=p4.regime, max_abs_err=err4, rtol=ATTN_TOL[bf],
                 atol_per_rms=ATTN_TOL[bf], ms=ms4, plain_ms=pms4,
                 bound_ms=bound4, bound_by=by4, library_ms=lms4),
            k6_record((b, cache, h, d), err6, None, p6, times6)]


#: K5's cases: ``(B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype)``;
#: "path" is path T's layer, the one timed; the bf16 cases of
#: ``ATTN_BF16_CASES`` join them.
K5_CASES = {
    "path": (4, 4096, 4096, 36, 36, 64, True, 0, torch.bfloat16),
    "gqa": (8, 512, 512, 32, 8, 128, True, 0, torch.bfloat16),
    "mqa": (2, 100, 164, 8, 1, 32, True, 64, torch.float32),
    "full": (2, 192, 192, 4, 2, 16, False, 0, torch.float32),
    **{f"{case}_bf16": shape + (torch.bfloat16,)
       for case, shape in ATTN_BF16_CASES.items()},
}
#: K5's tolerances (``tests/test_kernels_bwd.py``'s 1e-4 in float32; the
#: reference's bfloat16 tolerance), relative to the values' scale
#: (:func:`attn_close`).
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def k5_case(q, k, v, do, causal, q_offset, what: str, bitwise: bool):
    """K5 against its plain version from K4's forward; with ``bitwise``,
    two launches must give the same bits.  Returns ``(errors by output,
    (q, k, v, out, lse, do), K5's outputs)``."""
    from repro_torch.kernels.flash_attention import ops, ref
    with torch.no_grad():
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  q_offset=q_offset)
    want = ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal, q_offset=q_offset,
        block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K)
    tol = K5_TOL[q.dtype]
    errs = {name: attn_close(a, w, tol, f"{what} {name}")
            for name, a, w in zip(("dq", "dk", "dv"), got, want)}
    if bitwise:
        again = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, q_offset=q_offset)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two launches differ")
    return errs, (q, k, v, out, lse, do), got


def check_k5(dev) -> list:
    """K5 against its plain version in every case of ``K5_CASES`` (and, in
    the float32 MQA case, against autograd of ``attention_ref``), each in
    the regime its plan must choose (the tensor cores for bf16, the CUDA
    cores for float32), the bf16 ones two launches bitwise equal; the
    path's case timed beside the plain version and SDPA's backward on the
    same inputs, and K4 timed at the same shape.  Returns the records of
    K4 and K5 at path T's layer."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    errs, regimes = {}, {}
    for case, (b, sq, skv, hq, hkv, d, causal, qoff, dtype) in \
            K5_CASES.items():
        q, k, v, do = attn_operands(b, sq, skv, hq, hkv, d, dtype, dev,
                                    20 + 4 * len(errs),
                                    view=case.startswith("view"))
        want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        regimes[case] = attn_plan(q, k, v, do, want, f"K5 {case}").regime
        errs[case], operands, got = k5_case(
            q, k, v, do, causal, qoff, f"K5 {case}",
            bitwise=want == "tensor_core")
        if case == "mqa":
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o = ref.attention_ref(qq, kk, vv, causal=causal, q_offset=qoff)
            oracle = torch.autograd.grad(o, (qq, kk, vv), do)
            for name, a, w in zip(("dq", "dk", "dv"), got, oracle):
                errs[case][f"oracle_{name}"] = attn_close(
                    a, w, K5_TOL[dtype], f"K5 {case} {name} against "
                    f"autograd of attention_ref")
        if case == "path":
            timed = operands

    b, s, hq, hkv, d, _, _, dtype = (K5_CASES["path"][i]
                                     for i in (0, 1, 3, 4, 5, 6, 7, 8))
    q, k, v, out, lse, do = timed
    k4_regime = attn_plan(q, k, v, want="tensor_core",
                          what="K4 at path T's layer").regime
    k4_err = attn_err(out, ref.flash_attention_ref(
        q, k, v, block_k=ops.BLOCK_K)[0], dtype, "K4 at path T's layer")
    ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, do))
    pms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    both_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot))
    pairs = s * (s + 1) // 2
    el = 2 if dtype == torch.bfloat16 else 4
    bound, by = bound_ms(el * (4 * b * s * hq * d + 4 * b * s * hkv * d)
                         + 4 * b * hq * s, 10 * b * hq * d * pairs,
                         PEAK_BF16_FLOPS)
    log(f"T: K5 regimes {json.dumps(regimes)} errs {json.dumps(errs)} "
        f"{ms:.3f} ms (plain {pms:.3f} ms, SDPA backward "
        f"{both_ms - fwd_ms:.3f} ms = {both_ms:.3f} - {fwd_ms:.3f}, bound "
        f"{bound:.4f} ms, {by})")
    k4_ms = time_ms(lambda: ops.flash_attention(q, k, v))
    k4_pms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                     block_k=ops.BLOCK_K))
    k4_bound, k4_by = bound_ms(el * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                               + 4 * b * hq * s, 4 * b * hq * d * pairs,
                               PEAK_BF16_FLOPS)
    log(f"T: K4 ({k4_regime}) at the same shape err {k4_err:.3e} "
        f"{k4_ms:.3f} ms (plain {k4_pms:.3f} ms, SDPA {fwd_ms:.3f} ms, "
        f"bound {k4_bound:.4f} ms)")
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    k4 = dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
              source=src + "flash_fwd_tc.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:83",
              regime=k4_regime, max_abs_err=k4_err, rtol=ATTN_TOL[dtype],
              atol_per_rms=ATTN_TOL[dtype], ms=k4_ms, plain_ms=k4_pms,
              bound_ms=k4_bound, bound_by=k4_by, library_ms=fwd_ms)
    k5 = dict(name=f"flash_attention_bwd {b}x{s}x{hq}x{d}", route="cuda",
              source=src + "flash_bwd_tc.cu",
              replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
              regime=regimes["path"], case_regimes=regimes,
              max_abs_err=max(errs["path"].values()), case_errs=errs,
              rtol=K5_TOL[dtype], atol_per_rms=K5_TOL[dtype], ms=ms,
              plain_ms=pms, bound_ms=bound, bound_by=by,
              library_ms=both_ms - fwd_ms,
              library_fwd_bwd_ms=both_ms, library_fwd_ms=fwd_ms)
    return [k4, k5]


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain versions of K4, K5 and K6,
    on whatever device the tensors are (the comparison runs only).  The
    one ``ops.FlashAttention`` Function serves both runs: its forward and
    backward callees are swapped for the plain versions."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import layers

    def forward(q, k, v, causal, q_offset):
        return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          q_offset=q_offset,
                                          block_k=fa_ops.BLOCK_K)

    def backward(q, k, v, out, lse, dout, *, causal, q_offset):
        return fa_ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, q_offset=q_offset,
            block_q=fa_ops.BLOCK_Q, block_k=fa_ops.BLOCK_K)

    def decode(q, k, v, kv_len):
        return da_ref.decode_attention_split_ref(q, k, v, kv_len,
                                                 da_ops.BLOCK_K)

    with mock.patch.object(fa_ops, "_forward", forward), \
            mock.patch.object(fa_ops, "flash_attention_bwd", backward), \
            mock.patch.object(layers, "decode_attention", decode):
        yield


@contextlib.contextmanager
def count_plain_calls():
    """Counts the outermost calls of K1-K3's plain versions in a CPU run,
    yielding the counts: each is one launch on the card.  A plain version
    called inside another (K2's loop runs K1's plain waterfill each round)
    is part of the outer kernel's launch and not counted."""
    from repro_torch.kernels.powercap import ref
    counts, depth = dict.fromkeys(KERNELS, 0), [0]

    def counting(name, fn):
        def call(*args, **kwargs):
            if depth[0] == 0:
                counts[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    with contextlib.ExitStack() as stack:
        for name in KERNELS:
            stack.enter_context(mock.patch.object(
                ref, f"{name}_ref", counting(name, getattr(ref,
                                                           f"{name}_ref"))))
        yield counts


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def run_serving_path(dev) -> tuple[dict, dict]:
    """Path S through ``launch.serve.main`` on the card, with the launch
    counts of exactly that run; its cap event held against the CPU, one
    replica's batch against the plain versions; then warm timings."""
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    snap, router = serve.make_fleet(H100_HOST, n_rep)
    with count_plain_calls() as power_launches:
        routing, caps, result = serve.power_event(snap, router, 16, "cpu")
    # K1-K3 as the same cap event's CPU run calls their plain versions
    # (K2 once, K3 twice for the note, K1 for the migration balancer's
    # entitlements and the round that finds nothing to move).
    want = {"flash_attention": cfg.n_layers * n_rep,
            "flash_attention_bwd": 0,
            "decode_attention": cfg.n_layers * (steps - 1) * n_rep,
            "grouped_matmul": 0, "ssd_scan": 0, **power_launches}
    if launches != want or power_launches["balance_caps"] != 1:
        raise AssertionError(f"S: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"S: routing {report.routing}")
    got = (list(report.routing_after.items()), report.caps_after,
           report.notes, report.cap_changes, report.migrations)
    cpu = (list(routing.items()), caps, list(result.notes),
           result.cap_changes, result.migrations)
    if got != cpu:
        raise AssertionError(f"S: cap event on the card {got}, on the CPU "
                             f"{cpu}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"S {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"S {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]
    with plain_attention():
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    err = rel_l2(logits, plain_logits)
    if not err <= 2e-2:
        raise AssertionError(f"S: teacher-forced logits {err:.3e} relative "
                             f"L2 from the plain versions (bound 2e-2)")
    same = float((plain_logits.argmax(-1) == toks).float().mean())

    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prefill_ms, step_ms = [], []
    for _ in range(3):
        start.record()
        lg, state = prefill(params, prompts)
        mid.record()
        tok = lg.argmax(-1)
        for _ in range(steps - 1):
            lg, state = decode(params, state, tok)
            tok = lg.argmax(-1)
        end.record()
        end.synchronize()
        prefill_ms.append(start.elapsed_time(mid))
        step_ms.append(mid.elapsed_time(end) / (steps - 1))
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    cache_gb = (2 * cfg.n_layers * 8 * max_len * cfg.n_kv_heads
                * cfg.head_dim * params["blocks"]["wk"].element_size()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=statistics.median(prefill_ms),
                decode_step_ms=statistics.median(step_ms),
                weights_gb=weights_gb, cache_gb_per_batch=cache_gb,
                peak_memory_gb=peak_gb, teacher_forced_rel_l2=err,
                plain_argmax_equal=same, routing=report.routing,
                routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count())
    log(f"path S: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, cache {cache_gb:.3f} GB a batch, peak "
        f"{peak_gb:.3f} GB; teacher-forced logits {err:.3e} relative L2 "
        f"(argmax equal {same:.3f}); launches {launches}; cap event "
        f"{report.caps_after} W, {report.routing_after}, {report.notes}")
    return launches, info


def run_f32_depth_check(dev) -> dict:
    """granite-8b at full width, 4 layers, float32: kernels against plain
    versions, greedily, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get("granite_8b"), n_layers=4,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention():
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks):
        raise AssertionError("S f32: greedy tokens differ between the "
                             "kernels and the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"S f32: logits {err:.3e} relative L2 from the "
                             f"plain versions (bound 1e-4)")
    log(f"S f32, 4 layers: tokens identical, logits {err:.3e} relative L2")
    return dict(rel_l2=err, tokens_identical=True)


def rel_l2_sliced(got, want) -> float:
    """``rel_l2`` a slice of 2**24 elements at a time, for leaves whose
    float64 copies would not fit beside the training state."""
    num = den = 0.0
    for a, b in zip(got.reshape(-1).split(1 << 24),
                    want.reshape(-1).split(1 << 24)):
        a, b = a.float(), b.float()
        num += float((a - b).square().sum(dtype=torch.float64))
        den += float(b.square().sum(dtype=torch.float64))
    return (num / den) ** 0.5 if den > 0 else float(num > 0) * float("inf")


def _grads_against_plain(grads_fn, params, batch, loss_rtol, grad_rtol,
                         tag) -> tuple[float, float]:
    """The loss and every gradient of one batch through the kernels and
    through the plain versions on the card; returns (loss relative error,
    worst leaf's relative L2), raising past the bounds."""
    from repro_torch.tree import leaves_with_path

    grads, metrics = grads_fn(params, batch)
    with plain_attention():
        pgrads, pmetrics = grads_fn(params, batch)
    loss_err = abs(float(metrics["loss"]) - float(pmetrics["loss"])) / abs(
        float(pmetrics["loss"]))
    if not loss_err <= loss_rtol:
        raise AssertionError(f"{tag}: loss {float(metrics['loss'])} vs "
                             f"{float(pmetrics['loss'])} with the plain "
                             f"versions (bound {loss_rtol})")
    worst, worst_path = 0.0, None
    for (path, g), (_, pg) in zip(leaves_with_path(grads),
                                  leaves_with_path(pgrads)):
        err = rel_l2_sliced(g, pg)
        if not torch.isfinite(g).all() or not err <= grad_rtol:
            raise AssertionError(f"{tag}: gradient {'/'.join(path)} {err:.3e}"
                                 f" relative L2 from the plain versions "
                                 f"(bound {grad_rtol})")
        if err >= worst:
            worst, worst_path = err, "/".join(path)
    log(f"{tag}: loss {loss_err:.3e} relative from the plain versions, "
        f"worst gradient {worst_path} {worst:.3e} relative L2")
    return loss_err, worst


def run_training_path(dev) -> tuple[dict, dict]:
    """Path T through ``launch.train.main`` on the card, with the launch
    counts of exactly that run; its power plane held against the CPU, one
    step's loss and gradients against the plain versions; then warm
    timings."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import make_grads_fn, make_train_step

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report = train.main(TRAIN_ARGV + ["--checkpoint-dir", ckpt_dir])
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        ckpt_bytes = os.path.getsize(report.checkpoint_path)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, state = report.cfg, report.state
    steps = len(report.losses)
    # The power plane's K1-K3 launches are those of the same events on the
    # CPU (the plan does not depend on the model).
    cpu_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with count_plain_calls() as power_launches:
            cpu = train.main(TRAIN_CPU_ARGV + ["--checkpoint-dir", cpu_dir])
    finally:
        shutil.rmtree(cpu_dir, ignore_errors=True)
    want = dict(power_launches, flash_attention=2 * cfg.n_layers * steps,
                flash_attention_bwd=cfg.n_layers * steps,
                decode_attention=0, grouped_matmul=0, ssd_scan=0)
    if steps != 6 or launches != want:
        raise AssertionError(f"T: {steps} steps, kernel launches {launches}, "
                             f"expected {want}")
    if (report.plans, report.caps) != (cpu.plans, cpu.caps):
        raise AssertionError(f"T: power plane on the card {report.plans} "
                             f"{report.caps}, on the CPU {cpu.plans} "
                             f"{cpu.caps}")
    if not (np.isfinite(report.losses).all()
            and np.isfinite(report.grad_norms).all()):
        raise AssertionError(f"T: losses {report.losses}, grad norms "
                             f"{report.grad_norms}")

    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4096,
                           global_batch=4, seed=1, device=dev)
    b = data.next_batch()
    batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    grads_fn = make_grads_fn(cfg)
    loss_err, grad_err = _grads_against_plain(
        grads_fn, state.params, batch, 1e-2, 5e-2, "T bf16, full depth")

    # Warm timings: a whole step (forward, backward, AdamW; it updates the
    # state's tensors in place), AdamW alone, and one layer's forward and
    # backward.
    opt = AdamW(learning_rate=3e-4, state_dtype=cfg.optimizer_state_dtype)
    step = make_train_step(cfg, opt)
    step_ms = [_event_ms(lambda: step(state, batch)) for _ in range(2)]
    grads, _ = grads_fn(state.params, batch)
    adamw_ms = statistics.median(
        _event_ms(lambda: opt.update(grads, state.opt_state, state.params))
        for _ in range(3))
    del grads
    blk = {name: w[0].detach().requires_grad_()
           for name, w in state.params["blocks"].items()}
    h = randn((4, 4096, cfg.d_model), torch.bfloat16, dev, 5
              ).requires_grad_()
    dh = randn((4, 4096, cfg.d_model), torch.bfloat16, dev, 6)
    positions = torch.arange(4096, device=dev)[None, :]
    leaves_in = [h] + list(blk.values())

    def layer():
        out, _, _ = tfm._attn_block(blk, h, cfg, positions, None)
        torch.autograd.grad(out, leaves_in, dh)
    layer_ms = time_ms(layer)
    # Trained tokens carry weight 1 in the plan; the pods' masked examples
    # are processed on the shared card but train nothing.
    processed = 4 * 4096 * steps
    trained = float(sum(report.tokens))
    info = dict(wall_s=wall, steps_s=report.seconds,
                trained_tokens=trained,
                tokens_per_s=trained / report.seconds,
                tokens_processed=processed,
                processed_tokens_per_s=processed / report.seconds,
                warm_step_ms=statistics.median(step_ms),
                layer_fwd_bwd_ms=layer_ms, adamw_ms=adamw_ms,
                peak_memory_gb=peak_gb, peak_reserved_gb=reserved_gb,
                checkpoint_s=report.checkpoint_s,
                checkpoint_bytes=ckpt_bytes, losses=report.losses,
                grad_norms=report.grad_norms, plans=report.plans,
                caps=report.caps, loss_rel_err_plain=loss_err,
                worst_grad_rel_l2_plain=grad_err, params=cfg.param_count(),
                launches_power_plane=power_launches)
    log(f"path T: {steps} steps of 4 x 4096 tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} trained tokens/s, "
        f"{info['processed_tokens_per_s']:.1f} processed; whole driver "
        f"{wall:.3f} s, "
        f"checkpoint {report.checkpoint_s:.2f} s for {ckpt_bytes} bytes); "
        f"warm step {info['warm_step_ms']:.1f} ms, one layer forward and "
        f"backward {layer_ms:.2f} ms, AdamW {adamw_ms:.2f} ms; peak "
        f"{peak_gb:.3f} GB ({reserved_gb:.3f} GB reserved); losses "
        f"{report.losses}; grad norms {report.grad_norms}; plans "
        f"{report.plans}; caps {report.caps}; launches {launches}")
    return launches, info


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_train_f32_check(dev) -> dict:
    """MiniCPM-2B at full width, 4 layers, float32: two steps through the
    kernels and through the plain versions from one initial state, loss
    and every gradient within 1e-4 relative each step."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW, global_norm
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn

    cfg = dataclasses.replace(configs.get("minicpm_2b"), n_layers=4,
                              param_dtype="float32")
    opt = AdamW(learning_rate=1e-3)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=1024,
                           global_batch=2, seed=2, device=dev)
    grads_fn = make_grads_fn(cfg)
    errs = []
    for i in range(2):
        b = data.next_batch()
        batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
        errs.append(_grads_against_plain(grads_fn, state.params, batch, 1e-4,
                                         1e-4, f"T f32, 4 layers, step {i}"))
        grads, _ = grads_fn(state.params, batch)
        opt.update(grads, state.opt_state, state.params,
                   grad_norm=global_norm(grads))
    return dict(loss_rel_err=[e[0] for e in errs],
                worst_grad_rel_l2=[e[1] for e in errs])


#: K7's cases, ``(E, C, D, F, dtype)``: path M's three products (its
#: prefill's gate and up products, its down product, a decode step's gate
#: and up products), DeepSeekMoE's ragged d_ff of 1408 with a ragged C in
#: float32, C = 1, a D that is no multiple of K7's depth tiles, the regime
#: boundary at path M's D and F (C = 64 the narrow regime's widest N, C =
#: 72 the wide regime with 56 dead rows), a bf16 shape whose pitches TMA
#: cannot read (the CUDA-core kernel), and two views into larger
#: allocations whose rows past C and columns past D and F hold NaN (any
#: read past an edge shows), one a regime.
K7_CASES = {
    "prefill": (64, 640, 2048, 1024, torch.bfloat16),
    "prefill_down": (64, 640, 1024, 2048, torch.bfloat16),
    "decode": (64, 8, 2048, 1024, torch.bfloat16),
    "ragged_f32": (64, 650, 2048, 1408, torch.float32),
    "c1_f32": (5, 1, 1000, 136, torch.float32),
    "ragged_d_bf16": (8, 100, 1000, 200, torch.bfloat16),
    "c64_bf16": (64, 64, 2048, 1024, torch.bfloat16),
    "c72_bf16": (64, 72, 2048, 1024, torch.bfloat16),
    "pitch_bf16": (4, 33, 1001, 77, torch.bfloat16),
    "poisoned_wide": (8, 200, 1000, 1000, torch.bfloat16),
    "poisoned_narrow": (8, 5, 1000, 1000, torch.bfloat16),
}
#: The regime each case must take (``kernel.plan``).
K7_REGIMES = {"prefill": "wide", "prefill_down": "wide", "decode": "narrow",
              "ragged_f32": "cuda_core", "c1_f32": "cuda_core",
              "ragged_d_bf16": "wide", "c64_bf16": "narrow",
              "c72_bf16": "wide", "pitch_bf16": "cuda_core",
              "poisoned_wide": "wide", "poisoned_narrow": "narrow"}
#: Path M: the serving driver at OLMoE-1B-7B's full width and depth, with
#: path S's replicas, requests, prompts, tokens and cache.
MOE_ARGV = ["--arch", "olmoe_1b_7b"] + SERVE_ARGV[2:]


def k7_operands(case: str, i: int, dev):
    """x (a standard normal) and w (one scaled by 1/sqrt(D), as the model's
    weights are drawn) of ``K7_CASES[case]``; a poisoned case's are views
    into NaN-filled allocations with 56 more rows and 24 more columns."""
    e, c, d, f, dtype = K7_CASES[case]
    x = randn((e, c, d), dtype, dev, 20 + i)
    w = (randn((e, d, f), torch.float32, dev, 40 + i) * d ** -0.5).to(dtype)
    if case.startswith("poisoned"):
        big_x = torch.full((e, c + 56, d + 24), float("nan"), dtype=dtype,
                           device=dev)
        big_w = torch.full((e, d + 56, f + 24), float("nan"), dtype=dtype,
                           device=dev)
        big_x[:, :c, :d] = x
        big_w[:, :d, :f] = w
        x, w = big_x[:, :c, :d], big_w[:, :d, :f]
    return x, w


def check_k7(dev) -> dict:
    """K7 against its plain version in every case of ``K7_CASES`` (the
    attention kernels' tolerances, relative to the values' scale), in the
    regime ``K7_REGIMES`` names (the plan's shared memory equal to the
    library's own count), two launches bitwise equal, each timed beside its
    plain version and ``torch.bmm`` on the same operands.  Returns K7's
    record at path M's prefill product, with every case under ``cases``."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref

    cases = {}
    for i, (case, (e, c, d, f, dtype)) in enumerate(K7_CASES.items()):
        x, w = k7_operands(case, i, dev)
        p = kernel.plan(e, c, d, f, dtype,
                        ((x.stride(0), x.stride(1)),
                         (w.stride(0), w.stride(1))))
        if p.regime != K7_REGIMES[case] or (
                p.regime != "cuda_core"
                and kernel.smem_bytes(p.regime, c) != p.smem_bytes):
            raise AssertionError(f"K7 {case}: plan {p}, library shared "
                                 f"memory {kernel.smem_bytes(p.regime, c)}")
        got = ops.grouped_matmul(x, w)
        err = attn_err(got, ref.grouped_matmul_ref(x, w), dtype,
                       f"K7 {case} {e}x{c}x{d}x{f} {dtype} ({p.regime})")
        if not torch.equal(got, ops.grouped_matmul(x, w)):
            raise AssertionError(f"K7 {case}: two launches differ")
        ms = time_ms(lambda: ops.grouped_matmul(x, w))
        pms = time_ms(lambda: ref.grouped_matmul_ref(x, w))
        lms = time_ms(lambda: torch.bmm(x, w))
        bound, by = bound_ms(
            x.element_size() * (e * c * d + e * d * f + e * c * f),
            2.0 * e * c * d * f,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
        cases[case] = dict(shape=[e, c, d, f], dtype=str(dtype)[6:],
                           regime=p.regime, n=p.n, max_abs_err=err, ms=ms,
                           plain_ms=pms, library_ms=lms, bound_ms=bound,
                           bound_by=by)
        log(f"M: K7 {case} {e}x{c}x{d}x{f} {str(dtype)[6:]} {p.regime}"
            f"{f' n{p.n}' if p.n else ''} err {err:.3e} {ms:.4f} ms (plain "
            f"{pms:.3f} ms, bmm {lms:.4f} ms, bound {bound:.4f} ms by {by}); "
            f"rerun bitwise equal")
    main = cases["prefill"]
    bf = torch.bfloat16
    return dict(name="grouped_matmul 64x640x2048x1024", route="cuda",
                source="src/repro_torch/kernels/moe_gmm/csrc/gmm_tc.cu",
                replaces="src/repro/kernels/moe_gmm/kernel.py:46",
                max_abs_err=max(cases[k]["max_abs_err"] for k in
                                ("prefill", "prefill_down", "decode")),
                float32_max_abs_err=cases["ragged_f32"]["max_abs_err"],
                rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf],
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], cases=cases)


@contextlib.contextmanager
def plain_experts():
    """The MoE layer's expert products through K7's plain version (the
    comparison runs only)."""
    from repro_torch.kernels.moe_gmm import ref
    from repro_torch.models import moe

    with mock.patch.object(moe, "grouped_matmul", ref.grouped_matmul_ref):
        yield


@contextlib.contextmanager
def record_routes():
    """Yields a list that gains, for every MoE layer call, its top-k
    expert ids with each token's set sorted."""
    from repro_torch.models import moe

    seen, route = [], moe._route

    def recording(params, xt, cfg):
        gates, ids, aux = route(params, xt, cfg)
        seen.append(torch.sort(ids, dim=-1).values)
        return gates, ids, aux

    with mock.patch.object(moe, "_route", recording):
        yield seen


def flip_share(a: list, b: list) -> float:
    """The share of (token, layer) top-k sets that differ between two
    recorded runs of the same calls."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError("the two runs made different MoE calls")
    differ = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return differ / sum(x.shape[0] for x in a)


class _FirstLayer(Exception):
    """Stops a forward at its first MoE layer (:func:`first_moe_input`)."""


def first_moe_input(cfg, params, prompts, max_len):
    """``(block weights, input)`` of the first layer's MoE in the prefill
    of ``prompts``; the forward stops there."""
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import make_prefill_step

    seen = []

    def capture(blk, x, cfg_):
        seen.append((blk, x))
        raise _FirstLayer

    with mock.patch.object(moe, "moe_ffn", capture):
        try:
            make_prefill_step(cfg, max_len)(params, prompts)
        except _FirstLayer:
            pass
    return seen[0]


def run_moe_serving_path(dev) -> tuple[dict, dict]:
    """Path M through ``launch.serve.main`` on the card, with the launch
    counts of exactly that run (K1-K3 counted as the same cap event's CPU
    run calls their plain versions); its cap event held against the CPU;
    the first layer's MoE on the path's prefill through K7 and its plain
    version; one replica's batch fed back through the plain versions of
    K4, K6 and K7 on the card (logits within 5e-2 relative L2, the
    reference's bar for MoE in bfloat16, where routing near ties flips),
    with the share of top-k sets that differ; then warm timings."""
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(MOE_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    snap, router = serve.make_fleet(H100_HOST, n_rep)
    with count_plain_calls() as power_launches:
        routing, caps, result = serve.power_event(snap, router, 16, "cpu")
    want = dict(power_launches, flash_attention=cfg.n_layers * n_rep,
                flash_attention_bwd=0,
                decode_attention=cfg.n_layers * (steps - 1) * n_rep,
                grouped_matmul=3 * cfg.n_layers * steps * n_rep, ssd_scan=0)
    if cfg.family != "moe" or launches != want:
        raise AssertionError(f"M: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"M: routing {report.routing}")
    got = (list(report.routing_after.items()), report.caps_after,
           report.notes, report.cap_changes, report.migrations)
    cpu = (list(routing.items()), caps, list(result.notes),
           result.cap_changes, result.migrations)
    if got != cpu:
        raise AssertionError(f"M: cap event on the card {got}, on the CPU "
                             f"{cpu}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"M {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"M {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]

    # One layer: routing is the same by construction (it precedes K7).
    blk, x = first_moe_input(cfg, params, prompts, max_len)
    out, _ = moe.moe_ffn(blk, x, cfg)
    with plain_experts():
        pout, _ = moe.moe_ffn(blk, x, cfg)
    gate_err = attn_close(out, pout, 2e-2, "M: the first layer's MoE at "
                                           "prefill, K7 against plain")
    del blk, x, out, pout

    with record_routes() as k_routes:
        _, k_logits = generate(cfg, params, prompts, steps, max_len,
                               forced=toks)
    with plain_attention(), plain_experts(), record_routes() as p_routes:
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    rerun_equal = bool(torch.equal(k_logits, logits))
    flips = flip_share(k_routes, p_routes)
    err = rel_l2(logits, plain_logits)
    if not err <= 5e-2:
        raise AssertionError(f"M: teacher-forced logits {err:.3e} relative "
                             f"L2 from the plain versions (bound 5e-2); "
                             f"top-k sets differing {flips:.4f}")
    same = float((plain_logits.argmax(-1) == toks).float().mean())
    del k_routes, p_routes, k_logits, plain_logits

    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prefill_ms, step_ms = [], []
    for _ in range(3):
        start.record()
        lg, state = prefill(params, prompts)
        mid.record()
        tok = lg.argmax(-1)
        for _ in range(steps - 1):
            lg, state = decode(params, state, tok)
            tok = lg.argmax(-1)
        end.record()
        end.synchronize()
        prefill_ms.append(start.elapsed_time(mid))
        step_ms.append(mid.elapsed_time(end) / (steps - 1))
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=statistics.median(prefill_ms),
                decode_step_ms=statistics.median(step_ms),
                weights_gb=weights_gb, peak_memory_gb=peak_gb,
                first_layer_moe_max_abs_err=gate_err,
                teacher_forced_rel_l2=err, topk_sets_differing=flips,
                plain_argmax_equal=same,
                kernel_rerun_bitwise_equal=rerun_equal,
                routing=report.routing, routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count(),
                capacity_prefill=moe.expert_capacity(8 * prompt_len, cfg),
                capacity_decode=moe.expert_capacity(8, cfg))
    log(f"path M: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, peak {peak_gb:.3f} GB; first layer's MoE "
        f"{gate_err:.3e} from plain; teacher-forced logits {err:.3e} "
        f"relative L2, top-k sets differing {flips:.5f}, argmax equal "
        f"{same:.3f}, kernel rerun bitwise equal {rerun_equal}; launches "
        f"{launches}; cap event {report.caps_after} W, "
        f"{report.routing_after}, {report.notes}")
    return launches, info


def run_moe_f32_check(dev) -> dict:
    """DeepSeekMoE-16B at full width, 4 layers, float32 (shared experts,
    top-6, K7 at F = 1408): greedy tokens and every layer's routing
    identical through the kernels and through the plain versions, logits
    within 1e-4 relative L2, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get("deepseek_moe_16b"), n_layers=4,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    with record_routes() as k_routes:
        toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention(), plain_experts(), record_routes() as p_routes:
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    flips = flip_share(k_routes, p_routes)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks) or flips != 0.0:
        raise AssertionError(f"M f32: greedy tokens equal "
                             f"{torch.equal(toks, ptoks)}, top-k sets "
                             f"differing {flips}, between the kernels and "
                             f"the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"M f32: logits {err:.3e} relative L2 from the "
                             f"plain versions (bound 1e-4)")
    log(f"M f32, DeepSeekMoE-16B 4 layers: tokens and routing identical, "
        f"logits {err:.3e} relative L2")
    return dict(rel_l2=err, tokens_identical=True, routing_identical=True)


#: Paths P and H: the serving driver at Mamba2-2.7B's and Zamba2-7B's full
#: width and depth, with path S's replicas, requests, prompts, tokens and
#: cache.
SSM_ARGV = {"P": ["--arch", "mamba2_2p7b"] + SERVE_ARGV[2:],
            "H": ["--arch", "zamba2_7b"] + SERVE_ARGV[2:]}
#: K8's tolerance, relative to the values' scale (:func:`attn_close`): the
#: kernel and its plain version both sum in float32, in other orders.
K8_TOL = 1e-4
#: K8's cases at the paths' prefill: ``(B, L, H, P, N, Q)``, bf16 inputs.
K8_CASES = {"P": (8, 512, 80, 64, 128, 256), "H": (8, 512, 112, 64, 64, 256)}


def ssd_inputs(b, l, h, p, n, dtype, dev, seed: int):
    """x, dt (softplus of a normal), a_log (the model's ``log(linspace(1,
    16, H))``) and B, C rows expanded over the heads (a head stride of 0,
    as the model hands them to K8), ``dtype`` but a_log float32."""
    x = randn((b, l, h, p), dtype, dev, seed)
    dt = torch.nn.functional.softplus(randn((b, l, h), torch.float32, dev,
                                            seed + 1)).to(dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm = randn((b, l, 1, n), dtype, dev, seed + 2).expand(b, l, h, n)
    cm = randn((b, l, 1, n), dtype, dev, seed + 3).expand(b, l, h, n)
    return x, dt, a_log, bm, cm


def k8_bound(b, l, h, p, n, q, el) -> tuple[float, str]:
    """K8's least time: x, B and C read once (B and C one row shared by
    the heads), the log decay and dt in float32, y_intra, contrib and
    total written in float32; the causal operations of the two products
    and the state's outer product, over the bf16 or float32 peak."""
    nc = l // q
    n_bytes = (el * (b * l * h * p + 2 * b * l * n) + 2 * 4 * b * l * h
               + 4 * (b * l * h * p + b * nc * h * p * n + b * nc * h))
    flops = b * nc * h * (q * (q + 1) * (n + p) + 2 * q * p * n)
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS if el == 2
                    else PEAK_FP32_FLOPS)


def check_k8(dev) -> dict:
    """K8 against its plain version: at paths P's and H's prefill call in
    bf16 (B and C shared across the heads, as the model passes them; the
    tensor-core regime, as the plan must choose, with the library's shared
    memory; two launches bitwise equal; each timed beside the plain
    version), the same call with B and C packed (bitwise equal to the
    shared view), and a float32 scan with a ragged
    tail and an initial state through ``ops.ssd_scan`` against the
    sequential oracle ``ssd_ref`` (L 40, chunk 16, as in
    ``tests/test_kernels.py``).  Returns the records at P and H."""
    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records, errs = {}, {}
    for tag, (b, l, h, p, n, q) in K8_CASES.items():
        x, dt, a_log, bm, cm = ssd_inputs(b, l, h, p, n, bf, dev, 60)
        dt = dt.float()          # as ops.ssd_scan hands it to K8
        ld = dt * -torch.exp(a_log)
        plan = kernel.plan(b, l, h, p, n, q, bf,
                           (bm.stride()[:3], cm.stride()[:3]), True, sms)
        lib = (kernel.smem_bytes("intra", p, n, q, plan.intra_slice),
               kernel.smem_bytes("state", p, n, q, plan.state_slice))
        if (plan.regime != "tensor_core"
                or lib != (plan.intra_smem, plan.state_smem)):
            raise AssertionError(f"K8 {tag}: plan {plan}, expected "
                                 f"tensor_core (library shared memory {lib})")
        got = ops._intra_chunk(x, ld, dt, bm, cm, q)
        want = ref.ssd_chunk_ref(x, ld, dt, bm, cm, q)
        err = max(attn_close(g, w, K8_TOL, f"K8 {tag} {name}") for name, g, w
                  in zip(("y_intra", "contrib", "total"), got, want))
        again = ops._intra_chunk(x, ld, dt, bm, cm, q)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"K8 {tag}: two launches differ")
        packed = ops._intra_chunk(x, ld, dt, bm.contiguous(),
                                  cm.contiguous(), q)
        if not all(torch.equal(a, c) for a, c in zip(got, packed)):
            raise AssertionError(f"K8 {tag}: B and C shared across the "
                                 f"heads differ from packed copies")
        ms = time_ms(lambda: ops._intra_chunk(x, ld, dt, bm, cm, q))
        pms = time_ms(lambda: ref.ssd_chunk_ref(x, ld, dt, bm, cm, q))
        bound, by = k8_bound(b, l, h, p, n, q, 2)
        del got, want, again, packed
        log(f"{tag}: K8 {b}x{l}x{h}x{p}x{n} chunk {q} ({plan.regime}, "
            f"slices {plan.intra_slice}/{plan.state_slice}) err {err:.3e} "
            f"{ms:.4f} ms (plain {pms:.3f} ms, bound {bound:.4f} ms by {by}); "
            f"reruns and packed B, C bitwise equal")
        records[tag] = dict(
            name=f"ssd_scan {b}x{l}x{h}x{p}x{n}", route="cuda",
            source="src/repro_torch/kernels/ssd_scan/csrc/ssd_tc.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:71",
            regime=plan.regime, slices=[plan.intra_slice, plan.state_slice],
            max_abs_err=err, rtol=K8_TOL, atol_per_rms=K8_TOL, ms=ms,
            plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=None)
    x, dt, a_log, bm, cm = ssd_inputs(2, 40, 4, 16, 16, torch.float32, dev,
                                      70)
    bm, cm = bm * 0.3, cm * 0.3
    init = randn((2, 4, 16, 16), torch.float32, dev, 75) * 0.2
    y, state = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=16, init_state=init)
    oy, ostate = ref.ssd_ref(x, dt, a_log, bm, cm, init_state=init)
    errs["ragged_f32"] = max(attn_close(y, oy, K8_TOL, "K8 ragged y"),
                             attn_close(state, ostate, K8_TOL,
                                        "K8 ragged state"))
    log(f"K8 float32 L 40 chunk 16 with an initial state, against ssd_ref: "
        f"err {errs['ragged_f32']:.3e}")
    for rec in records.values():
        rec["float32_max_abs_err"] = errs["ragged_f32"]
    return records


def check_d112(dev) -> tuple[list, dict]:
    """P1's check: K4, K5 and K6 at head dim 112 against their plain
    versions at path H's shapes, in bf16 and float32: K4 and K5 on a
    prefill of 8 x 512 with 32/32 heads (the tensor cores in bf16, the CUDA
    cores in float32, as their plans must choose; two launches bitwise
    equal), K6 over a 1024-position cache with ragged lengths, at Phi-2's
    head dim 80 (4 x 512, 32 heads) and on a case whose splits are all
    fully masked but one (two launches bitwise equal each).  The bf16 calls
    are timed beside the plain versions and SDPA.  Returns the records of
    K4 and K6 for path H, and K5's errors and times."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    b, s, hq, d, cache = 8, 512, 32, 112, 1024
    g = torch.Generator(device=dev).manual_seed(80)
    kv_len = torch.randint(1, cache + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    k4, k5, k6, k80, regimes = {}, {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = attn_operands(b, s, s, hq, hq, d, dtype, dev, 81)
        want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        regimes[str(dtype)[6:]] = (
            attn_plan(q, k, v, want=want, what=f"K4 D 112 {dtype}").regime,
            attn_plan(q, k, v, do, want, f"K5 D 112 {dtype}").regime)
        k4[dtype] = k4_case(q, k, v, True, 0, f"K4 D 112 {dtype}")
        k5[str(dtype)[6:]], timed, _ = k5_case(
            q, k, v, do, True, 0, f"K5 D 112 {dtype}", bitwise=True)
        dq = randn((b, hq, d), dtype, dev, 84)
        dk, dv = (randn((b, cache, hq, d), dtype, dev, 85 + i)
                  for i in range(2))
        k6[dtype], p6 = k6_case(dq, dk, dv, kv_len, f"K6 D 112 {dtype}")
        # Phi-2's head dim (32 MHA heads of 80), outside K6's old fixed set.
        k80[str(dtype)[6:]], _ = k6_case(
            randn((4, 32, 80), dtype, dev, 95),
            randn((4, 512, 32, 80), dtype, dev, 96),
            randn((4, 512, 32, 80), dtype, dev, 97), kv_len[:4] // 2 + 1,
            f"K6 D 80 {dtype}")
    # K4 and K5 at head dim 80, which their wrappers pad to 112.
    d80 = {}
    for dtype in (torch.float32, torch.bfloat16):
        q80, k80_, v80, do80 = attn_operands(2, 256, 256, 8, 8, 80, dtype,
                                             dev, 98)
        d80[str(dtype)[6:]] = dict(
            k4=k4_case(q80, k80_, v80, True, 0, f"K4 D 80 {dtype}"),
            k5=k5_case(q80, k80_, v80, do80, True, 0, f"K5 D 80 {dtype}",
                       bitwise=True)[0])
    mq = randn((2, 4, d), torch.float32, dev, 87)
    mk = randn((2, 512, 4, d), torch.float32, dev, 88)
    mlen = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    masked, _ = k6_case(mq, mk, mk, mlen, "K6 D 112 fully masked splits", 64)

    bf = torch.bfloat16
    q, k, v, out, lse, do = timed
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ms4 = time_ms(lambda: fa_ops.flash_attention(q, k, v))
    pms4 = time_ms(lambda: fa_ref.flash_attention_ref(
        q, k, v, block_k=fa_ops.BLOCK_K))
    lms4 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    pairs = s * (s + 1) // 2
    bound4, by4 = bound_ms(2 * 4 * b * s * hq * d + 4 * b * hq * s,
                           4 * b * hq * d * pairs, PEAK_BF16_FLOPS)
    ms5 = time_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, do))
    pms5 = time_ms(lambda: fa_ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, block_q=fa_ops.BLOCK_Q,
        block_k=fa_ops.BLOCK_K))
    both5 = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), do.transpose(1, 2)))
    bound5, by5 = bound_ms(2 * 8 * b * s * hq * d + 4 * b * hq * s,
                           10 * b * hq * d * pairs, PEAK_BF16_FLOPS)
    k5_d112 = dict(regimes=regimes, errs=k5, ms=ms5, plain_ms=pms5,
                   library_ms=both5 - lms4, bound_ms=bound5, bound_by=by5,
                   d80={k: v["k5"] for k, v in d80.items()})
    log(f"H: K5 D 112 regimes {json.dumps(regimes)} errs {json.dumps(k5)} "
        f"{ms5:.4f} ms (plain {pms5:.3f} ms, SDPA backward "
        f"{both5 - lms4:.4f} ms, bound {bound5:.4f} ms)")
    times6 = time_k6(dq, dk, dv, kv_len)
    log(f"H: K4 D 112 ({regimes['bfloat16'][0]}) err {k4[bf]:.3e} (float32 "
        f"{k4[torch.float32]:.3e}) "
        f"{ms4:.4f} ms (plain {pms4:.3f} ms, SDPA {lms4:.4f} ms, bound "
        f"{bound4:.4f} ms); K6 D 112 (split {p6.split}) err {k6[bf]:.3e} "
        f"(float32 {k6[torch.float32]:.3e}, masked {masked:.3e}; D 80 "
        f"{json.dumps(k80)}) {times6['ms']:.4f} ms (plain "
        f"{times6['plain_ms']:.3f} ms, SDPA {times6['library_ms']:.4f} ms, "
        f"bound {times6['bound_ms']:.5f} ms), reruns bitwise equal, kv_len "
        f"{kv_len.tolist()}; K4 and K5 at D 80 (padded to 112) "
        f"{json.dumps(d80)}")
    src = "src/repro_torch/kernels/"
    return [dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
                 source=src + "flash_attention/csrc/flash_fwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:83",
                 regime=regimes["bfloat16"][0], max_abs_err=k4[bf],
                 float32_max_abs_err=k4[torch.float32],
                 d80_max_abs_err={k: v["k4"] for k, v in d80.items()},
                 rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf], ms=ms4,
                 plain_ms=pms4, bound_ms=bound4, bound_by=by4,
                 library_ms=lms4),
            k6_record((b, cache, hq, d), k6[bf], k6[torch.float32], p6,
                      times6, masked_max_abs_err=masked,
                      d80_max_abs_err=k80)], k5_d112


@contextlib.contextmanager
def plain_ssd():
    """The SSD scan's intra-chunk step through K8's plain version (the
    comparison runs only)."""
    from repro_torch.kernels.ssd_scan import ops, ref

    with mock.patch.object(ops, "_intra_chunk", ref.ssd_chunk_ref):
        yield


def run_ssm_serving_path(tag: str, dev) -> tuple[dict, dict]:
    """Path P or H through ``launch.serve.main`` on the card, with the
    launch counts of exactly that run (K8 once a layer a prefill; for the
    hybrid K4 once a site a prefill and K6 once a site a decode step; K1-K3
    as the same cap event's CPU run calls their plain versions); its cap
    event held against the CPU; one replica's batch fed back through the
    plain versions on the card (logits within 2e-2 relative L2); then warm
    timings."""
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SSM_ARGV[tag])
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    sites = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    snap, router = serve.make_fleet(H100_HOST, n_rep)
    with count_plain_calls() as power_launches:
        routing, caps, result = serve.power_event(snap, router, 16, "cpu")
    want = dict(power_launches, flash_attention=sites * n_rep,
                flash_attention_bwd=0,
                decode_attention=sites * (steps - 1) * n_rep,
                grouped_matmul=0, ssd_scan=cfg.n_layers * n_rep)
    family = {"P": "ssm", "H": "hybrid"}[tag]
    if cfg.family != family or launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"{tag}: routing {report.routing}")
    got = (list(report.routing_after.items()), report.caps_after,
           report.notes, report.cap_changes, report.migrations)
    cpu = (list(routing.items()), caps, list(result.notes),
           result.cap_changes, result.migrations)
    if got != cpu:
        raise AssertionError(f"{tag}: cap event on the card {got}, on the "
                             f"CPU {cpu}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"{tag} {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]
    with plain_attention(), plain_ssd():
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    err = rel_l2(logits, plain_logits)
    if not err <= 2e-2:
        raise AssertionError(f"{tag}: teacher-forced logits {err:.3e} "
                             f"relative L2 from the plain versions (bound "
                             f"2e-2)")
    same = float((plain_logits.argmax(-1) == toks).float().mean())
    del plain_logits

    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prefill_ms, step_ms = [], []
    for _ in range(3):
        start.record()
        lg, state = prefill(params, prompts)
        mid.record()
        tok = lg.argmax(-1)
        for _ in range(steps - 1):
            lg, state = decode(params, state, tok)
            tok = lg.argmax(-1)
        end.record()
        end.synchronize()
        prefill_ms.append(start.elapsed_time(mid))
        step_ms.append(mid.elapsed_time(end) / (steps - 1))
    del state
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=statistics.median(prefill_ms),
                decode_step_ms=statistics.median(step_ms),
                weights_gb=weights_gb, peak_memory_gb=peak_gb,
                teacher_forced_rel_l2=err, plain_argmax_equal=same,
                routing=report.routing, routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count())
    log(f"path {tag}: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, peak {peak_gb:.3f} GB; teacher-forced logits "
        f"{err:.3e} relative L2 (argmax equal {same:.3f}); launches "
        f"{launches}; cap event {report.caps_after} W, "
        f"{report.routing_after}, {report.notes}")
    return launches, info


def run_ssm_f32_check(arch: str, n_layers: int, dev) -> dict:
    """``arch`` at full width and ``n_layers`` layers in float32: greedy
    tokens identical through the kernels and through the plain versions,
    logits within 1e-4 relative L2, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention(), plain_ssd():
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks):
        raise AssertionError(f"{arch} f32: greedy tokens differ between the "
                             f"kernels and the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"{arch} f32: logits {err:.3e} relative L2 "
                             f"from the plain versions (bound 1e-4)")
    log(f"{arch} f32, {n_layers} layers: tokens identical, logits "
        f"{err:.3e} relative L2")
    return dict(n_layers=n_layers, rel_l2=err, tokens_identical=True)


def run_path(tag, specs, policies):
    """One grid through ``run_sweep_batched`` (the exact pack) on the card,
    with the launch counts of exactly that run."""
    from repro_torch.sim.batch import _drs_schedule
    from repro_torch.sim.sweep import build_sweep, run_sweep_batched

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep_batched(specs, policies)
    wall = time.perf_counter() - t0
    launches = read_launches()
    _, _, cfg = build_sweep(specs[0], policies[0])
    ts, drs = _drs_schedule(cfg)
    want = dict(no_model_launches(), waterfill_dense=ts.shape[0],
                balance_caps=int(drs.sum()), waterfill_segmented=0)
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"one per tick and one per DRS invocation "
                             f"{want}")
    n = len(specs) * len(policies)
    engine_s = sum(r.wall_s for per in res.values() for r in per.values())
    log(f"path {tag}: {n} cells, {ts.shape[0]} ticks, {int(drs.sum())} DRS "
        f"invocations: wall {wall:.3f} s ({n / wall:.2f} cells/s, "
        f"{ts.shape[0] / wall:.1f} ticks/s); engine {engine_s:.3f} s "
        f"({n / engine_s:.2f} cells/s); launches {launches}")
    return res, launches, dict(wall_s=wall, engine_s=engine_s, cells=n,
                               ticks=int(ts.shape[0]))


def run_vector_path(policies):
    """Path V through ``run_sweep(..., engine="vector")`` on the card, with
    the launch counts of exactly that run; then the same cells on the CPU
    and on the batched engine, both held against it."""
    from repro_torch.sim.batch import _drs_schedule
    from repro_torch.sim.sweep import (build_sweep, run_sweep,
                                       run_sweep_batched, scale_ladder)

    specs = scale_ladder(sizes=(1000,), spike="burst", duration_s=600.0)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(specs, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    keys = [(s.name, p) for s in specs for p in policies]
    _, _, cfg = build_sweep(specs[0], policies[0])
    ts, drs = _drs_schedule(cfg)
    ticks, invocations = int(ts.shape[0]), int(drs.sum())
    cpc_invocations = invocations * sum(p == "cpc" for _, p in keys)
    cpu = run_sweep(specs, policies, engine="vector", device="cpu")
    compare("V vs CPU", gpu, cpu, keys)
    # Every cpc invocation of this path commits a balance (the burst is on
    # at 300 s): the CPU run's cap changes show it, and each committed
    # balance's note waterfills twice more (imbalance before and after).
    for name, p in keys:
        if p == "cpc" and cpu[name][p].cap_changes <= 0:
            raise AssertionError(f"V {name}/cpc: no cap change on the CPU")
    want = dict(no_model_launches(), waterfill_dense=0,
                balance_caps=cpc_invocations,
                waterfill_segmented=ticks * len(keys) + 2 * cpc_invocations)
    if launches != want:
        raise AssertionError(f"V: kernel launches {launches}, expected "
                             f"{want}")
    batch = run_sweep_batched(specs, policies)
    compare("V vs batch", gpu, batch, keys)
    cells = {f"{n}/{p}": dict(wall_s=gpu[n][p].wall_s,
                              ticks_per_s=gpu[n][p].ticks_per_s,
                              cap_changes=gpu[n][p].cap_changes,
                              cpu_satisfaction=gpu[n][p].cpu_satisfaction)
             for n, p in keys}
    log(f"path V: {len(keys)} cells x {ticks} ticks, {invocations} DRS "
        f"invocation(s) a cell: wall {wall:.3f} s "
        f"({ticks * len(keys) / wall:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(cells)}")
    return launches, dict(wall_s=wall, cells=len(keys), ticks=ticks,
                          per_cell=cells)

def check_k5_wide(dev) -> list:
    """P1's check: K5 at head dims 192 (Nemotron-4-340B's, zero-padded to
    256 by the wrapper) and 256, causal, 2 x 256 tokens, 8 query heads over
    8 and over 2 KV heads, in bf16 and float32, on the CUDA cores (32-row
    blocks at D 256), each against its plain version at phase 10's
    tolerances with two launches bitwise equal; the bf16 MHA calls timed
    beside the plain version and SDPA's backward.  Returns a record for
    each head dim."""
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    b, s, hq = 2, 256, 8
    out = []
    for d in (192, 256):
        errs, timed = {}, None
        for dtype in (torch.bfloat16, torch.float32):
            for hkv in (8, 2):
                q, k, v, do = attn_operands(b, s, s, hq, hkv, d, dtype, dev,
                                            300 + d + hkv)
                p = kernel_bwd.plan(b, s, s, hq, hkv, 256, dtype)
                if p.regime != "cuda_core" or max(p.smem_bytes) > 232_448:
                    raise AssertionError(f"K5 D {d}: plan {p}")
                case = f"{str(dtype)[6:]}_{hq}/{hkv}"
                errs[case], operands, _ = k5_case(
                    q, k, v, do, True, 0, f"K5 D {d} {case}", bitwise=True)
                if dtype == torch.bfloat16 and hkv == hq:
                    timed = operands
        q, k, v, o, lse, do = timed
        ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do))
        pms = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        both_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt),
            do.transpose(1, 2)))
        pairs = s * (s + 1) // 2
        bound, by = bound_ms(2 * 8 * b * s * hq * d + 4 * b * hq * s,
                             10 * b * hq * d * pairs, PEAK_BF16_FLOPS)
        log(f"T: K5 D {d} (cuda_core, {kernel_bwd.core_rows(256)}-row "
            f"blocks, smem {p.smem_bytes[0]} B) errs {json.dumps(errs)} "
            f"{ms:.4f} ms (plain {pms:.3f} ms, SDPA backward "
            f"{both_ms - fwd_ms:.4f} ms, bound {bound:.5f} ms)")
        out.append(dict(
            name=f"flash_attention_bwd {b}x{s}x{hq}x{d}", route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
            regime="cuda_core", padded_to=256, case_errs=errs,
            max_abs_err=max(errs[f"bfloat16_{hq}/{hq}"].values()),
            rtol=K5_TOL[torch.bfloat16], atol_per_rms=K5_TOL[torch.bfloat16],
            float32_max_abs_err=max(v for c, e in errs.items()
                                    if c.startswith("float32")
                                    for v in e.values()),
            ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
            library_ms=both_ms - fwd_ms, smem_bytes=p.smem_bytes[0]))
    return out


#: Path D: ``sweep_grid_dpm``'s grid (``benchmarks/run.py``), as its
#: benchmark runs it: 100 hosts x 10 VMs, 4 churn families x 2 spikes x 2
#: host mixes x cpc/static = 32 cells, 1500 s at 15 s ticks, slot slack 1.5.
DPM_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                spikes=("burst", "prime"), heterogeneous=(False, True),
                churns=("none", "dpm", "maintenance", "failure"),
                duration_s=1500.0, tick_s=15.0)
DPM_SLACK = 1.5


def compare_final(tag, gpu, cpu, keys) -> None:
    """Final power states, occupancy and caps of two runs of one grid
    (``BatchResult``s) equal."""
    for i, (spec, p) in enumerate(keys):
        if not (np.array_equal(gpu.final_on[i], cpu.final_on[i])
                and np.array_equal(gpu.final_occ[i], cpu.final_occ[i])
                and np.allclose(gpu.final_caps[i], cpu.final_caps[i],
                                rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{tag} {spec.name}/{p}: final power "
                                 f"states, occupancy or caps differ")


def idle_share(run) -> dict:
    """One traced call of ``run``: the device's busy and idle share of its
    wall and its kernel launches, read from the ``torch.profiler`` trace as
    ``tools/profile_sweep_torch.py`` reads them (None when the trace holds
    no kernel event)."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "tools"))
    from profile_sweep_torch import busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return dict(device_idle_share=None, kernel_launches=None,
                    traced_wall_s=wall)
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    busy = busy_us(kernels + copies) * 1e-6
    return dict(device_idle_share=1.0 - busy / wall,
                kernel_launches=len(kernels), traced_wall_s=wall)


def run_churn_path(policies):
    """Path D: the ``sweep_grid_dpm`` grid through ``run_sweep(...,
    engine="batch")`` on the card, with the launch counts of exactly that
    run and the tick loop's branch reads, held against the same grid on
    the CPU (plain versions, their outermost calls counted): exact counts,
    payload and energy 1e-9, final states equal, every
    K1 and K2 launch one of the CPU run's plain calls, the budget within
    1e-6, and power-offs, power-ons and vMotions in the grid."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs = sweep.scenario_families(**DPM_GRID)
    keys = [(s, p) for s in specs for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep_batched(specs, policies, slot_slack=DPM_SLACK)
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    info, res = dict(record["info"]), record["result"]
    with count_plain_calls() as plain:
        cpu = sweep.run_sweep_batched(specs, policies, device="cpu",
                                      slot_slack=DPM_SLACK)
    cpu_res = sweep.LAST_BATCH_INFO[0]["result"]
    names = [(s.name, p) for s, p in keys]
    compare("D vs CPU", gpu, cpu, names)
    compare_final("D vs CPU", res, cpu_res, keys)
    want = dict(no_model_launches(), **plain)
    if launches != want or plain["waterfill_dense"] != info["ticks"] or \
            plain["balance_caps"] != info["invocation_ticks"]:
        raise AssertionError(f"D: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}, loop {info}")
    totals = {f: int(sum(getattr(gpu[n][p], f) for n, p in names))
              for f in ("cap_changes", "power_offs", "power_ons",
                        "vmotions")}
    if min(totals.values()) <= 0:
        raise AssertionError(f"D: the grid did not churn: {totals}")
    over = float(res.over_budget.max())
    if over > 1e-6:
        raise AssertionError(f"D: budget over by {over} W")
    cells, _ = sweep.build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=DPM_SLACK)
    traced = idle_share(sim.run)
    n = len(keys)
    engine_s = res.run_s
    out = dict(wall_s=wall, engine_s=engine_s, pack_s=res.pack_s, cells=n,
               cells_per_s=n / wall, engine_cells_per_s=n / engine_s,
               ticks=info["ticks"], invocation_ticks=info["invocation_ticks"],
               branch_reads=info["branch_reads"],
               branch_reads_per_tick=info["branch_reads"] / info["ticks"],
               max_over_budget_w=over, **totals,
               **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / info["ticks"]
    log(f"path D: {n} cells x {info['ticks']} ticks, {n / wall:.2f} cells/s "
        f"(engine {n / engine_s:.2f} cells/s, pack {res.pack_s:.3f} s); "
        f"launches {launches}; {json.dumps(out)}")
    return gpu, launches, out


def run_churn_vector_path(policies, batch):
    """Path W: the vector engine on the grid's first two ``dpm`` specs
    (the reference benchmark's sequential baseline) and its burst
    homogeneous ``maintenance`` and ``failure`` specs, on the card, held
    against the same cells on the CPU and against path D's results, with
    K3 and K2 launches equal to the CPU run's plain calls."""
    from repro_torch.sim.sweep import run_sweep, scenario_families

    specs = scenario_families(**DPM_GRID)
    chosen = [s for s in specs if s.churn == "dpm"][:2] + [
        s for s in specs if s.spike == "burst" and not s.heterogeneous
        and s.churn in ("maintenance", "failure")]
    names = [(s.name, p) for s in chosen for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(chosen, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    with count_plain_calls() as plain:
        cpu = run_sweep(chosen, policies, engine="vector", device="cpu")
    compare("W vs CPU", gpu, cpu, names)
    compare("W vs D", gpu, batch, names)
    if launches != dict(no_model_launches(), **plain):
        raise AssertionError(f"W: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}")
    ticks = gpu[names[0][0]][names[0][1]].ticks
    out = dict(wall_s=wall, cells=len(names), ticks=ticks,
               ticks_per_s=ticks * len(names) / wall,
               power_offs=sum(gpu[n][p].power_offs for n, p in names),
               vmotions=sum(gpu[n][p].vmotions for n, p in names))
    log(f"path W: {len(names)} cells x {ticks} ticks, wall {wall:.3f} s "
        f"({out['ticks_per_s']:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(out)}")
    return launches, out


def run_tree_path(policies):
    """Path R: ``row_contention_specs(sizes=(100,))`` (the ``two_row``
    budget tree binding row 0) on both engines on the card, each held
    against the CPU, with ``over_tree`` within 1e-6."""
    from repro_torch.sim import sweep

    specs = sweep.row_contention_specs(sizes=(100,))
    names = [(s.name, p) for s in specs for p in policies]
    gpu, launches_b, info = run_path("R", specs, policies)
    over_tree = float(sweep.LAST_BATCH_INFO[0]["result"].over_tree.max())
    cpu = sweep.run_sweep_batched(specs, policies, device="cpu")
    compare("R vs CPU", gpu, cpu, names)
    if over_tree > 1e-6 or float(
            sweep.LAST_BATCH_INFO[0]["result"].over_tree.max()) > 1e-6:
        raise AssertionError(f"R: a tree node over by {over_tree} W")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vgpu = sweep.run_sweep(specs, policies, engine="vector")
    vwall = time.perf_counter() - t0
    launches_v = read_launches()
    with count_plain_calls() as plain:
        vcpu = sweep.run_sweep(specs, policies, engine="vector",
                               device="cpu")
    compare("R vector vs CPU", vgpu, vcpu, names)
    compare("R vector vs batch", vgpu, gpu, names)
    if launches_v != dict(no_model_launches(), **plain):
        raise AssertionError(f"R vector: kernel launches {launches_v}, the "
                             f"CPU run's plain calls {plain}")
    info.update(max_over_tree_w=over_tree, vector_wall_s=vwall,
                vector_launches=launches_v,
                cap_changes=sum(gpu[n][p].cap_changes for n, p in names))
    log(f"path R: over_tree {over_tree:.3e} W; vector wall {vwall:.3f} s, "
        f"launches {launches_v}; {json.dumps(info)}")
    return launches_b, launches_v, info



#: Paths G and X: ``sweep_grid_rules``'s and ``sweep_grid_timed``'s grids
#: (``benchmarks/run.py:347``, ``:409``) at their own size: 32 cells of 100
#: hosts x 10 VMs each, 600 s at 10 s ticks, slot slack 1.5.
RULES_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                  spikes=("flat", "burst", "step", "prime"),
                  heterogeneous=(False, True),
                  rules=("violation_burst", "cap_blocked"),
                  duration_s=600.0, tick_s=10.0)
TIMED_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                  spikes=("burst", "prime"), heterogeneous=(False, True),
                  churns=("timed_churn", "failure_cascade"),
                  rules=("none", "violation_burst"),
                  duration_s=600.0, tick_s=10.0)
MIG_SLACK = 1.5


@contextlib.contextmanager
def record_balancer_waterfills():
    """Yields a dict, filled as the run goes, of the first K1 inputs of each
    kind the migration balancer makes (``"full"``: its ``(S, H, J)``
    entitlement waterfill, ``"pair"``: its ``(S, 2, J)`` refill): the
    path's own inputs for the kernel phase.  The calls themselves go
    through unchanged."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import ops

    seen, real_bm, real_wf = {}, ck.balance_migrations, ops.waterfill_dense

    def waterfill(capacity, floors, ceilings, weights, iters=200,
                  active=None, device=None):
        seen.setdefault("pair" if floors.shape[-2] == 2 else "full", (
            capacity.clone(), floors.clone(), ceilings.clone(),
            weights.clone(), active.clone(), iters))
        return real_wf(capacity, floors, ceilings, weights, iters, active,
                       device)

    def balance_migrations(*args, **kwargs):
        with mock.patch.object(ops, "waterfill_dense", waterfill):
            return real_bm(*args, **kwargs)

    with mock.patch.object(ck, "balance_migrations", balance_migrations):
        yield seen


def check_balancer_k1(tag: str, seen: dict, dev) -> list:
    """K1 against its plain version at the balancer's shapes, on the inputs
    a path's CPU run gave it (``record_balancer_waterfills``): bitwise,
    timed by CUDA events beside the plain version, with device time and
    bound."""
    from repro_torch.kernels.powercap import kernel, ops, ref

    out = []
    for kind in ("full", "pair"):
        cap, fl, ce, w, act = (t.to(dev) for t in seen[kind][:5])
        iters, shape = seen[kind][5], tuple(seen[kind][1].shape)
        got = ops.waterfill_dense(cap, fl, ce, w, iters, active=act)
        want = ref.waterfill_dense_ref(cap, fl, ce, w, iters, act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: K1 at the balancer's {shape} "
                                 f"differs from its plain version (max abs "
                                 f"err {err})")
        ms = time_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, iters,
                                                 active=act))
        pms = time_ms(lambda: ref.waterfill_dense_ref(cap, fl, ce, w, iters,
                                                      act))
        dms = device_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, iters,
                                                    active=act),
                        "waterfill_kernel")
        S, H, J = shape
        n = S * H * J
        trips = bisection_trips(cap, fl, ce, w, act, iters)
        b, by = bound_ms(8 * S * H + 3 * 8 * n + n + 8 * n,
                         float((4 * trips + 12).sum()) * J)
        g, k = kernel.row_shape(J)
        log(f"{tag}: K1 at the balancer's {S}x{H}x{J} (bitwise) {ms:.4f} ms, "
            f"device {fmt_ms(dms)} (plain {pms:.3f} ms), bound {b:.5f} ms")
        out.append(dict(
            name=f"waterfill_dense {S}x{H}x{J}", route="cuda",
            source="src/repro_torch/kernels/powercap/csrc/waterfill.cu",
            replaces="src/repro/kernels/powercap/kernel.py:48",
            inputs=f"the migration balancer's {kind} waterfill, from the "
                   f"path's CPU run",
            iters=iters, max_abs_err=err, bitwise=True, rtol=0.0, atol=0.0,
            ms=ms, device_ms=dms, plain_ms=pms, bound_ms=b, bound_by=by,
            library_ms=None, row_lanes=g, row_slots_a_lane=k,
            mean_trips=float(trips.double().mean())))
    return out


def cpu_migration_run(grid: dict, policies, engine: str = "batch") -> dict:
    """A migration grid on the CPU (``engine="batch"``: the whole grid at
    slot slack 1.5; ``"vector"``: the sequential baseline of path Q), the
    plain versions' outermost calls counted and the balancer's K1 inputs
    recorded.  The script makes these runs before the paths' traced ones:
    the K1 phase they feed reads device times from ``torch.profiler``,
    whose traces lose launches after a process has traced much."""
    from repro_torch.sim import sweep

    if engine == "vector":
        specs = (sweep.scenario_families(**RULES_GRID)[:2]
                 + sweep.scenario_families(**TIMED_GRID)[:2])
    else:
        specs = sweep.scenario_families(**grid)
    with count_plain_calls() as plain, record_balancer_waterfills() as seen:
        if engine == "batch":
            res = sweep.run_sweep_batched(specs, policies, device="cpu",
                                          slot_slack=MIG_SLACK)
        else:
            res = sweep.run_sweep(specs, policies, device="cpu")
    out = dict(specs=specs, res=res, plain=plain, seen=seen)
    if engine == "batch":
        (record,) = sweep.LAST_BATCH_INFO
        out.update(result=record["result"], info=dict(record["info"]))
    return out


def run_migration_path(tag: str, cpu: dict, policies, must_show):
    """Path G or X: the grid through ``run_sweep(..., engine="batch")`` on
    the card with the launch counts and reads of exactly that run, held
    against the same grid's CPU run (``cpu_migration_run``): exact counts,
    payload and energy 1e-9, final states equal, the loop's reads equal,
    every K1 and K2 launch one of the CPU run's plain calls, the budget
    within 1e-6, and ``must_show`` counts in the grid.  Returns ``(gpu
    results, launches, info)``."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs, plain = cpu["specs"], cpu["plain"]
    keys = [(s, p) for s in specs for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep_batched(specs, policies, slot_slack=MIG_SLACK)
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    info, res = dict(record["info"]), record["result"]
    names = [(s.name, p) for s, p in keys]
    compare(f"{tag} vs CPU", gpu, cpu["res"], names)
    compare_final(f"{tag} vs CPU", res, cpu["result"], keys)
    if launches != dict(no_model_launches(), **plain) or \
            plain["balance_caps"] != info["invocation_ticks"] or \
            plain["waterfill_dense"] <= info["ticks"] or \
            info != cpu["info"]:
        raise AssertionError(f"{tag}: kernel launches {launches}, the CPU "
                             f"run's plain calls {plain}, loop {info}, the "
                             f"CPU run's loop {cpu['info']}")
    totals = {f: int(sum(getattr(gpu[n][p], f) for n, p in names))
              for f in ("cap_changes", "power_offs", "power_ons",
                        "vmotions")}
    if min(totals[f] for f in must_show) <= 0:
        raise AssertionError(f"{tag}: the grid shows none of {must_show}: "
                             f"{totals}")
    over = float(res.over_budget.max())
    if over > 1e-6:
        raise AssertionError(f"{tag}: budget over by {over} W")
    cells, _ = sweep.build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=MIG_SLACK,
                           balancer=sweep.grid_balancer(specs))
    traced = idle_share(sim.run)
    n, ticks = len(keys), info["ticks"]
    out = dict(wall_s=wall, engine_s=res.run_s, pack_s=res.pack_s, cells=n,
               cells_per_s=n / wall, engine_cells_per_s=n / res.run_s,
               ticks=ticks, invocation_ticks=info["invocation_ticks"],
               branch_reads=info["branch_reads"],
               migration_reads=info["migration_reads"],
               reads_per_tick=info["branch_reads"] / ticks,
               max_over_budget_w=over, **totals, **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / ticks
    log(f"path {tag}: {n} cells x {ticks} ticks, {n / wall:.2f} cells/s "
        f"(engine {n / res.run_s:.2f} cells/s, pack {res.pack_s:.3f} s); "
        f"launches {launches}; {json.dumps(out)}")
    return gpu, launches, out


def run_migration_vector_path(policies, batches, cpu: dict):
    """Path Q: the vector engine on ``specs[:2]`` of G's and X's grids (the
    reference benchmarks' sequential baselines), cpc and static, on the
    card, held against the same cells' CPU run (``cpu_migration_run``, K1-K3
    launches equal to its plain calls) and against paths G's and X's
    results; ticks/s, launches a tick and the idle share printed.  Returns
    ``(launches, info)``."""
    from repro_torch.sim.sweep import run_sweep

    chosen = cpu["specs"]
    names = [(s.name, p) for s in chosen for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(chosen, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    compare("Q vs CPU", gpu, cpu["res"], names)
    for batch, group in zip(batches, (names[:4], names[4:])):
        compare("Q vs batch", gpu, batch, group)
    if launches != dict(no_model_launches(), **cpu["plain"]):
        raise AssertionError(f"Q: kernel launches {launches}, the CPU run's "
                             f"plain calls {cpu['plain']}")
    traced = idle_share(lambda: run_sweep(chosen, policies,
                                          engine="vector"))
    ticks = gpu[names[0][0]][names[0][1]].ticks
    out = dict(wall_s=wall, cells=len(names), ticks=ticks,
               ticks_per_s=ticks * len(names) / wall,
               cells_per_s=len(names) / wall,
               vmotions=sum(gpu[n][p].vmotions for n, p in names),
               cap_changes=sum(gpu[n][p].cap_changes for n, p in names),
               **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / (
            ticks * len(names))
    log(f"path Q: {len(names)} cells x {ticks} ticks, wall {wall:.3f} s "
        f"({out['ticks_per_s']:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(out)}")
    return launches, out

#: Worker processes for the CPU runs that paths E, U and C are held
#: against, and the torch threads each takes: they run while the card runs
#: the earlier paths.
CPU_WORKERS = 2
CPU_WORKER_THREADS = 2

#: Path E: EXPERIMENTS.md's Tables III-V as ``benchmarks/run.py`` prints
#: them, and Table II.
EVAL_SCENARIOS = ("headroom", "standby", "flexible")
#: The scenarios whose legacy CPU runs give path E's kernel phase its K2
#: and K3 inputs: 3 hosts x 10 VMs, and 32 hosts x 6-9 VMs (25 hosts under
#: statichigh).
E_RECORDED = ("headroom", "flexible")
EVAL_TABLES = {
    "headroom": "cpc:cpu0.99/vmo0;static:cpu0.99/vmo4;statichigh:cpu1.00/vmo0",
    "standby": "cpc:cpu1.00/vmo10/pow1.00;static:cpu1.00/vmo20/pow1.07;"
               "statichigh:cpu1.00/vmo10/pow1.00",
    "flexible": "cpc:cpu1.25/mem1.30/trd1.00;static:cpu1.14/mem1.30/trd0.64;"
                "statichigh:cpu1.00/mem1.00/trd1.00",
}
TABLE2 = ("400W:20hosts/cpu1.00/mem1.00;320W:25hosts/cpu1.25/mem1.25;"
          "285W:28hosts/cpu1.09/mem1.40;250W:32hosts/cpu0.90/mem1.60")
ACC_FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
              "mem_demand_mb_s", "energy_j")
ACC_COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")

#: Path U: ``scenario_families()`` (10/100/1000 hosts, burst and prime,
#: both host mixes, 1200 s at 10 s) under the three policies, and one
#: cell on another time grid that the batched engine refuses.
U_POLICIES = ("cpc", "static", "statichigh")
U_BUCKETS = [(16, 16), (128, 16), (1024, 16)]

#: Path C: ``benchmarks/sweep_sharded.py``'s ``datacenter_cell``.
C_HOSTS = 10_000
C_POLICIES = ("cpc", "static")

#: The ``budget_service`` benchmark's replay (``benchmarks/
#: check_regression.py``), and the decisions and errors the reference's
#: service gives on it (``tests/test_torch_budget_service.py`` holds the
#: port's to them bitwise on the CPU).
SVC_HOSTS, SVC_EVENTS = 50, 4000
SVC_DECISIONS, SVC_ERRORS = 820, 755


def u_specs():
    from repro_torch.sim.sweep import SweepSpec, scenario_families
    return scenario_families() + [SweepSpec(
        name="h10_burst_odd_grid", n_hosts=10, spike="burst",
        duration_s=600.0, tick_s=10.0)]


def c_spec():
    from repro_torch.sim.sweep import SweepSpec
    return SweepSpec(name=f"h{C_HOSTS}_burst", n_hosts=C_HOSTS,
                     spike="burst", rack_budget_w=230.0 * C_HOSTS,
                     duration_s=600.0, tick_s=30.0)


def eval_summary(res: dict) -> dict:
    """The parts of ``run_all``'s results the gates compare, by policy."""
    def acc(a):
        if a is None:
            return None
        return dict({f: getattr(a, f) for f in ACC_FLOATS + ACC_COUNTS},
                    tag_payload=dict(a.tag_payload),
                    tag_demand=dict(a.tag_demand))
    return {p: dict(acc=acc(r.acc), window=acc(r.window_acc),
                    events=list(r.events),
                    hosts={h: (x.powered_on, x.power_cap)
                           for h, x in r.final.hosts.items()},
                    placement={v: x.host_id for v, x in r.final.vms.items()})
            for p, r in res.items()}


def sweep_summary(res: dict) -> dict:
    return {name: {p: dataclasses.asdict(r) for p, r in per.items()}
            for name, per in res.items()}


def tree_map(fn, x):
    """``fn`` applied to each tensor in ``x`` (tensors, named tuples and
    tuples of them, other values as they are)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [tree_map(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def record_eval_inputs():
    """Yields a dict, filled as a CPU run goes, of the first inputs of each
    shape that K3's and K2's plain versions get (K3: items x hosts, K2:
    ``(S, H, J)``): path E's own inputs for its kernel phase
    (``check_eval_kernels``).  The calls themselves go through unchanged."""
    from repro_torch.kernels.powercap import ref

    seen = {}

    def recording(name, shape):
        fn = getattr(ref, f"{name}_ref")

        def call(*args):
            key = (name, shape(*args))
            if key not in seen:
                seen[key] = tree_map(torch.clone, args)
            return fn(*args)
        return call

    with mock.patch.object(ref, "waterfill_segmented_ref", recording(
            "waterfill_segmented", lambda cap, fl, *_: (cap.numel(),
                                                        fl.numel()))), \
            mock.patch.object(ref, "balance_caps_ref", recording(
                "balance_caps", lambda hosts, caps, dense, *_: tuple(
                    dense.floors.shape))):
        yield seen


def check_eval_kernels(jobs: dict, dev) -> list:
    """K3 and K2 against their plain versions on the inputs that path E's
    CPU runs of ``headroom`` and ``flexible`` on the legacy engine gave
    them, one of each shape (``record_eval_inputs``), bitwise; each timed
    beside its plain version, with its bound."""
    from repro_torch.kernels.powercap import ops, ref

    out = []
    for scenario in E_RECORDED:
        seen = jobs["E", scenario, "legacy"].result()[2]
        for (name, shape), args in sorted(seen.items()):
            args = tree_map(lambda t: t.to(dev), args)
            inputs = f"path E's CPU run of {scenario} (legacy engine)"
            if name == "balance_caps":
                out.append(check_k2(f"E {scenario}", args, bitwise=True,
                                    inputs=inputs))
                continue
            cap, fl, ce, w, lay, iters = args
            got = ops.waterfill_segmented(cap, fl, ce, w, iters=iters,
                                          layout=lay)
            want = ref.waterfill_segmented_ref(cap, fl, ce, w, lay, iters)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"E {scenario}: K3 at {shape} differs "
                                     f"from its plain version (max abs err "
                                     f"{err})")
            ms, pms, bound, by, trips = k3_cost(cap, fl, ce, w, lay, iters)
            log(f"E {scenario}: K3 at {shape[0]} hosts x {shape[1]} VMs "
                f"(bitwise) {ms:.4f} ms (plain {pms:.3f} ms), bound "
                f"{bound:.6f} ms, rows of {lay.jb} slots")
            out.append(k3_record(*shape, inputs=inputs, iters=iters,
                                 max_abs_err=err, bitwise=True, rtol=0.0,
                                 atol=0.0, ms=ms, plain_ms=pms,
                                 bound_ms=bound, bound_by=by,
                                 mean_trips=float(trips.double().mean())))
    return out


def cpu_job(kind: str, *args):
    """A CPU run in a worker process, its plain calls of K1-K3 counted:
    ``("E", scenario, engine)`` is ``run_all``, ``("U",)`` path U's
    ``run_sweep`` and ``("C",)`` path C's.  Returns ``(summary, plain
    calls, extra)``: U's and C's bucket records, or the K2 and K3 inputs
    recorded in E's run (``record_eval_inputs``)."""
    import warnings
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(CPU_WORKER_THREADS)
    from repro_torch.sim import experiments, sweep

    with count_plain_calls() as plain, warnings.catch_warnings(), \
            record_eval_inputs() as seen:
        warnings.simplefilter("ignore", RuntimeWarning)
        if kind == "E":
            out = eval_summary(experiments.run_all(args[0], engine=args[1],
                                                   device="cpu"))
        elif kind == "U":
            out = sweep.run_sweep(u_specs(), U_POLICIES, engine="batch",
                                  on_unsupported="fallback", device="cpu")
        else:
            out = sweep.run_sweep([c_spec()], C_POLICIES, engine="batch",
                                  device="cpu")
    if kind != "E":
        return sweep_summary(out), dict(plain), list(sweep.LAST_BATCH_INFO)
    return out, dict(plain), seen


def start_cpu_jobs(pool) -> dict:
    """The CPU runs, E's recording runs first: the kernel phase at the
    script's start waits for them."""
    jobs = {("E", s, "legacy"): pool.submit(cpu_job, "E", s, "legacy")
            for s in E_RECORDED}
    jobs["C",] = pool.submit(cpu_job, "C")
    jobs["U",] = pool.submit(cpu_job, "U")
    for scenario in ("flexible", "headroom", "standby"):
        for engine in ("legacy", "vector"):
            if ("E", scenario, engine) not in jobs:
                jobs["E", scenario, engine] = pool.submit(
                    cpu_job, "E", scenario, engine)
    return jobs


def compare_eval(tag: str, got: dict, want: dict) -> None:
    """Exact counts and event strings, final power states and placement,
    payload, demand, memory, energy and per-tag payload (and the window's)
    within 1e-9."""
    for p, w in want.items():
        g = got[p]
        if g["events"] != w["events"]:
            raise AssertionError(f"{tag} {p}: event strings differ")
        if g["placement"] != w["placement"]:
            raise AssertionError(f"{tag} {p}: final placement differs")
        for h, (on, cap) in w["hosts"].items():
            if g["hosts"][h][0] != on or not abs(
                    g["hosts"][h][1] - cap) <= RTOL * abs(cap):
                raise AssertionError(f"{tag} {p}: host {h} ends "
                                     f"{g['hosts'][h]}, not {(on, cap)}")
        for part in ("acc", "window"):
            a, b = g[part], w[part]
            if (a is None) != (b is None):
                raise AssertionError(f"{tag} {p}: {part} present in one run")
            if b is None:
                continue
            for f in ACC_COUNTS:
                if a[f] != b[f]:
                    raise AssertionError(f"{tag} {p} {part}: {f} {a[f]} vs "
                                         f"{b[f]}")
            pairs = [(f, a[f], b[f]) for f in ACC_FLOATS]
            if a["tag_payload"].keys() != b["tag_payload"].keys():
                raise AssertionError(f"{tag} {p}: tags differ")
            for t in b["tag_payload"]:
                pairs += [(f"payload {t}", a["tag_payload"][t],
                           b["tag_payload"][t]),
                          (f"demand {t}", a["tag_demand"][t],
                           b["tag_demand"][t])]
            for f, x, y in pairs:
                if not abs(x - y) <= RTOL * abs(y):
                    raise AssertionError(f"{tag} {p} {part} {f}: {x!r} vs "
                                         f"{y!r}")


def eval_table(summary: dict, scenario: str) -> str:
    """``benchmarks/run.py``'s Table III, IV or V line."""
    from repro_torch.sim.metrics import Accumulators, ratio_table
    accs = {}
    for p, r in summary.items():
        a = r["acc"]
        accs[p] = Accumulators(**{k: a[k] for k in ACC_FLOATS + ACC_COUNTS},
                               tag_payload=a["tag_payload"],
                               tag_demand=a["tag_demand"])
    t = ratio_table(accs, "statichigh")
    pols = ("cpc", "static", "statichigh")
    if scenario == "headroom":
        return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                        f"/vmo{t[p]['vmotions']}" for p in pols)
    if scenario == "standby":
        return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                        f"/vmo{t[p]['vmotions']}"
                        f"/pow{t[p]['power_ratio']:.2f}" for p in pols)
    return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                    f"/mem{t[p]['mem_payload_ratio']:.2f}"
                    f"/trd{accs[p].tag_satisfaction('trading'):.2f}"
                    for p in pols)


def run_eval_path(jobs: dict):
    """Path E: ``run_all`` of the three scenarios on the legacy and the
    vector engine on the card, each held against its CPU run (counts and
    event strings exact, accumulators 1e-9, K1-K3 launches equal to its
    plain calls), legacy against vector on the card; Tables II-V printed
    and held to EXPERIMENTS.md's lines.  Returns ``(launches, info)``."""
    from repro_torch.core.power_model import PAPER_HOST, deployment_table
    from repro_torch.sim import experiments

    rows = deployment_table(PAPER_HOST, 8000.0, [400, 320, 285, 250])
    table2 = ";".join(f"{int(r['power_cap_w'])}W:{r['host_count']}hosts"
                      f"/cpu{r['capacity_ratio']:.2f}"
                      f"/mem{r['memory_ratio']:.2f}" for r in rows)
    if table2 != TABLE2:
        raise AssertionError(f"E: Table II {table2}")
    log(f"E: Table II {table2}")
    launches = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
    got, info = {}, {"table2": table2, "engines": {}}
    for engine in ("legacy", "vector"):
        per = info["engines"][engine] = {}
        for scenario in EVAL_SCENARIOS:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = experiments.run_all(scenario, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = read_launches()
            got[scenario, engine] = summary = eval_summary(res)
            cpu, plain, _ = jobs["E", scenario, engine].result()
            compare_eval(f"E {scenario}/{engine} vs CPU", summary, cpu)
            if run_launches != dict(no_model_launches(), **plain):
                raise AssertionError(
                    f"E {scenario}/{engine}: kernel launches "
                    f"{run_launches}, the CPU run's plain calls {plain}")
            line = eval_table(summary, scenario)
            if line != EVAL_TABLES[scenario]:
                raise AssertionError(f"E {scenario}/{engine}: {line}")
            launches = {k: launches[k] + run_launches[k] for k in launches}
            per[scenario] = dict(
                wall_s=wall, launches={k: run_launches[k] for k in KERNELS},
                table=line, counts={p: {f: summary[p]["acc"][f]
                                        for f in ACC_COUNTS}
                                    for p in summary})
            log(f"E {scenario}/{engine}: wall {wall:.3f} s, launches "
                f"{json.dumps(per[scenario]['launches'])}; {line}")
    for scenario in EVAL_SCENARIOS:
        compare_eval(f"E {scenario} legacy vs vector",
                     got[scenario, "legacy"], got[scenario, "vector"])
    for engine, per in info["engines"].items():
        log(f"E {engine}: wall {sum(r['wall_s'] for r in per.values()):.3f}"
            f" s for the 9 runs")
    return launches, info


def run_bucket_path(job):
    """Path U: ``run_sweep(u_specs(), engine="batch",
    on_unsupported="fallback")`` on the card: three pad buckets of 12
    cells and the odd-grid cells on the vector engine, with its warning;
    held against the CPU run of the same call (counts exact, 1e-9, final
    states equal, K1-K3 launches equal to its plain calls) and against
    ``run_sweep_batched`` on the card (counts equal, 1e-12).  Returns
    ``(launches, info)``."""
    import warnings
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs = u_specs()
    per_bucket = []
    real = BatchedSimulator.run_async

    def counted(sim):
        before = read_launches()
        pending = real(sim)
        after = read_launches()
        per_bucket.append({k: after[k] - before[k] for k in KERNELS})
        return pending

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(BatchedSimulator, "run_async", counted), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gpu = sweep.run_sweep(specs, U_POLICIES, engine="batch",
                              on_unsupported="fallback")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    records = list(sweep.LAST_BATCH_INFO)
    odd = [f"{specs[-1].name}/{p}" for p in U_POLICIES]
    said = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    if len(said) != 1 or "sequential vector engine" not in said[0] or \
            not all(name in said[0] for name in odd):
        raise AssertionError(f"U: the fallback warning {said}")
    if [r["bucket"] for r in records] != U_BUCKETS or \
            [r["n_cells"] for r in records] != [12] * len(U_BUCKETS):
        shapes = [(r["bucket"], r["n_cells"]) for r in records]
        raise AssertionError(f"U: buckets {shapes}")
    for r, n in zip(records, per_bucket):
        want = dict(waterfill_dense=r["info"]["ticks"],
                    balance_caps=r["info"]["invocation_ticks"],
                    waterfill_segmented=0)
        if n != want:
            raise AssertionError(f"U bucket {r['bucket']}: launches {n}, "
                                 f"expected {want}")
    cpu, plain, cpu_records = job.result()
    names = [(s.name, p) for s in specs for p in U_POLICIES]
    compare("U vs CPU", gpu, sweep_results(cpu), names)
    for r, c in zip(records, cpu_records):
        keys = [n.split("/") for n in r["result"].names]
        compare_final(f"U bucket {r['bucket']} vs CPU", r["result"],
                      c["result"], [(SimpleNamespace(name=n), p)
                                    for n, p in keys])
    if launches != dict(no_model_launches(), **plain):
        raise AssertionError(f"U: kernel launches {launches}, the CPU "
                             f"run's plain calls {plain}")
    batched = specs[:-1]
    cells = sweep.build_batch_cells(batched, U_POLICIES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exact = sweep.run_sweep_batched(batched, U_POLICIES, _prebuilt=cells)
    torch.cuda.synchronize()
    exact_wall = time.perf_counter() - t1
    exact_record = dict(sweep.LAST_BATCH_INFO[0])
    compare("U bucketed vs exact pack", gpu, exact,
            [(s.name, p) for s in batched for p in U_POLICIES], rtol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        traced = idle_share(lambda: sweep.run_sweep(
            specs, U_POLICIES, engine="batch", on_unsupported="fallback"))
    n = len(names)
    buckets = [dict({k: r[k] for k in ("bucket", "n_cells", "n_devices",
                                        "compile_s", "pack_s", "run_s",
                                        "wall_s")},
                    launches=per, **r["info"])
               for r, per in zip(records, per_bucket)]
    out = dict(wall_s=wall, cells=n, cells_per_s=n / wall,
               fallback_cells=len(odd), buckets=buckets,
               exact_pack_wall_s=exact_wall,
               exact_pack_run_s=exact_record["run_s"],
               exact_pack_shape=list(exact_record["result"].final_occ.shape),
               cap_changes=sum(gpu[a][b].cap_changes for a, b in names),
               **traced)
    for b in buckets:
        log(f"U bucket {b['bucket']}: {json.dumps(b)}")
    log(f"path U: {n} cells ({len(odd)} on the vector engine), wall "
        f"{wall:.3f} s ({n / wall:.2f} cells/s), exact pack "
        f"{exact_wall:.3f} s; launches {launches}; {json.dumps(out)}")
    return launches, out


def sweep_results(summary: dict) -> dict:
    """``sweep_summary``'s dicts as objects ``compare`` reads."""
    return {n: {p: SimpleNamespace(**r) for p, r in per.items()}
            for n, per in summary.items()}


def run_datacenter_path(job):
    """Path C: ``datacenter_cell`` (10,000 hosts x 10 VMs, 230 W a host,
    burst, 600 s at 30 s) under cpc and static through ``run_sweep(...,
    engine="batch")`` on the card, one pad bucket of (16384, 16): held
    against its CPU run (counts exact, 1e-9, final states equal, K1 and
    K2 launches its plain calls), the cpc cell changing caps.  Returns
    ``(launches, info)``."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    spec = c_spec()
    names = [(spec.name, p) for p in C_POLICIES]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep([spec], C_POLICIES, engine="batch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    if record["bucket"] != (sweep._pow2(C_HOSTS), 16):
        raise AssertionError(f"C: bucket {record['bucket']}")
    cpu, plain, (cpu_record,) = job.result()
    compare("C vs CPU", gpu, sweep_results(cpu), names)
    compare_final("C vs CPU", record["result"], cpu_record["result"],
                  [(spec, p) for p in C_POLICIES])
    if launches != dict(no_model_launches(), **plain) or \
            plain["waterfill_dense"] != record["info"]["ticks"]:
        raise AssertionError(f"C: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}")
    if gpu[spec.name]["cpc"].cap_changes <= 0:
        raise AssertionError("C: the cpc cell changed no cap")
    cells, _ = sweep.build_batch_cells([spec], C_POLICIES)
    sim = BatchedSimulator(cells, slot_slack=3.0,
                           pad_hosts=sweep._pow2(C_HOSTS), pad_slots=16)
    traced = idle_share(sim.run)
    out = dict(wall_s=wall, bucket=list(record["bucket"]),
               compile_s=record["compile_s"], pack_s=record["pack_s"],
               run_s=record["run_s"], **record["info"],
               cap_changes={p: gpu[spec.name][p].cap_changes
                            for p in C_POLICIES},
               cpu_satisfaction={p: gpu[spec.name][p].cpu_satisfaction
                                 for p in C_POLICIES}, **traced)
    log(f"path C: {C_HOSTS} hosts, bucket {record['bucket']}, wall "
        f"{wall:.3f} s (engine {record['run_s']:.3f} s, pack "
        f"{record['pack_s']:.3f} s); launches {launches}; {json.dumps(out)}")
    return launches, out


def run_service_phase(smi: str) -> dict:
    """The ``budget_service`` benchmark's replay on the port: 50 hosts, the
    two-row tree with row 0 at 45% of the budget, 4,000 events from seed
    0; headroom against brute force at the reference's 1e-9 bar, the
    decision and error counts the reference's; p50/p99 host latencies."""
    from repro_torch.core.budget_tree import BudgetTree
    from repro_torch.runtime import budget_service as bsvc

    budget = 250.0 * SVC_HOSTS
    tree = BudgetTree.two_rows(budget, SVC_HOSTS, row0_limit=0.45 * budget)
    hosts = [f"host{i}" for i in range(SVC_HOSTS)]
    on = np.ones(SVC_HOSTS, dtype=bool)
    caps0 = tree.project(np.full(SVC_HOSTS, 250.0), on,
                         floors=np.zeros(SVC_HOSTS))
    svc = bsvc.BudgetService(tree, hosts, caps0, on)
    rep = svc.replay(bsvc.synthetic_feed(tree, n_events=SVC_EVENTS, seed=0))
    parity = max(abs(svc.headroom(h) - svc.brute_force_headroom(h))
                 for h in hosts)
    if parity > 1e-9 or (rep.n_decisions, rep.n_errors) != (SVC_DECISIONS,
                                                             SVC_ERRORS):
        raise AssertionError(f"service: parity {parity}, decisions "
                             f"{rep.n_decisions}, errors {rep.n_errors}")
    out = dict(n_events=rep.n_events, n_decisions=rep.n_decisions,
               n_errors=rep.n_errors, host_p50_us=rep.p50_us,
               host_p99_us=rep.p99_us, headroom_parity_max_w=parity,
               card=smi)
    log(f"service: {rep.n_events} events, {rep.n_decisions} decisions, "
        f"{rep.n_errors} errors; host latency p50 {rep.p50_us:.2f} us, "
        f"p99 {rep.p99_us:.2f} us (on the host beside {smi}); headroom "
        f"against brute force {parity:.3e} W")
    return out


@contextlib.contextmanager
def cpu_workers():
    """Paths E's, U's and C's CPU runs, started in worker processes
    (``start_cpu_jobs``) that run while the card runs the paths before
    them; yields their futures.  On a failure the workers are stopped, not
    waited for."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(CPU_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        yield start_cpu_jobs(pool)
    except BaseException:
        for proc in list((pool._processes or {}).values()):
            proc.terminate()
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    pool.shutdown(wait=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sim.sweep import run_sweep_batched, scenario_families

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    torch.cuda.init()
    # Float32 products in full float32 on the card (the plain versions'
    # comparisons assume it), stated rather than left to the defaults.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"build: {build_all():.2f} s")
    with cpu_workers() as jobs:
        # Path V's BalancePowerCap is the object plane's, with 200 trips;
        # the reference's datacenter_cell is one cell of 10,000 hosts.
        shapes = {"A": (32, 100, 10, True, 100),
                  "B": (16, 1000, 10, True, 100),
                  "V": (1, 1000, 10, False, 200),
                  "cell": (1, 10_000, 10, False, 100),
                  "D": (32, 100, 15, True, 100),
                  "W": (1, 100, 10, False, 200),
                  "R": (2, 100, 10, True, 100),
                  "G": (32, 100, 15, False, 100),
                  "X": (32, 100, 15, False, 100),
                  "Q": (1, 100, 10, False, 200),
                  "U": (12, 1024, 16, True, 100),
                  "C": (2, 16_384, 16, True, 100)}
        records = check_kernels(shapes, dev)
        records["V"][0]["datacenter_cell"] = records.pop("cell")[0]
        records["V"].append(check_k3(dev))
        k3_100 = check_k3(dev, m_path=100, tag="W")
        records["W"].append(k3_100)
        records["R"].append(dict(k3_100))
        records["Q"].append(check_k3(dev, m_path=100, tag="Q"))
        records["E"] = check_eval_kernels(jobs, dev)
        rows = check_row_shapes(dev)
        cpu_g = cpu_migration_run(RULES_GRID, ("cpc", "static"))
        cpu_x = cpu_migration_run(TIMED_GRID, ("cpc", "static"))
        cpu_q = cpu_migration_run(None, ("cpc", "static"), engine="vector")
        for tag, cpu in (("G", cpu_g), ("X", cpu_x), ("Q", cpu_q)):
            records[tag] = (check_balancer_k1(tag, cpu["seen"], dev)
                            + records[tag])
        for rec in records["A"] + records["V"][1:]:
            rec["row_shapes_max_abs_err"] = rows[
                {"waterfill_dense": "K1", "balance_caps": "K2",
                 "waterfill_segmented": "K3"}[rec["name"].split()[0]]]

        policies = ("cpc", "static")
        specs_a = scenario_families(
            sizes=(100,), budgets_per_host_w=(230.0, 250.0),
            spikes=("flat", "burst", "step", "prime"),
            heterogeneous=(False, True), duration_s=600.0)
        gpu_a, launches_a, info_a = run_path("A", specs_a, policies)
        cpu_a = run_sweep_batched(specs_a, policies, device="cpu")
        compare("A", gpu_a, cpu_a, [(s.name, p) for s in specs_a
                                    for p in policies])

        specs_b = scenario_families(
            sizes=(1000,), budgets_per_host_w=(250.0,),
            spikes=("flat", "burst", "step", "prime"),
            heterogeneous=(False, True), duration_s=1200.0)
        gpu_b, launches_b, info_b = run_path("B", specs_b, policies)
        held = [s for s in specs_b if s.spike == "burst" and s.heterogeneous]
        cpu_b = run_sweep_batched(held, policies, device="cpu")
        compare("B", gpu_b, cpu_b,
                [(s.name, p) for s in held for p in policies])

        launches_v, info_v = run_vector_path(policies)

        gpu_d, launches_d, info_d = run_churn_path(policies)
        launches_w, info_w = run_churn_vector_path(policies, gpu_d)
        launches_rb, launches_rv, info_r = run_tree_path(policies)
        launches_r = {k: launches_rb[k] + launches_rv[k] for k in launches_rb}

        gpu_g, launches_g, info_g = run_migration_path(
            "G", cpu_g, policies, ("cap_changes", "vmotions"))
        gpu_x, launches_x, info_x = run_migration_path(
            "X", cpu_x, policies, ("cap_changes", "vmotions", "power_ons"))
        launches_q, info_q = run_migration_vector_path(
            policies, (gpu_g, gpu_x), cpu_q)

        launches_e, info_e = run_eval_path(jobs)
        launches_u, info_u = run_bucket_path(jobs["U",])
        launches_c, info_c = run_datacenter_path(jobs["C",])
        info_svc = run_service_phase(smi)

        records["S"] = [check_k4(dev), check_k6(dev)]
        launches_s, info_s = run_serving_path(dev)
        torch.cuda.empty_cache()
        info_s["float32_4_layers"] = run_f32_depth_check(dev)
        torch.cuda.empty_cache()

        records["T"] = check_k5(dev) + check_k5_wide(dev)
        torch.cuda.empty_cache()
        launches_t, info_t = run_training_path(dev)
        torch.cuda.empty_cache()
        info_t["float32_4_layers"] = run_train_f32_check(dev)
        torch.cuda.empty_cache()

        records["M"] = [check_k7(dev)] + check_m_attention(dev)
        launches_m, info_m = run_moe_serving_path(dev)
        torch.cuda.empty_cache()
        info_m["deepseek_float32_4_layers"] = run_moe_f32_check(dev)
        torch.cuda.empty_cache()

        k8 = check_k8(dev)
        records["P"] = [k8["P"]]
        d112, records["T"][1]["d112"] = check_d112(dev)
        records["H"] = [k8["H"]] + d112
        torch.cuda.empty_cache()
        launches_p, info_p = run_ssm_serving_path("P", dev)
        torch.cuda.empty_cache()
        launches_h, info_h = run_ssm_serving_path("H", dev)
        torch.cuda.empty_cache()
        info_p["float32_4_layers"] = run_ssm_f32_check("mamba2_2p7b", 4, dev)
        torch.cuda.empty_cache()
        info_h["float32_7_layers"] = run_ssm_f32_check("zamba2_7b", 7, dev)

        kernels_out = []
        for tag, launches in (("A", launches_a), ("B", launches_b),
                              ("V", launches_v), ("D", launches_d),
                              ("W", launches_w), ("R", launches_r),
                              ("G", launches_g), ("X", launches_x),
                              ("Q", launches_q), ("E", launches_e),
                              ("U", launches_u), ("C", launches_c),
                              ("S", launches_s),
                              ("T", launches_t), ("M", launches_m),
                              ("P", launches_p), ("H", launches_h)):
            for rec in records[tag]:
                name = rec["name"].split()[0]
                kernels_out.append(dict(rec, launches=launches[name],
                                        path=tag))

    log(json.dumps({"paths": {"A": info_a, "B": info_b, "V": info_v,
                              "D": info_d, "W": info_w, "R": info_r,
                              "G": info_g, "X": info_x, "Q": info_q,
                              "E": info_e, "U": info_u, "C": info_c,
                              "service": info_svc, "S": info_s,
                              "T": info_t, "M": info_m, "P": info_p,
                              "H": info_h}}))
    log(json.dumps({"kernels": kernels_out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
