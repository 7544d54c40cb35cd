#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which raises (and so exits non-zero) when it fails:

1. the card: its name and power limit, as ``nvidia-smi`` prints them;
2. the build: ``nvcc`` compiles the powercap kernels from ``csrc/``;
3. each kernel against its plain PyTorch version on the card, in fp64, at
   the main paths' shapes, timed with CUDA events (median of 20);
4. main path A, the ``sweep_grid`` grid (32 cells x 100 hosts x 10 VMs),
   through ``run_sweep(..., engine="batch")`` on the card, held against
   the same grid run on the CPU (plain versions), with every kernel's
   launch count checked;
5. main path B, 16 cells x 1000 hosts x 10 VMs over 120 ticks, with one
   spec's two cells held against a CPU run of those two cells alone.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): fp64 outside the tensor cores, and
#: HBM3 bandwidth.  The kernels are fp64 vector code.
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_S = 3.35e12
REPS = 20
RTOL = ATOL = 1e-9
F64 = torch.float64


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP64_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def kernel_inputs(S: int, H: int, J: int, seed: int, dev):
    """Random cells with both host types, some hosts off, some cells with
    the policy disabled, reservations, limits, hot hosts, and poisoned
    (large, stale) values in the inactive slots."""
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
    enabled = torch.as_tensor(rng.rand(S) < 0.9, device=dev)
    return dict(
        hosts=hosts, caps=t["caps"], budget=t["budget"], enabled=enabled,
        cpu_res=t["cpu_res"],
        dense=ck.DenseCols(t["floors"], t["ceils"], t["weights"], act, 100),
        wf=(ck.managed_capacity(hosts, t["caps"]), t["dfl"], t["dem"],
            t["weights"], act))


def check_kernels(shapes, dev) -> dict:
    """K1 and K2 against their plain versions at each (S, H, J)."""
    from repro_torch.core.kernels import BalanceParams
    from repro_torch.kernels.powercap import ops, ref

    params = BalanceParams()
    out = {}
    for tag, (S, H, J) in shapes.items():
        x = kernel_inputs(S, H, J, seed=S * 7919 + H, dev=dev)
        cap, fl, ce, w, act = x["wf"]
        k1 = ops.waterfill_dense(cap, fl, ce, w, 100, active=act)
        p1 = ref.waterfill_dense_ref(cap, fl, ce, w, 100, act)
        torch.cuda.synchronize()
        err1 = float((k1 - p1).abs().max())
        if not torch.allclose(k1, p1, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K1 {tag}: kernel and plain version differ "
                                 f"(max abs err {err1})")
        ms1 = time_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, 100,
                                                  active=act))
        pms1 = time_ms(lambda: ref.waterfill_dense_ref(cap, fl, ce, w, 100,
                                                       act))
        n = S * H * J
        b1, by1 = bound_ms(8 * S * H + 3 * 8 * n + n + 8 * n,
                           (4 * 100 + 12) * n)

        args = (x["hosts"], x["caps"], x["dense"], x["cpu_res"], x["budget"],
                x["enabled"], params)
        kc, kd, kr = ops.balance_caps(*args)
        pc, pd, pr = ref.balance_caps_ref(*args)
        torch.cuda.synchronize()
        err2 = float((kc - pc).abs().max())
        if not torch.allclose(kc, pc, rtol=RTOL, atol=0.0):
            raise AssertionError(f"K2 {tag}: caps differ (max abs err "
                                 f"{err2})")
        if not torch.equal(kd, pd):
            raise AssertionError(f"K2 {tag}: did flags differ")
        rounds_equal = bool(torch.equal(kr, pr))
        ms2 = time_ms(lambda: ops.balance_caps(*args))
        pms2 = time_ms(lambda: ref.balance_caps_ref(*args))
        waterfills = float((1 + pr.double()).sum()) * H
        b2, by2 = bound_ms((1 + 4 * 8 + 8 + 8 + 8) * S * H + 25 * n + 9 * S
                           + 5 * S, waterfills * (4 * 100 + 12) * J
                           + float(pr.double().sum()) * 40 * H)
        log(f"{tag}: K1 err {err1:.3e} {ms1:.4f} ms (plain {pms1:.3f} ms); "
            f"K2 err {err2:.3e} rounds {pr.tolist()} equal={rounds_equal} "
            f"{ms2:.4f} ms (plain {pms2:.3f} ms)")
        out[tag] = [
            dict(name=f"waterfill_dense {S}x{H}x{J}", route="cuda",
                 source="src/repro_torch/kernels/powercap/csrc/waterfill.cu",
                 replaces="src/repro/kernels/powercap/kernel.py:48",
                 max_abs_err=err1, rtol=RTOL, atol=ATOL, ms=ms1,
                 plain_ms=pms1, bound_ms=b1, bound_by=by1, library_ms=None),
            dict(name=f"balance_caps {S}x{H}x{J}", route="cuda",
                 source="src/repro_torch/kernels/powercap/csrc/balance.cu",
                 replaces="src/repro/kernels/powercap/kernel.py:109",
                 max_abs_err=err2, rtol=RTOL, atol=0.0, ms=ms2,
                 plain_ms=pms2, bound_ms=b2, bound_by=by2, library_ms=None,
                 rounds_equal_plain=rounds_equal)]
    return out


def compare(tag, gpu, cpu, keys) -> None:
    """Exact cap-change counts, rtol 1e-9 on payload and energy."""
    for spec_name, policy in keys:
        g, c = gpu[spec_name][policy], cpu[spec_name][policy]
        if g.cap_changes != c.cap_changes:
            raise AssertionError(f"{tag} {spec_name}/{policy}: cap changes "
                                 f"{g.cap_changes} on the card, "
                                 f"{c.cap_changes} on the CPU")
        for f in ("cpu_payload_mhz_s", "energy_j"):
            a, b = getattr(g, f), getattr(c, f)
            if not abs(a - b) <= RTOL * abs(b):
                raise AssertionError(f"{tag} {spec_name}/{policy} {f}: "
                                     f"{a!r} vs {b!r}")
        if not np.isfinite(g.cpu_payload_mhz_s) or g.cpu_payload_mhz_s <= 0:
            raise AssertionError(f"{tag} {spec_name}/{policy}: no payload")


def run_path(tag, specs, policies):
    """One grid through ``run_sweep`` on the card, with the launch counts
    of exactly that run."""
    from repro_torch.kernels.powercap import ops
    from repro_torch.sim.batch import _drs_schedule
    from repro_torch.sim.sweep import build_sweep, run_sweep

    ops.waterfill_dense.launches = 0
    ops.balance_caps.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(specs, policies, engine="batch")
    wall = time.perf_counter() - t0
    launches = {"waterfill_dense": ops.waterfill_dense.launches,
                "balance_caps": ops.balance_caps.launches}
    _, _, cfg = build_sweep(specs[0], policies[0])
    ts, drs = _drs_schedule(cfg)
    want = {"waterfill_dense": ts.shape[0], "balance_caps": int(drs.sum())}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.powercap import kernel
    from repro_torch.sim.sweep import run_sweep, scenario_families

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    torch.cuda.init()

    build_s, ptxas = kernel.build()
    print(ptxas, file=sys.stderr, flush=True)
    kernel.library()
    log(f"build: {build_s:.2f} s")

    shapes = {"A": (32, 100, 10), "B": (16, 1000, 10)}
    records = check_kernels(shapes, dev)

    policies = ("cpc", "static")
    specs_a = scenario_families(
        sizes=(100,), budgets_per_host_w=(230.0, 250.0),
        spikes=("flat", "burst", "step", "prime"),
        heterogeneous=(False, True), duration_s=600.0)
    gpu_a, launches_a, info_a = run_path("A", specs_a, policies)
    cpu_a = run_sweep(specs_a, policies, engine="batch", device="cpu")
    compare("A", gpu_a, cpu_a, [(s.name, p) for s in specs_a
                                for p in policies])

    specs_b = scenario_families(
        sizes=(1000,), budgets_per_host_w=(250.0,),
        spikes=("flat", "burst", "step", "prime"),
        heterogeneous=(False, True), duration_s=1200.0)
    gpu_b, launches_b, info_b = run_path("B", specs_b, policies)
    held = [s for s in specs_b if s.spike == "burst" and s.heterogeneous]
    cpu_b = run_sweep(held, policies, engine="batch", device="cpu")
    compare("B", gpu_b, cpu_b, [(s.name, p) for s in held for p in policies])

    kernels_out = []
    for tag, launches in (("A", launches_a), ("B", launches_b)):
        for rec, name in zip(records[tag],
                             ("waterfill_dense", "balance_caps")):
            kernels_out.append(dict(rec, launches=launches[name],
                                    path=tag))
    log(json.dumps({"paths": {"A": info_a, "B": info_b}}))
    log(json.dumps({"kernels": kernels_out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
