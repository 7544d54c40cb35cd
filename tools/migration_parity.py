#!/usr/bin/env python3
"""Both packages' engines on ``sweep_grid_rules``'s or ``sweep_grid_timed``'s
grid, on the CPU: where the reference's own engines split, and where the
port follows them.

Runs the grid (``benchmarks/run.py:347`` or ``:409``, at ``N_HOSTS``
hosts) through the reference's batched engine (JAX, float64) and its
vector engine, cell by cell, and through the port's batched engine (and,
with ``--vector``, its vector engine) with ``device="cpu"``; prints, per
cell, whether the reference's two engines agree (exact counts, payload
and energy to 1e-9) and whether each port engine equals them (its batched
engine: the final slot occupancy too), then each engine's totals of cap
changes, vMotions, power-ons and power-offs.

    PYTHONPATH=src python3 tools/migration_parity.py {G,X} [N_HOSTS] [--vector]

At 100 hosts a grid takes a few minutes on one core.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
FLOATS = ("cpu_payload_mhz_s", "energy_j")


def grid(which: str, n: int) -> dict:
    if which == "G":
        return dict(sizes=(n,), budgets_per_host_w=(250.0,),
                    spikes=("flat", "burst", "step", "prime"),
                    heterogeneous=(False, True),
                    rules=("violation_burst", "cap_blocked"),
                    duration_s=600.0, tick_s=10.0)
    return dict(sizes=(n,), budgets_per_host_w=(250.0,),
                spikes=("burst", "prime"), heterogeneous=(False, True),
                churns=("timed_churn", "failure_cascade"),
                rules=("none", "violation_burst"), duration_s=600.0,
                tick_s=10.0)


def same(a: tuple, b: tuple) -> bool:
    n = len(COUNTS)
    return (tuple(a[:n]) == tuple(b[:n])
            and all(abs(x - y) <= 1e-9 * abs(y)
                    for x, y in zip(a[n:], b[n:])))


def row(r) -> tuple:
    return tuple(int(getattr(r, f)) for f in COUNTS) + tuple(
        float(getattr(r, f)) for f in FLOATS)


def main() -> int:
    import jax
    import jax.experimental
    import torch

    # JAX 0.9 dropped ``jax.experimental.enable_x64``, which the reference
    # imports (ROADMAP fault F1): a stand-in for this process only.
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = enable_x64
    from repro.sim import sweep as ref_sweep
    from repro.sim.batch import BatchedSimulator as RefSimulator
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    torch.use_deterministic_algorithms(True)
    which = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 and sys.argv[2].isdigit() \
        else 100
    policies = ("cpc", "static")
    g = grid(which, n)
    ref_specs = ref_sweep.scenario_families(**g)
    ref_cells, _ = ref_sweep._build_batch_cells(ref_specs, policies)
    want = RefSimulator(ref_cells, slot_slack=1.5,
                        balancer=ref_sweep._grid_balancer(ref_specs)).run()
    specs = sweep.scenario_families(**g)
    cells, keys = sweep.build_batch_cells(specs, policies)
    got = BatchedSimulator(cells, slot_slack=1.5,
                           balancer=sweep.grid_balancer(specs),
                           device="cpu").run()
    vec = (sweep.run_sweep(specs, policies, device="cpu")
           if "--vector" in sys.argv else None)
    totals = {k: np.zeros(len(COUNTS), dtype=np.int64)
              for k in ("reference batched", "reference vector",
                        "port batched", "port vector")}
    splits = 0
    for i, (spec, p) in enumerate(keys):
        ref_b = tuple(row(want.accumulators(i)))
        ref_v = row(ref_sweep.run_cell(ref_specs[i // 2], p))
        port_b = row(got.accumulators(i))
        occ = np.array_equal(got.final_occ[i], want.final_occ[i])
        agree = same(ref_b, ref_v)
        splits += not agree
        line = (f"{i:2d} {spec.name:48s} {p:6s} reference engines agree "
                f"{agree!s:5s}  port batched = reference batched "
                f"{same(port_b, ref_b) and occ!s:5s}  = reference vector "
                f"{same(port_b, ref_v)!s:5s}")
        totals["reference batched"] += ref_b[:len(COUNTS)]
        totals["reference vector"] += ref_v[:len(COUNTS)]
        totals["port batched"] += port_b[:len(COUNTS)]
        if vec is not None:
            port_v = row(vec[spec.name][p])
            totals["port vector"] += port_v[:len(COUNTS)]
            line += (f"  port vector = reference vector "
                     f"{same(port_v, ref_v)!s:5s}")
        print(line, flush=True)
    print(f"{which} at {n} hosts: the reference's engines split on {splits} "
          f"of {len(keys)} cells")
    for k, v in totals.items():
        if k != "port vector" or vec is not None:
            print(k, dict(zip(COUNTS, v.tolist())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
