#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 cpcbench/control.py --workload granite_8b.long_prompt \\
        --seeds 1 2 3 --control-seeds 1 2

For each seed, in one process: weights and prompts from the seed, the
cell's fleet at the cell's own load with the cap event at once, rounds
until the mix's longest prompt has been served, then the program's
numbers (what a run's check compares) and, for the control seeds, the
control's: the reference computed in float8 in the program's place.
Prints one JSON line a seed and, last, the largest program reading and
the smallest control reading of each number.  The benchmark's own runs
do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from cpcbench import check, gen, harness, spec
    from cpcbench.weights import make_weights

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.find_cell(args.workload, ROOT)
    port = harness.Port(cell.config)
    longest = max(cell.mix["prompt_lengths"])
    lows, highs = {}, {}
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        params = (harness.setup(port, cell, seed, dev, False) if k == 0
                  else make_weights(port.specs, seed, port.dtype, dev))
        rounds = next(r for r in range(64)
                      if max(gen.round_lengths(cell.mix, seed, r)) == longest)
        win = harness.run_window(port, cell, params, seed, 0.0, dev,
                                 min_rounds=rounds + 1)
        del params
        harness.release()
        row = {"seed": seed, "window_s": win.wall_s,
               "program": check.model_numbers(port, cell, win, seed, dev),
               "fleet": dict(check.fleet_numbers(cell, win),
                             failed_requests=sum(b.bad
                                                 for b in win.batches))}
        for name, v in row["program"].items():
            lows[name] = max(lows.get(name, 0.0), v)
        if seed in args.control_seeds:
            row["control"] = check.model_numbers(port, cell, win, seed, dev,
                                                 control=True)
            for name, v in row["control"].items():
                highs[name] = min(highs.get(name, float("inf")), v)
        row["correct"], _ = check.judge({**row["program"], **row["fleet"]},
                                        check.limits(cell))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        harness.release()
    print(json.dumps({"workload": args.workload, "program_max": lows,
                      "control_min": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
