#!/usr/bin/env python3
"""How far path TE's float32 losses move with the order of a step's sums.

``chip_smoke.py``'s path TE trains MiniCPM-2B at full width in float32
(``AdamW(learning_rate=1e-3)``, 4 x 1024 tokens of ``SyntheticTokens``
seed 3) for 9 steps on two pods, one, then two again, and holds every
loss within 1e-5 of one unresized rank.  Two data-parallel ranks sum a
batch's gradient as two halves; one rank sums it whole.  This script runs
the same model, data and optimizer on one device, at each depth given,
three ways: the whole batch a step (TE's one-rank reference), the batch
in two microbatches every step (two halves summed, as two pods sum them),
and TE's own schedule (halves for steps 1-3 and 7-9, whole for 4-6).  It
prints each run's losses, their relative distance from the first run's a
step, and, at the first step, how many gradient entries change sign
between the whole and the halved sums: AdamW's first update is
``g / (|g| + eps)`` of the learning rate, so each such entry moves by
twice the learning rate whatever the size of the difference.  One JSON
line a depth; the card's name and power limit first.

    python3 tools/te_drift.py [--layers 2 4] [--steps 9] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: TE's schedule: microbatches a step (two pods sum halves; one rank sums
#: the batch whole).
TE_SCHEDULE = (2, 2, 2, 1, 1, 1, 2, 2, 2)


def run(cfg, dev, schedule, seq: int, batch: int) -> list:
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train_loop
    opt = AdamW(learning_rate=1e-3)
    state = train_loop.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)
    steps = {k: train_loop.make_train_step(
        dataclasses.replace(cfg, microbatches=k), opt) for k in set(schedule)}
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=3, device=dev)
    losses = []
    for k in schedule:
        b = data.next_batch()
        state, met = steps[k](state, {"tokens": b.tokens, "labels": b.labels,
                                      "weights": b.weights})
        losses.append(float(met["loss"]))
    return losses


def first_step_signs(cfg, dev, seq: int, batch: int) -> dict:
    """The first batch's gradient summed whole and in two halves, from the
    same initial state: entries whose sign differs, and the worst leaf's
    relative L2 between the two."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train_loop
    from repro_torch.tree import leaves_with_path
    state = train_loop.init_train_state(
        cfg, AdamW(learning_rate=1e-3),
        torch.Generator(device=dev).manual_seed(0), dev)
    b = SyntheticTokens(cfg.vocab_size, seq, batch, seed=3,
                        device=dev).next_batch()
    b = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    one, _ = train_loop.make_grads_fn(cfg)(state.params, b)
    two, _ = train_loop.make_grads_fn(
        dataclasses.replace(cfg, microbatches=2))(state.params, b)
    flips, total, worst = {}, 0, (0.0, None)
    for (path, g1), (_, g2) in zip(leaves_with_path(one),
                                   leaves_with_path(two)):
        name = "/".join(path)
        n = int((torch.sign(g1) != torch.sign(g2)).sum())
        flips[name] = n
        total += g1.numel()
        rel = float((g1.double() - g2.double()).norm() / g1.double().norm())
        worst = max(worst, (rel, name))
    return dict(sign_flips=flips, entries=total,
                flip_share=sum(flips.values()) / total,
                worst_leaf_rel_l2=worst)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--steps", type=int, default=len(TE_SCHEDULE))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="MiniCPM-2B's smoke config (a CPU check)")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("te_drift: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    base = (configs.get_smoke("minicpm_2b") if args.smoke
            else configs.get("minicpm_2b"))
    schedules = {"whole": (1,) * args.steps, "halves": (2,) * args.steps,
                 "te": TE_SCHEDULE[:args.steps]}
    for n_layers in args.layers:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, n_layers=n_layers,
                                  param_dtype="float32", microbatches=1)
        losses = {name: run(cfg, dev, s, args.seq, args.batch)
                  for name, s in schedules.items()}
        ref = losses["whole"]
        drift = {name: [abs(a - b) / abs(b) for a, b in zip(ls, ref)]
                 for name, ls in losses.items() if name != "whole"}
        print(json.dumps(dict(
            layers=n_layers, losses=losses, rel_from_whole=drift,
            first_step=first_step_signs(cfg, dev, args.seq, args.batch),
            wall_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
