#!/usr/bin/env python3
"""Loss trajectories of the training driver through the kernels and
through their plain versions, on one GPU.

For each path named (``TM``, ``TP``, ``TH``: ``chip_smoke.py``'s training
paths at their depths, 4 steps of 4 x 4096 tokens, 2 pods and the budget
cut at step 1), runs ``launch.train.main`` twice from the same seed: once
through the kernels, once with every model kernel swapped for its plain
version (``chip_smoke.plain_kernels``: attention, the experts and the SSD
scan, forward and backward).  Paths ``TI`` and ``TY`` (InternVL2-26B at 6
layers with its 256-patch prefix, Whisper-tiny whole over 1,500 frames)
run the same way through ``chip_smoke.frontend_training``, their gradient
norms printed beside the losses.  With ``--float32`` it runs TM, TP or TH
in float32 instead of bf16 (TM at 4 layers, where float32 fits); with
``--lr X`` the paths' cosine schedule peaks at X instead of the driver's
default 3e-3.  No checkpoint is written.  It prints, beside the card's
name and power limit, both loss series and their largest relative gap
over the steps: a gap far under the loss's own moves says the trajectory
is the model's, not the kernels'.

    python3 tools/train_losses.py [--float32] [--lr X] [TM TP TH TI TY]
                                                      (default: TM TH)
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("train_losses: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train

    float32 = "--float32" in argv
    lr = float(argv[argv.index("--lr") + 1]) if "--lr" in argv else 3e-3
    tags = [a for a in argv if a in cs.FAMILY_PATHS or a in ("TI", "TY")
            ] or ["TM", "TH"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    real_get = configs.get
    for tag in tags:
        if tag in ("TI", "TY"):
            frontend_losses(cs, tag, lr)
            continue
        arch, n_layers = cs.FAMILY_PATHS[tag]
        if float32 and tag == "TM":
            n_layers = 4

        def get(name, n=n_layers):
            cfg = real_get(name)
            cfg = cfg if n is None else dataclasses.replace(cfg, n_layers=n)
            return dataclasses.replace(cfg, param_dtype="float32") \
                if float32 else cfg

        losses = {}
        for route in ("kernels", "plain"):
            with mock.patch.object(configs, "get", get), \
                    mock.patch.object(Checkpointer, "save",
                                      lambda *a, **k: ""), \
                    (cs.plain_kernels() if route == "plain"
                     else contextlib.nullcontext()):
                report = train.main(["--arch", arch, "--seq-len", "4096",
                                     "--lr", str(lr)] + cs.FAMILY_EVENTS)
            losses[route] = report.losses
            del report
            torch.cuda.empty_cache()
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                                      losses["plain"]))
        print(f"{tag} ({arch}, {get(arch).n_layers} layers, "
              f"{'float32' if float32 else 'bf16'}): kernels "
              f"{losses['kernels']}, plain versions {losses['plain']}, "
              f"largest relative gap {gap:.3e}", flush=True)
    return 0


def frontend_losses(cs, tag: str, lr: float) -> None:
    """Path TI's or TY's losses and gradient norms through the kernels and
    through the plain versions, printed with their largest gap."""
    arch, cfg, shape = cs.frontend_path(tag)
    series = {}
    for route in ("kernels", "plain"):
        with (cs.plain_kernels() if route == "plain"
              else contextlib.nullcontext()):
            run = cs.frontend_training(cfg, shape, cs.FRONTEND_STEPS,
                                       torch.device("cuda"), peak_lr=lr)
        series[route] = (run[3], run[5])
        del run
        torch.cuda.empty_cache()
    (loss, gnorm), (ploss, pgnorm) = series["kernels"], series["plain"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(loss, ploss))
    print(f"{tag} ({arch}, {cfg.n_layers} layers, bf16, peak lr {lr}): "
          f"kernels losses {loss} grad norms {gnorm}, plain versions "
          f"losses {ploss} grad norms {pgnorm}, largest relative loss gap "
          f"{gap:.3e}", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
