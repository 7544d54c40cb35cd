#!/usr/bin/env python3
"""The reference's training step against the port's at a family's full
width, on the CPU, loss for loss.

For each architecture named (default: ``olmoe_1b_7b`` and ``zamba2_7b``),
takes the published configuration at its full width with its depth cut
(``DEPTH``: OLMoE one layer; Zamba2 two Mamba layers with ``attn_every``
2, one shared-attention site), float32 parameters and one microbatch, and
runs four steps of the training driver's optimizer (AdamW, cosine schedule
with peak 3e-3, 10 warmup steps and 4 steps in all, as ``launch/train.py``
builds it) over B x L tokens drawn from a NumPy seed (``TOKENS``: OLMoE's
4 x 2048 give an expert capacity of 1280, as on ``chip_smoke.py``'s path
TM; Zamba2's 2 x 2048 are one TH microbatch's 4096 tokens).

Two processes, one after the other, so that only one package's state is
in memory at a time: the first runs the reference's jitted
``make_train_step`` from its ``init_train_state`` and writes the initial
parameters and the per-step loss and gradient norm into ``--work``; the
second carries those parameters across (``convert.from_reference_params``,
zero moments) and runs the port's ``make_train_step`` on the same batches.
Prints both series and the largest relative gap of each.

    PYTHONPATH=src python3 tools/full_width_parity.py [--work DIR] [ARCH ...]

A family takes about 10-16 GB and some minutes on 8 cores.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEPTH = {"olmoe_1b_7b": dict(n_layers=1),
         "zamba2_7b": dict(n_layers=2, attn_every=2)}
TOKENS = {"olmoe_1b_7b": (4, 2048), "zamba2_7b": (2, 2048)}
STEPS = 4
PEAK_LR, WARMUP = 3e-3, 10


def _cfg(configs, arch):
    return dataclasses.replace(configs.get(arch), **DEPTH[arch],
                               param_dtype="float32", microbatches=1)


def _batches(vocab: int, arch: str) -> list:
    rng = np.random.default_rng(0)
    b, s = TOKENS[arch]
    return [(rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s)))
            for _ in range(STEPS)]


def run_reference(arch: str, work: Path) -> None:
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule
    from repro.runtime.train_loop import init_train_state, make_train_step

    cfg = _cfg(configs, arch)
    opt = AdamW(learning_rate=cosine_schedule(PEAK_LR, WARMUP, STEPS),
                state_dtype=cfg.optimizer_state_dtype)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    with open(work / f"{arch}.params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, state.params), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    step = jax.jit(make_train_step(cfg, opt))
    out = []
    for tokens, labels in _batches(cfg.vocab_size, arch):
        batch = {"tokens": jnp.asarray(tokens, jnp.int32),
                 "labels": jnp.asarray(labels, jnp.int32),
                 "weights": jnp.ones(tokens.shape, jnp.float32)}
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        print(f"reference {arch}: loss {out[-1][0]} gnorm {out[-1][1]}",
              flush=True)
    (work / f"{arch}.reference.json").write_text(json.dumps(out))


def run_port(arch: str, work: Path) -> None:
    import torch
    from repro_torch import configs
    from repro_torch.convert import from_reference_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.train_loop import TrainState, make_train_step
    from repro_torch.tree import leaves

    cfg = _cfg(configs, arch)
    opt = AdamW(learning_rate=cosine_schedule(PEAK_LR, WARMUP, STEPS),
                state_dtype=cfg.optimizer_state_dtype)
    with open(work / f"{arch}.params.pkl", "rb") as f:
        params = from_reference_params(pickle.load(f), cfg, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    step = make_train_step(cfg, opt)
    out = []
    for tokens, labels in _batches(cfg.vocab_size, arch):
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels),
                 "weights": torch.ones(tokens.shape)}
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        print(f"port {arch}: loss {out[-1][0]} gnorm {out[-1][1]}",
              flush=True)
    (work / f"{arch}.port.json").write_text(json.dumps(out))


def main(argv: list[str]) -> int:
    if argv[:1] in (["--reference"], ["--port"]):
        sys.path.insert(0, str(ROOT / "src"))
        run = run_reference if argv[0] == "--reference" else run_port
        run(argv[1], Path(argv[2]))
        return 0
    work = None
    if argv[:1] == ["--work"]:
        work, argv = Path(argv[1]), argv[2:]
    work = work or Path(tempfile.mkdtemp(prefix="full_width_parity_"))
    work.mkdir(parents=True, exist_ok=True)
    for arch in argv or list(DEPTH):
        for side in ("--reference", "--port"):
            subprocess.run([sys.executable, __file__, side, arch, str(work)],
                           check=True)
        (work / f"{arch}.params.pkl").unlink()
        ref, port = (json.loads((work / f"{arch}.{s}.json").read_text())
                     for s in ("reference", "port"))
        gaps = [max(abs(p[i] - r[i]) / abs(r[i]) for r, p in zip(ref, port))
                for i in (0, 1)]
        print(f"{arch} at full width, {DEPTH[arch]}, "
              f"{'x'.join(map(str, TOKENS[arch]))} tokens, float32: "
              f"reference (loss, gnorm) {ref}; port {port}; largest "
              f"relative gap: loss {gaps[0]:.3e}, gnorm {gaps[1]:.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
