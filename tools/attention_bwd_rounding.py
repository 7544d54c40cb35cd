#!/usr/bin/env python3
"""Why path TY's bf16 gradients leave the plain versions' after training,
on one GPU.

Trains Whisper-tiny as ``chip_smoke.py``'s path TY does (bf16, 4 steps of
32 x 448 tokens over 1,500 frames under the training driver's power plane)
and 3 steps more on the last batch, as the path's timed and traced steps
do.  Then, on that state:

1. every gradient leaf through the kernels and through the plain versions
   (``chip_smoke.plain_kernels``), bf16 and at the initial parameters, the
   worst leaves with their norms;
2. one decoder layer's cross attention (8 x 448 queries, random inputs,
   the trained weights, 1,500 keys from the encoder) in three pairs: K5
   against its plain version given K4's output O and log-sum-exp (A),
   the plain version given K4's O against itself given its own (B), and
   K5 against its plain version given the plain O (C).  A and C hold the
   kernel; B is what the bf16 rounding of O alone moves, through
   ``D = rowsum(dO O)``.

It prints the card's name and power limit beside the numbers.

    python3 tools/attention_bwd_rounding.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_bwd_rounding: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn
    from repro_torch.tree import leaves_with_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("whisper_tiny")
    shape = ShapeConfig("TY", "train", cs.TEXT_CTX, cs.TY_BATCH)
    out = cs.frontend_training(cfg, shape, cs.FRONTEND_STEPS, dev)
    state, batch, step_fn = out[0], out[7], out[8]
    for _ in range(3):
        step_fn(state, batch)
    init = init_train_state(cfg, AdamW(learning_rate=1e-3),
                            torch.Generator(device=dev).manual_seed(0),
                            dev).params

    grads_fn = make_grads_fn(cfg)
    for tag, params in (("trained", state.params), ("initial", init)):
        got, _ = grads_fn(params, batch)
        with cs.plain_kernels():
            want, _ = grads_fn(params, batch)
        rows = sorted(((cs.rel_l2_sliced(a, b), "/".join(path),
                        float(b.float().norm()))
                       for (path, a), (_, b) in zip(leaves_with_path(got),
                                                    leaves_with_path(want))),
                      reverse=True)
        print(f"{tag} parameters, bf16 gradients against the plain versions "
              f"(relative L2, norm): " + "; ".join(
                  f"{p} {e:.3e} ({n:.3e})" for e, p, n in rows[:4]),
              flush=True)

    p = state.params
    blk = {k: v[0].detach() for k, v in p["dec_blocks"].items()}
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    with torch.no_grad():
        enc = tfm.encode(p, batch["frames"][:8], cfg)
        b, se, _ = enc.shape
        k = (enc @ blk["cross_wk"]).reshape(b, se, hkv, hd)
        v = (enc @ blk["cross_wv"]).reshape(b, se, hkv, hd)
        h = cs.randn((b, cs.TEXT_CTX, cfg.d_model), torch.bfloat16, dev, 5)
        x = layers.rms_norm(h, blk["ln_cross"], cfg.norm_eps)
        q = (x @ blk["cross_wq"]).reshape(b, cs.TEXT_CTX, cfg.n_heads, hd)
        do = cs.randn(q.shape, torch.bfloat16, dev, 6)
        o, lse = ops.flash_attention(q, k, v, causal=False)
        po, plse = ref.flash_attention_ref(q, k, v, causal=False,
                                           block_k=ops.BLOCK_K)

    def bwd(kernel: bool, o_, lse_):
        if kernel:
            return ops.flash_attention_bwd(q, k, v, o_, lse_, do,
                                           causal=False)
        return ref.flash_attention_bwd_ref(q, k, v, o_, lse_, do,
                                           causal=False, block_q=ops.BLOCK_Q,
                                           block_k=ops.BLOCK_K)

    pairs = {"A: K5 vs plain, K4's O": (bwd(True, o, lse), bwd(False, o, lse)),
             "B: plain with K4's O vs plain with its own":
                 (bwd(False, o, lse), bwd(False, po, plse)),
             "C: K5 vs plain, the plain O": (bwd(True, po, plse),
                                             bwd(False, po, plse))}
    for name, (a, w) in pairs.items():
        print(f"{name}: " + ", ".join(
            f"{n} {cs.rel_l2(x1, x2):.3e}" for n, x1, x2 in
            zip(("dq", "dk", "dv"), a, w)) + " relative L2", flush=True)
    print(f"O: K4 against the plain version {cs.rel_l2(o, po):.3e} relative "
          f"L2; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
