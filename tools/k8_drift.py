#!/usr/bin/env python3
"""How far path P's teacher-forced logits move with K8's arithmetic.

Builds Mamba2-2.7B at full width and depth in bf16 on one GPU (random
weights from seed 0, 8 prompts of 512 tokens from seed 1, 32 greedy tokens
over a 1024-position cache, as ``chip_smoke.py``'s path P), decodes once
through the kernels, then feeds the same tokens back (teacher forcing)
with the SSD intra-chunk step replaced by one of:

* ``plain32``: K8's plain version (``ref.ssd_chunk_ref``), the reference
  of ``chip_smoke.py``'s 2e-2 gate;
* ``plain64``: the same math in float64, rounded to float32 at the end;
* ``cuda_core``: K8's CUDA-core kernels (``ssd.cu``), whatever the dtype;
* ``y_wgmma2`` and ``y_wgmma3``: the plain version with y_intra's weights
  split into two or three bf16 parts and each part's product summed in
  float32 (the arithmetic of a tensor-core y);
* ``kernel``: the kernels as the plan chooses them (``tensor_core``).

It prints each one's teacher-forced logits against ``plain32`` (relative
L2 over the 32 steps, and at step 0, which only the prefill reaches), and,
for the first layer's call on the model's own inputs, each one's y_intra
and contrib against ``plain32`` (relative L2; ``bitwise`` where equal).

    python3 tools/k8_drift.py
"""

from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_drift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def plain64(x, log_decay, dt, b_mat, c_mat, chunk):
        f64 = torch.float64
        args = (x.to(f64), log_decay.float(), dt.to(f64), b_mat.to(f64),
                c_mat.to(f64), chunk)
        bsz, l, h, p = x.shape
        n, nc = b_mat.shape[-1], l // chunk
        cum = ref.chunk_cumsum(args[1].reshape(bsz, nc, chunk, h)).to(f64)
        xc = args[0].reshape(bsz, nc, chunk, h, p)
        dtc = args[2].reshape(bsz, nc, chunk, h)
        bc = args[3].reshape(bsz, nc, chunk, h, n)
        cc = args[4].reshape(bsz, nc, chunk, h, n)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                    device=x.device))
        dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        w = (torch.einsum("bcthn,bcshn->bctsh", cc, bc)
             * torch.exp(torch.where(tri[None, None, :, :, None], dec,
                                     float("-inf")))
             * dtc[:, :, None, :, :])
        y = torch.einsum("bctsh,bcshp->bcthp", w, xc)
        total = cum[:, :, -1, :]
        contrib = torch.einsum(
            "bcshn,bcshp->bchpn",
            bc * (torch.exp(total[:, :, None, :] - cum) * dtc)[..., None],
            xc)
        return (y.reshape(bsz, l, h, p).float(), contrib.float(),
                total.float())

    def y_split(parts: int):
        def fn(x, log_decay, dt, b_mat, c_mat, chunk):
            _, contrib, total = ref.ssd_chunk_ref(x, log_decay, dt, b_mat,
                                                  c_mat, chunk)
            bsz, l, h, p = x.shape
            n, nc = b_mat.shape[-1], l // chunk
            cum = ref.chunk_cumsum(log_decay.float().reshape(bsz, nc, chunk,
                                                             h))
            xc = x.float().reshape(bsz, nc, chunk, h, p)
            bc = b_mat.float().reshape(bsz, nc, chunk, h, n)
            cc = c_mat.float().reshape(bsz, nc, chunk, h, n)
            tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                        device=x.device))
            dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
            w = (torch.einsum("bcthn,bcshn->bctsh", cc, bc)
                 * torch.exp(torch.where(tri[None, None, :, :, None], dec,
                                         float("-inf")))
                 * dt.float().reshape(bsz, nc, chunk, h)[:, :, None])
            y = sum(torch.einsum("bctsh,bcshp->bcthp", part, xc)
                    for part in ref.bf16_parts(w, parts))
            return y.reshape(bsz, l, h, p), contrib, total
        return fn

    def cuda_core(x, log_decay, dt, b_mat, c_mat, chunk):
        bsz, l, h, p = x.shape
        n, nc = b_mat.shape[-1], l // chunk
        out = (torch.empty((bsz, l, h, p), device=dev),
               torch.empty((bsz, nc, h, p, n), device=dev),
               torch.empty((bsz, nc, h), device=dev))
        plan = kernel.Plan("cuda_core", (0, 0, 0), (0, 0, 0), 1, 1, 0, 0)
        kernel.ssd_chunk(x, log_decay.float().contiguous(),
                         dt.float().contiguous(), b_mat, c_mat, *out, plan,
                         chunk=chunk)
        return out

    cfg = configs.get("mamba2_2p7b")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    steps, max_len = 32, 1024
    print(torch.cuda.get_device_name(0), flush=True)
    toks, _ = generate(cfg, params, prompts, steps, max_len)
    variants = {"plain32": ref.ssd_chunk_ref, "plain64": plain64,
                "cuda_core": cuda_core, "y_wgmma2": y_split(2),
                "y_wgmma3": y_split(3), "kernel": ops._intra_chunk}
    logits, first = {}, {}
    for name, fn in variants.items():
        def hook(*args, fn=fn, name=name):
            out = fn(*args)
            first.setdefault(name, out)
            return out
        with mock.patch.object(ops, "_intra_chunk", hook):
            logits[name] = generate(cfg, params, prompts, steps, max_len,
                                    forced=toks)[1]
        torch.cuda.empty_cache()
    want, base = logits["plain32"], first["plain32"]
    for name in variants:
        if name == "plain32":
            continue
        layer = []
        for part, got, ref_out in zip(("y", "contrib"), first[name], base):
            layer.append(f"{part} " + ("bitwise" if torch.equal(got, ref_out)
                                       else f"{rel(got, ref_out):.3e}"))
        print(f"{name:>10}: logits {rel(logits[name], want):.4e} relative "
              f"L2 (step 0 {rel(logits[name][:, 0], want[:, 0]):.4e}); "
              f"layer 0 {', '.join(layer)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
