#!/usr/bin/env python3
"""How far tensor parallelism's bf16 rounding moves path TT's gradients,
on one GPU.

granite-8b at full width and 4 layers, the first step's gradients of one
batch of 4 x 4096 tokens (one microbatch), from the same bf16 parameters:

1. one rank in bf16, and one rank in float32 (the parameters cast);
2. two ranks sharing the card, tensor parallel on ``("pod", "data",
   "model") = (1, 1, 2)`` (``chip_smoke.py``'s TT layout), as the port
   runs it: each rank's row-split products (attention's ``wo``, the MLP's
   ``w_down``) rounded to bf16, then summed over the ranks, and the
   vocabulary-parallel xent's input gradient summed over the ranks in
   float32 (``models/layers.py``'s ``_VocabParallelXent``);
3. 2 with the xent's input gradient rounded to bf16 on each rank before
   the sum (Megatron's ``f`` around the rank's xent);
4. 2 with the row-split products' partial sums in float32 too (each
   rank's product in float32, summed, rounded once: the rounding one
   rank's single product makes).

Prints each leaf's relative L2 against the float32 gradient (and 2's
against 1's bf16), beside the card's name and power limit.

    python3 tools/tp_rounding.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
LAYERS, BATCH, SEQ = 4, 4, 4096


def _config(dtype: str):
    from repro_torch import configs
    return dataclasses.replace(configs.get("granite_8b"), n_layers=LAYERS,
                               param_dtype=dtype, parallelism="tp",
                               microbatches=1)


def _batch(cfg, dev):
    g = torch.Generator(device=dev).manual_seed(10)
    return {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                    device=dev, generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                    device=dev, generator=g),
            "weights": torch.ones((BATCH, SEQ), device=dev)}


def _float32_partials():
    """``layers``' row-split products with float32 partial sums."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.runtime.sharding import copy_to, split_over, sum_over

    def out_proj(out, params, tp):
        if tp is None:
            return out @ params["wo"]
        y = out.float() @ params["wo"].float()
        return sum_over(y, tp[0], tp[1]).to(out.dtype)

    def mlp(params, x, cfg):
        tp = split_over("ffn", params["w_up"].shape[1], cfg.d_ff)
        if tp is not None:
            x = copy_to(x, tp[0], tp[1])
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        if tp is None:
            return h @ params["w_down"]
        y = h.float() @ params["w_down"].float()
        return sum_over(y, tp[0], tp[1]).to(x.dtype)

    return mock.patch.multiple(layers, _out_proj=out_proj, mlp=mlp)


def _bf16_xent_parts():
    """The vocabulary-parallel xent's input gradient as each rank's part
    rounded to bf16 and then summed over the ranks (Megatron's ``f``,
    :func:`repro_torch.runtime.sharding.copy_to`, around the rank's
    xent), where the port sums the parts in float32."""
    from repro_torch.models import layers
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.sharding import copy_to, split_over

    class Xent(layers._VocabParallelXent):
        @staticmethod
        def backward(ctx, dloss):
            h, w_out, labels, weights, lse = ctx.saved_tensors
            v_l = w_out.shape[1]
            dh = torch.empty_like(h)
            dw = torch.zeros(w_out.shape, dtype=torch.float32,
                             device=w_out.device)
            for c0 in range(0, h.shape[1], ctx.chunk):
                sl = slice(c0, c0 + ctx.chunk)
                hh = h[:, sl]
                g = layers._chunk_logits(hh, w_out)
                g.sub_(lse[:, sl, None]).exp_()
                ll = labels[:, sl, None].long() - ctx.offset
                own = (ll >= 0) & (ll < v_l)
                g.scatter_add_(-1, ll.clamp(0, v_l - 1),
                               torch.where(own, -1.0, 0.0))
                g.mul_((weights[:, sl, None] * dloss))
                g = g.to(h.dtype)
                dh[:, sl] = g @ w_out.T
                dw += (hh.reshape(-1, hh.shape[-1]).T
                       @ g.reshape(-1, g.shape[-1])).float()
            return (dh, dw.to(w_out.dtype), None, None, None, None, None,
                    None)

    def streamed_xent(h, w_out, labels, weights, chunk=2048, vocab=None):
        chunk = min(chunk, h.shape[1])
        mesh, dims, index, _ = split_over("vocab", w_out.shape[1], vocab)
        return (Xent.apply(copy_to(h, mesh, dims), w_out, labels, weights,
                           chunk, mesh, dims, index * w_out.shape[1]),
                weights.float().sum())

    return mock.patch.object(train_loop, "streamed_xent", streamed_xent)


def rank() -> dict:
    from repro_torch.launch import mesh, shardspecs
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import SHAPES
    from repro_torch.runtime import sharding
    from repro_torch.runtime.sharding import gather_whole, sharding_context
    from repro_torch.runtime.train_loop import make_grads_fn
    from repro_torch.tree import leaves, leaves_with_path, map_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, r = sharding.rank_device(), sharding.rank()
    cfg = _config("bfloat16")
    batch = _batch(cfg, dev)

    def params():
        p = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        for t in leaves(p):
            t.requires_grad_(True)
        return p

    def cpu(tree):
        return map_tree(lambda g: g.detach().float().cpu(), tree)

    grads = {}
    if r == 0:
        grads["one rank bf16"] = cpu(make_grads_fn(cfg)(params(), batch)[0])
        p32 = map_tree(lambda t: t.detach().float().requires_grad_(True),
                       params())
        grads["one rank float32"] = cpu(make_grads_fn(_config("float32"))(
            p32, batch)[0])
        del p32
        torch.cuda.empty_cache()
    sharding.barrier()
    m = mesh.make_host_mesh((1, 1, 2), ("pod", "data", "model"))
    rules = shardspecs.rules_for(cfg, SHAPES["train_4k"], model_axis=2,
                                 mesh_size=2)
    specs = dict(leaves_with_path(shardspecs.param_shardings(cfg, m, rules)))
    for name, patch in (("two ranks (the port)", None),
                        ("two ranks, xent parts in bf16", _bf16_xent_parts),
                        ("two ranks, products summed in float32",
                         _float32_partials)):
        with sharding_context(m, rules):
            local = shardspecs.local_params(params(), cfg, m, rules)
            if patch is None:
                g = make_grads_fn(cfg)(local, batch)[0]
            else:
                with patch():
                    g = make_grads_fn(cfg)(local, batch)[0]
        whole = {p: gather_whole(t, specs[p], m).float().cpu()
                 for p, t in leaves_with_path(g)}
        if r == 0:
            grads[name] = whole
        del local, g, whole
        torch.cuda.empty_cache()
    if r:
        return {}

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    exact = dict(leaves_with_path(grads.pop("one rank float32")))
    one = dict(leaves_with_path(grads["one rank bf16"]))
    out = {}
    for name, tree in grads.items():
        flat = dict(leaves_with_path(tree)) if name == "one rank bf16" \
            else tree
        out[name] = {"/".join(p): rel(flat[p], exact[p]) for p in exact}
    out["two ranks (the port) against one rank bf16"] = {
        "/".join(p): rel(grads["two ranks (the port)"][p], one[p])
        for p in exact}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_rounding: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.launch import mesh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"build: {cs.build_all():.2f} s", flush=True)
    out = mesh.spawn(rank, 2, "cuda", timeout_s=900)[0]
    leaves = list(next(iter(out.values())))
    print(f"relative L2 a leaf against one rank's float32 gradient, "
          f"granite-8b at {LAYERS} layers, {BATCH} x {SEQ} tokens, on {smi}")
    print(f"{'leaf':22s}" + "".join(f"{k[:34]:>36s}" for k in out))
    for leaf in leaves:
        print(f"{leaf:22s}" + "".join(f"{out[k][leaf]:36.3e}" for k in out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
