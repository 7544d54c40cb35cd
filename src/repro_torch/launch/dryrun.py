"""Multi-pod dry run: every (arch x shape x mesh) cell's step under its
production layout, on stand-ins (the reference's
``repro.launch.dryrun``).

The reference lowers and compiles each cell over the real 16 x 16 and
2 x 16 x 16 meshes and reads its roofline terms from the jaxpr and the
partitioned HLO.  The port runs each cell's step twice on ``meta`` stand-ins
(:mod:`repro_torch.launch.costing`), so no device computes and nothing
launches:

  1. **the global count**: the step at the shape's global batch with no
     mesh, under the counter; its FLOPs and bytes over the chips are the
     per-device roofline terms, as the reference divides its jaxpr's;
  2. **the layout**: one process joins a fake process group of 256 or 512
     ranks, builds the production mesh, cuts one rank's blocks under the
     cell's rules (:func:`repro_torch.launch.shardspecs.rules_for`) and
     runs the same step on them inside the sharding context.  This must
     finish without a shape or layout error, the twin of
     ``lower().compile()`` succeeding; it runs for rank 0 and for the
     mesh's last rank, and rank 0's run gives the collective bytes and
     the memory terms.

The memory terms: ``argument_bytes`` are rank 0's blocks of the step's
inputs (exact); ``output_bytes`` the step's outputs; ``alias_bytes`` the
outputs that share an input's storage (the train step updates its state in
place); ``temp_bytes`` the peak of the live tensor bytes the counter saw
less the arguments (an estimate, labelled as one).  ``lower_s`` and
``compile_s`` are the two runs' seconds.  The reference's
``xla_cost_analysis`` has no twin: there is no compiler's count to report.

The roofline constants are an H100 SXM5's; results go to
``results/dryrun_torch/<cell>.json``.

Run (the CPU only; no card is needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import inputs as inp
from repro_torch.launch import shardspecs as ss
from repro_torch.launch.costing import (CostCounter, nbytes, stand_ins,
                                        tensors_of)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, \
    shapes_for
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import (local_shape, local_shard,
                                          sharding_context)
from repro_torch.runtime.serve_loop import make_decode_step, \
    make_prefill_step
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.tree import leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# H100 SXM5 roofline constants (NVIDIA H100 Tensor Core GPU datasheet).
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s per GPU
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
# One 400 Gb/s NDR InfiniBand port per GPU, as on a DGX H100: every
# production mesh axis of 16 ranks spans two 8-GPU nodes, so the NIC, not
# NVLink's 450 GB/s a direction, bounds a collective over it.
NET_BW = 50e9                # bytes/s per GPU

_NOTE = ("the port counts each collective in the dtype it runs in (it "
         "sums some partials in float32 on purpose); the reference's "
         "f32_as_bf16 undoes an XLA CPU artefact the port does not have, "
         "so both keys hold the same count")


# ----------------------------------------------------------------- the step
def _at_cursor(tree, cursor: int):
    """A decode state with every cache's host cursor at ``cursor``."""
    if isinstance(tree, dict):
        return {k: (cursor if k == "cursor" else _at_cursor(v, cursor))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_at_cursor(v, cursor) for v in tree)
    return tree


def _cut(tree, specs, mesh):
    """``tree``'s tensors cut to this rank's blocks under ``specs`` (a tree
    of the same structure)."""
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cut(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return local_shard(tree, specs, mesh)
    return tree


def _block_bytes(specs: dict, shardings: dict, mesh) -> int:
    """The bytes of this rank's blocks of the ``specs`` (stand-ins) under
    ``shardings``."""
    total = 0
    for k, t in specs.items():
        shape = local_shape(tuple(t.shape), shardings[k], mesh)
        total += int(torch.Size(shape).numel()) * t.element_size()
    return total


def _tensor_bytes(tree) -> int:
    return sum(nbytes(t) for t in tensors_of(tree))


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, rules=None):
    """``(step, args, argument_bytes)``: the cell's step function (in the
    order of the reference's ``_lower_cell``: AdamW's train step, the
    prefill at ``max_len = seq_len`` or a decode step) and its arguments
    as ``meta`` stand-ins.  With a ``mesh`` and
    ``rules`` the arguments are this rank's blocks and
    ``argument_bytes`` their bytes as the layout shards them (a batch the
    step splits itself counted as the rank's rows); without, the global
    arguments and their bytes."""
    if shape.kind == "train":
        opt = AdamW(state_dtype=cfg.optimizer_state_dtype)
        grad_sh = None if mesh is None else ss.param_shardings(cfg, mesh,
                                                               rules)
        step = make_train_step(cfg, opt, grad_shardings=grad_sh)
        state = stand_ins(ss.abstract_train_state(cfg))
        state = dataclasses.replace(state, step=0)
        for p in leaves(state.params):       # as init_train_state makes them
            p.requires_grad_(True)
        batch_abs = inp.train_batch_specs(cfg, shape)
        batch = stand_ins(batch_abs)
        if mesh is None:
            return step, (state, batch), _tensor_bytes((state, batch))
        state = ss.local_train_state(state, cfg, mesh, rules)
        arg_b = _tensor_bytes(state) + _block_bytes(
            batch_abs, ss.batch_shardings(cfg, mesh, rules, batch_abs), mesh)
        return step, (state, batch), arg_b
    params_abs = ss.abstract_params(cfg)
    params = stand_ins(params_abs)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        tokens_abs, extras_abs = inp.prefill_specs(cfg, shape)
        tokens, extras = stand_ins((tokens_abs, extras_abs))
        if mesh is None:
            return step, (params, tokens, extras), _tensor_bytes(
                (params, tokens, extras))
        params = ss.local_params(params, cfg, mesh, rules)
        every = dict(extras_abs, tokens=tokens_abs)
        arg_b = _tensor_bytes(params) + _block_bytes(
            every, ss.batch_shardings(cfg, mesh, rules, every), mesh)
        return step, (params, tokens, extras), arg_b
    step = make_decode_step(cfg)
    state_abs = inp.decode_state_specs(cfg, shape)
    state = _at_cursor(stand_ins(state_abs), shape.seq_len - 1)
    tokens = stand_ins(inp.decode_token_specs(shape))
    if mesh is None:
        return step, (params, state, tokens), _tensor_bytes(
            (params, state, tokens))
    params = ss.local_params(params, cfg, mesh, rules)
    state = _cut(state, ss.decode_state_shardings(cfg, mesh, rules,
                                                  state_abs), mesh)
    tokens = _cut(tokens, ss.batch_shardings(
        cfg, mesh, rules, {"last_tokens": tokens})["last_tokens"], mesh)
    return step, (params, state, tokens), _tensor_bytes(
        (params, state, tokens))


def run_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
             rules=None) -> dict:
    """One run of the cell's step on stand-ins under a
    :class:`~repro_torch.launch.costing.CostCounter` (inside
    ``sharding_context(mesh, rules)`` when given): its count, the
    argument bytes, the output and alias bytes and the seconds."""
    t0 = time.time()
    step, args, arg_b = cell_step(cfg, shape, mesh, rules)
    with CostCounter() as counter:
        held = counter.hold(args)
        if mesh is None:
            out = step(*args)
        else:
            with sharding_context(mesh, rules):
                out = step(*args)
    inputs = {t.untyped_storage()._cdata for t in tensors_of(args)}
    outs = tensors_of(out)
    return {"cost": counter.cost, "argument_bytes": arg_b,
            "held_bytes": held,
            "output_bytes": sum(nbytes(t) for t in outs),
            "alias_bytes": sum(nbytes(t) for t in outs
                               if t.untyped_storage()._cdata in inputs),
            "seconds": time.time() - t0}


# ------------------------------------------------------------ the fake group
def _fake_group(rank: int, world: int) -> None:
    """This process as ``rank`` of a fake process group of ``world``: the
    collectives return at once, their outputs uninitialised (stand-ins
    have no values anyway)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _forget_meshes() -> None:
    """Drop the splits and gather plans cached by mesh: a mesh of the next
    fake group compares equal to this one's, whose groups are gone."""
    sharding._axis_split.cache_clear()
    tfm._block_plan.cache_clear()


def layout_run(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
               rank: int) -> dict:
    """:func:`run_step` on ``rank``'s blocks of the production mesh, this
    process a rank of a fake group of 256 or 512; the group is torn down
    after."""
    world = 512 if multi_pod else 256
    _fake_group(rank, world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = ss.rules_for(cfg, shape, mesh_size=world)
        return run_step(cfg, shape, mesh, rules)
    finally:
        dist.destroy_process_group()
        _forget_meshes()


# ------------------------------------------------------------------ roofline
def score_tile_bytes(cfg, shape, n_chips: int) -> float:
    """HBM traffic of attention-score / SSD-decay intermediates that the
    kernels (K4, K5, K8, K8b) keep on chip and the plain versions write:
    the reference's estimate, unchanged.

    The plain path materializes the whole f32 score chain
    (scores -> mask -> exp, ~3 tensors per pass) between the two attention
    dots; per (arch x shape) the analytic estimate is
    passes x chain x B x H x Sq x Skv x 4 bytes (causal halves it), with
    passes ~= 4 for training (fwd + remat recompute + ~2 bwd) and 1 for
    prefill, chain ~= 3 (matching the jaxpr byte model, which charges each
    elementwise output).  Subtracting it yields the kernel-path memory
    roofline."""
    b, s = shape.global_batch, shape.seq_len
    passes = (4.0 if shape.kind == "train" else 1.0) * 3.0
    total = 0.0
    if cfg.attn_layers and cfg.n_heads and shape.kind != "decode":
        total += (passes * b * cfg.n_heads * s * s * 4 * 0.5
                  * cfg.attn_layers)
    if cfg.ssm_layers and shape.kind != "decode":
        q = cfg.ssm_chunk
        total += (passes * b * cfg.n_ssm_heads * s * q * 4
                  * cfg.ssm_layers)
    return total / n_chips


def _kernel_adjusted(cfg, shape, n_chips, bytes_dev, t_compute,
                     t_collective) -> dict:
    adj_bytes = max(bytes_dev - score_tile_bytes(cfg, shape, n_chips),
                    bytes_dev * 0.1)
    t_mem = adj_bytes / HBM_BW
    dom = max((("compute", t_compute), ("memory", t_mem),
               ("collective", t_collective)), key=lambda kv: kv[1])
    return {"t_memory_s": t_mem, "dominant": dom[0], "bound_s": dom[1]}


def kernel_path_bound(cfg, shape, n_chips: int, flops: float,
                      bytes_: float, collective_bytes: float = 0.0) -> dict:
    """The kernel-path roofline of a count (``flops`` and ``bytes_`` over
    ``n_chips``): :func:`_kernel_adjusted` with the H100 constants."""
    t_compute = flops / n_chips / PEAK_FLOPS
    return _kernel_adjusted(cfg, shape, n_chips, bytes_ / n_chips,
                            t_compute, collective_bytes / NET_BW)


# ------------------------------------------------------------ depth shortcut
def depths(cfg: ModelConfig) -> Optional[tuple]:
    """The two depths the count is taken at, or None for the full depth.

    A step's count is linear in its number of layers: each layer
    dispatches the same ops, and the parameters, moments and caches are
    stacked along the depth.  A hybrid adds its shared block every
    ``attn_every`` layers, so its depths keep the remainder of ``n_layers``
    (at least one shared block: its parameters must reach the loss) and
    step by ``attn_every``; an encoder-decoder scales both stacks together
    (only where they are equally deep).  The smallest depth is 2: one
    layer's working set peaks in another phase than a deeper stack's."""
    n = cfg.n_layers
    if cfg.family == "encdec" and cfg.enc_layers != n:
        return None
    step = cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every \
        else 1
    d1 = n % step + step if step > 1 else 2
    return (d1, d1 + step) if 2 * d1 + step < n else None


def at_depth(cfg: ModelConfig, d: int) -> ModelConfig:
    """``cfg`` cut to ``d`` layers (both stacks of an encoder-decoder)."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=d, enc_layers=d)
    return dataclasses.replace(cfg, n_layers=d)


def _numbers(run: dict) -> dict:
    """A run's counts as a flat dict of numbers."""
    c = run["cost"]
    out = {"flops": c.flops, "bytes": c.bytes,
           "product_flops": c.product_flops,
           "argument_bytes": run["argument_bytes"],
           "output_bytes": run["output_bytes"],
           "alias_bytes": run["alias_bytes"],
           "temp_bytes": max(c.peak_bytes - run["held_bytes"], 0)}
    out.update({"coll:" + k: v for k, v in c.collectives.items()})
    return out


def _extrapolate(a: dict, b: dict, d1: int, d2: int, n: int) -> dict:
    """Each count of depth ``n`` from its counts at ``d1`` and ``d2`` (the
    line through them; ``n - d1`` a multiple of ``d2 - d1``)."""
    k, rem = divmod(n - d1, d2 - d1)
    if rem:
        raise ValueError(f"depth {n} is not {d1} + k * {d2 - d1}")
    return {key: a.get(key, 0) + (b.get(key, 0) - a.get(key, 0)) * k
            for key in sorted(set(a) | set(b))}


@functools.lru_cache(maxsize=8)
def _global_numbers(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    # Both meshes of a cell whose config they leave alike share it.
    return _numbers(run_step(cfg, shape))


def cell_counts(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
                shortcut: bool = True, ranks: Optional[tuple] = None
                ) -> dict:
    """The cell's counts: ``{"global": ..., rank: ... for each of
    ``ranks`` (the mesh's first and last when None), "depths", "lower_s",
    "compile_s"}``, each a flat dict of numbers (:func:`_numbers`;
    collectives under ``"coll:<kind>"``).  With ``shortcut`` they are
    taken at :func:`depths` and extrapolated to the full depth; the layout
    runs at those depths too."""
    n_chips = 512 if multi_pod else 256
    ranks = (0, n_chips - 1) if ranks is None else ranks
    cut = depths(cfg) if shortcut else None
    runs = [cfg] if cut is None else [at_depth(cfg, d) for d in cut]
    t0 = time.time()
    glob = [_global_numbers(c, shape) for c in runs]
    t_lower = time.time() - t0
    per_rank = {r: [_numbers(layout_run(c, shape, multi_pod, r))
                    for c in runs] for r in ranks}
    t_compile = time.time() - t0 - t_lower

    def whole(counts):
        if cut is None:
            return counts[0]
        return _extrapolate(*counts, *cut, cfg.n_layers)
    out = {"global": whole(glob), "depths": cut, "lower_s": t_lower,
           "compile_s": t_compile}
    out.update({r: whole(v) for r, v in per_rank.items()})
    return out


def _collectives(counts: dict) -> dict:
    coll = {k[5:]: int(v) for k, v in counts.items() if k.startswith("coll:")}
    coll["total"] = sum(coll.values())
    return coll


# -------------------------------------------------------------------- a cell
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             overrides: dict | None = None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{configs.canonical(arch)}__{shape_name}__{mesh_name}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = configs.get(arch)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            typed[k] = type(cur)(v) if cur is not None else v
        cfg = dataclasses.replace(cfg, **typed)
    shape = SHAPES[shape_name]
    result = {"cell": cell, "arch": configs.canonical(arch),
              "shape": shape_name, "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        n_chips = 512 if multi_pod else 256
        cfg = ss.effective_config(cfg, shape, n_chips)
        counts = cell_counts(cfg, shape, multi_pod)
        jcost, local = counts["global"], counts[0]
        last = counts[n_chips - 1]
        coll = _collectives(local)
        flops_dev = jcost["flops"] / n_chips
        bytes_dev = jcost["bytes"] / n_chips
        t_compute = flops_dev / PEAK_FLOPS
        t_memory = bytes_dev / HBM_BW
        t_collective = coll.get("total", 0) / NET_BW
        dominant = max((("compute", t_compute), ("memory", t_memory),
                        ("collective", t_collective)), key=lambda kv: kv[1])
        model_flops = cfg.flops_per_token(shape.seq_len) * (
            shape.global_batch * shape.seq_len if shape.kind == "train"
            else 0)
        result.update({
            "ok": True,
            "n_chips": n_chips,
            "lower_s": round(counts["lower_s"], 1),
            "compile_s": round(counts["compile_s"], 1),
            "depths": counts["depths"],
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "product_flops_global": jcost["product_flops"],
            "collective_bytes_per_device": coll,
            "collective_bytes_raw_f32_legalized": dict(coll),
            "collective_note": _NOTE,
            "memory": {
                "argument_bytes": int(local["argument_bytes"]),
                "output_bytes": int(local["output_bytes"]),
                "temp_bytes": int(local["temp_bytes"]),
                "alias_bytes": int(local["alias_bytes"]),
                "note": "temp_bytes is an estimate: the peak of the live "
                        "tensor bytes the counter saw on rank 0's blocks, "
                        "less its arguments",
            },
            "last_rank": {"rank": n_chips - 1,
                          "argument_bytes": int(last["argument_bytes"]),
                          "collective_bytes": _collectives(last)},
            "roofline": {
                "t_compute_s": t_compute,
                "t_memory_s": t_memory,
                "t_collective_s": t_collective,
                "dominant": dominant[0],
                "bound_s": dominant[1],
            },
            "roofline_kernel_path": _kernel_adjusted(
                cfg, shape, n_chips, bytes_dev, t_compute, t_collective),
            "model_flops_global": model_flops,
            "useful_flops_ratio": (model_flops / jcost["flops"]
                                   if jcost["flops"] and model_flops
                                   else None),
        })
    except Exception as e:  # record failures, they are bugs to fix
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["wall_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def cells(mesh: str = "both"):
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for shape_name in shapes_for(cfg):
            if mesh in ("single", "both"):
                yield arch, shape_name, False
            if mesh in ("multi", "both"):
                yield arch, shape_name, True


def run_cells(todo, out_dir: str = RESULTS_DIR, force: bool = False,
              overrides: dict | None = None) -> list:
    """:func:`run_cell` on each ``(arch, shape, multi_pod)`` of ``todo``,
    a line printed for each; returns the results."""
    results = []
    for arch, shape_name, multi in todo:
        r = run_cell(arch, shape_name, multi, out_dir, force, overrides)
        status = "OK " if r["ok"] else "FAIL"
        extra = (f"flops/dev={r['flops_per_device']:.3e} "
                 f"dominant={r['roofline']['dominant']}"
                 if r["ok"] else r.get("error", ""))
        print(f"[{status}] {r['cell']:55s} {r['wall_s']:7.1f}s  {extra}",
              flush=True)
        results.append(r)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--overrides", default=None,
                    help="comma-separated cfg overrides, e.g. "
                         "microbatches=16,parallelism=tp (baseline runs)")
    args = ap.parse_args(argv)
    overrides = None
    if args.overrides:
        overrides = dict(kv.split("=", 1) for kv in args.overrides.split(","))

    todo = []
    if args.all:
        todo = list(cells(args.mesh))
    else:
        archs = [args.arch] if args.arch else configs.ARCHS
        for arch in archs:
            shapes = ([args.shape] if args.shape
                      else shapes_for(configs.get(arch)))
            for sh in shapes:
                if args.mesh in ("single", "both"):
                    todo.append((arch, sh, False))
                if args.mesh in ("multi", "both"):
                    todo.append((arch, sh, True))

    results = run_cells(todo, args.out_dir, args.force, overrides)
    failures = sum(not r["ok"] for r in results)
    print(f"\n{len(todo) - failures}/{len(todo)} cells compiled")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
