"""The shardings of every step's inputs (the reference's
``repro.launch.shardspecs``).

All of them derive from the logical-axis rule table
(:class:`repro_torch.runtime.sharding.Rules`); per-(arch x shape)
specializations, such as the KV cache's sequence axis sharded over
``data`` for ``long_500k``, are picked in :func:`rules_for`.  A sharding
is a spec tuple (the reference's ``PartitionSpec``, see
:mod:`repro_torch.runtime.sharding`); the functions read only the mesh's
axis names and sizes, so a :class:`~repro_torch.runtime.sharding.MeshAxes`
of the production 16 x 16 or 2 x 16 x 16 mesh serves as well as a
``DeviceMesh``.  The abstract states are trees of ``meta``-device tensors,
the twin of ``jax.ShapeDtypeStruct``.

:func:`local_params` and :func:`local_train_state` cut a whole tree into
one rank's blocks under these specs: what each rank of a tensor-parallel
or FSDP layout holds (the reference leaves that to GSPMD), under every
layout that :func:`rules_for` gives; :func:`relayout_decode_state`
carries a decode state from one layout's blocks into another's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import OptState
from repro_torch.models import ssd
from repro_torch.runtime.sharding import (Rules, axis_size, gather_whole,
                                          live_dims, local_shard, spec_for)
from repro_torch.runtime.train_loop import TrainState
from repro_torch.tree import leaves_with_path, map_tree

#: The replicated spec (the reference's ``PartitionSpec()``).
REPLICATED: tuple = ()


def dp_applicable(cfg: ModelConfig, shape: ShapeConfig,
                  mesh_size: int) -> bool:
    # MoE archs keep expert parallelism: without an expert axis the
    # reference's dispatch falls back to GSPMD's scatter, whose bucket
    # replication costs ~100x the expert-parallel collectives.
    return (cfg.parallelism == "dp" and shape.kind == "train"
            and shape.global_batch % mesh_size == 0
            and cfg.n_experts == 0)


def effective_config(cfg: ModelConfig, shape: ShapeConfig,
                     mesh_size: int) -> ModelConfig:
    """Config adjustments implied by the chosen parallelism: pure DP puts
    one example per rank, so gradient accumulation is unnecessary (and
    would make the per-rank microbatch fractional)."""
    if dp_applicable(cfg, shape, mesh_size) and cfg.microbatches > 1:
        return dataclasses.replace(cfg, microbatches=1)
    return cfg


def rules_for(cfg: ModelConfig, shape: ShapeConfig,
              overrides: Optional[dict] = None,
              model_axis: int = 16, mesh_size: int = 256) -> Rules:
    """Per-(arch x shape) rule specialization.

    Head counts that do not divide the model axis cannot be tensor
    parallel without resharding storms, so:
      * odd q-head archs (minicpm 36H, whisper 6H) drop TP entirely and
        divide compute over the *sequence* axis instead (Megatron-SP-style
        activation sharding; weights FSDP over both data and model axes);
      * odd kv-head archs (GQA kv=8 / MQA kv=1 on a 16-way axis) replicate
        KV heads for train/prefill and shard the *cache sequence* for
        decode (distributed flash-decode).
    """
    kw: dict = {}
    odd_heads = bool(cfg.n_heads) and cfg.n_heads % model_axis != 0
    odd_kv = bool(cfg.n_kv_heads) and cfg.n_kv_heads % model_axis != 0

    if dp_applicable(cfg, shape, mesh_size):
        # Pure DP + ZeRO-3: one example per rank, no tensor parallelism.
        kw.update(batch=("pod", "data", "model"), heads=None, kv_heads=None,
                  ffn=None, vocab=None, expert=None,
                  embed_p=("data", "model"))
        if overrides:
            kw.update(overrides)
        return Rules(**kw)

    if odd_heads:
        kw.update(heads=None, kv_heads=None, ffn=None, vocab=None,
                  embed_p=("data", "model"))
        if shape.kind in ("train", "prefill"):
            kw["seq"] = ("model",)
            kw["inner_seq"] = ("model",)
        else:
            kw["kv_seq"] = ("model",)
    elif cfg.shard_activation_seq and shape.kind == "train":
        kw["seq"] = ("model",)
    if not odd_heads and odd_kv:
        kw["kv_heads"] = None
        if shape.kind == "decode":
            kw["kv_seq"] = ("model",)
            kw["heads"] = None

    if shape.name == "long_500k":
        # global_batch=1: the batch axis cannot absorb "data"; the KV/state
        # sequence dim takes it.
        kw["kv_seq"] = ("pod", "data")
        kw["batch"] = ()

    if overrides:
        kw.update(overrides)
    return Rules(**kw)


def _sharding(mesh, rules: Rules, axes, shape=None) -> tuple:
    """Logical axes -> spec; ``shape`` (if given) drops sharding on dims
    the mesh axes do not divide (:func:`repro_torch.runtime.sharding
    .spec_for`)."""
    return spec_for(mesh, rules, axes, shape)


def _map_specs(fn, specs: dict) -> dict:
    return {k: (_map_specs(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in specs.items()}


def param_shardings(cfg: ModelConfig, mesh, rules: Rules) -> dict:
    return _map_specs(lambda spec: _sharding(mesh, rules, spec[1],
                                             shape=spec[0]),
                      tfm.param_specs(cfg))


def replicated(mesh) -> tuple:
    return REPLICATED


def batch_shardings(cfg: ModelConfig, mesh, rules: Rules,
                    batch_specs: dict) -> dict:
    out = {}
    for k, spec in batch_specs.items():
        shape = getattr(spec, "shape", None)
        if k in ("tokens", "labels", "weights"):
            out[k] = _sharding(mesh, rules, ("batch", None), shape)
        elif k in ("vision_embeds", "frames"):
            out[k] = _sharding(mesh, rules, ("batch", None, None), shape)
        elif k in ("pos", "last_tokens"):
            out[k] = _sharding(mesh, rules, ("batch",), shape)
        else:
            out[k] = replicated(mesh)
    return out


def opt_state_shardings(cfg: ModelConfig, mesh, rules: Rules) -> OptState:
    ps = param_shardings(cfg, mesh, rules)
    return OptState(m=ps, v=ps, count=replicated(mesh))


def train_state_shardings(cfg: ModelConfig, mesh, rules: Rules
                          ) -> TrainState:
    return TrainState(params=param_shardings(cfg, mesh, rules),
                      opt_state=opt_state_shardings(cfg, mesh, rules),
                      step=replicated(mesh), compress_residual=None)


def _check_whole_heads(cfg: ModelConfig, mesh, rules: Rules) -> None:
    """A ``heads`` or ``kv_heads`` dim splits the flattened ``H x hd``
    column (a Mamba2 mixer's ``heads`` its ``H x P`` one): each rank's
    block must be whole heads."""
    counts = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads}
    mixer = {"heads": cfg.n_ssm_heads if cfg.family in ("ssm", "hybrid")
             else 0}
    specs = tfm.param_specs(cfg)
    for path, spec in leaves_with_path(param_shardings(cfg, mesh, rules)):
        node = specs
        for key in path:
            node = node[key]
        whole = mixer if (path[0] == "blocks" and path[-1]
                          in ssd.ssd_param_specs(cfg)) else counts
        for name, entry in zip(node[1], spec):
            n = axis_size(mesh, entry)
            if name in whole and n > 1 and whole[name] % n:
                raise ValueError(
                    f"{'/'.join(path)}: {whole[name]} {name} do not split "
                    f"into whole heads over {n} ranks ({entry})")


def local_params(params: dict, cfg: ModelConfig, mesh, rules: Rules
                 ) -> dict:
    """This rank's block of each whole parameter under
    :func:`param_shardings` on ``mesh`` (a ``DeviceMesh``): a dim whose
    mesh axes do not divide it stays whole (an odd vocabulary, kv heads
    that do not divide the model axis).  Raises ``ValueError`` for a
    ``heads`` or ``kv_heads`` block that is not whole heads (attention's,
    or a Mamba2 mixer's).  A leaf that requires grad gives a block that
    does too (a new leaf); a replicated leaf is passed through."""
    _check_whole_heads(cfg, mesh, rules)

    def block(t, spec):
        if not any(live_dims(mesh, e) for e in spec):
            return t
        return local_shard(t.detach(), spec, mesh).requires_grad_(
            t.requires_grad)
    return map_tree(block, params, param_shardings(cfg, mesh, rules))


def local_train_state(state: TrainState, cfg: ModelConfig, mesh,
                      rules: Rules) -> TrainState:
    """:func:`local_params` of a whole train state: the parameters, AdamW's
    moments and the compression residual cut alike, the count and step as
    they are."""
    params = local_params(state.params, cfg, mesh, rules)
    specs = param_shardings(cfg, mesh, rules)

    def cut(tree):
        return None if tree is None else map_tree(
            lambda t, spec: local_shard(t, spec, mesh), tree, specs)
    opt = state.opt_state
    return TrainState(params=params,
                      opt_state=OptState(m=cut(opt.m), v=cut(opt.v),
                                         count=opt.count),
                      step=state.step,
                      compress_residual=cut(state.compress_residual))


def decode_state_shardings(cfg: ModelConfig, mesh, rules: Rules,
                           state: dict) -> dict:
    """Match :func:`repro_torch.launch.inputs.decode_state_specs`'
    structure (stacked-layer caches), leaf by leaf name."""
    def for_leaf(path, leaf):
        name, joined = path[-1], "/".join(path)
        if name == "cursor":            # the port's host int
            return replicated(mesh)
        shp = tuple(leaf.shape)
        nd = len(shp)
        if name in ("k", "v"):          # (L, B, S, Hkv, D)
            return _sharding(mesh, rules,
                             ("layer", "batch", "kv_seq", "kv_heads", None),
                             shp)
        if name == "ssm":               # (L, B, H, P, N)
            return _sharding(mesh, rules,
                             ("layer", "batch", "heads", None, None), shp)
        if "conv" in joined:            # (L, B, W-1, C): C sharded for x
            return _sharding(mesh, rules,
                             ("layer", "batch", None,
                              "heads" if shp[-1] > 512 else None), shp)
        if name == "pos":               # (B,)
            return _sharding(mesh, rules, ("batch",), shp)
        if name == "enc_frames":        # (B, S_enc, D)
            return _sharding(mesh, rules, ("batch", None, None), shp)
        return replicated(mesh) if nd == 0 else _sharding(
            mesh, rules, ("batch",) + (None,) * (nd - 1), shp)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, path + (str(i),))
                         for i, v in enumerate(node))
        return for_leaf(path, node)
    return walk(state, ())


def relayout_decode_state(state: dict, cfg: ModelConfig, mesh,
                          rules_from: Rules, rules_to: Rules, batch: int,
                          max_len: int) -> dict:
    """A decode state (:func:`repro_torch.models.transformer
    .init_decode_state`'s tree, for ``batch`` rows and ``max_len``
    positions) held as this rank's blocks under ``rules_from``, carried
    into ``rules_to``'s blocks: each leaf whose layout differs is gathered
    whole over the mesh (a collective every rank makes) and cut again, the
    others passed through.  Serving runs a prefill under
    ``prefill_32k``'s rules (kv heads whole or split, the cache's
    sequence whole) and its decode steps under ``decode_32k``'s
    (``kv_seq``), as the reference's dry run lowers them."""
    whole = tfm._decode_state(cfg, batch, max_len, torch.device("meta"))
    src = decode_state_shardings(cfg, mesh, rules_from, whole)
    dst = decode_state_shardings(cfg, mesh, rules_to, whole)

    def walk(node, a, b):
        if isinstance(node, dict):
            return {k: walk(v, a[k], b[k]) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(*x) for x in zip(node, a, b))
        if not isinstance(node, torch.Tensor) or a == b:
            return node
        return local_shard(gather_whole(node, a, mesh), b, mesh)
    return walk(state, src, dst)


def abstract_params(cfg: ModelConfig) -> dict:
    """Meta-device stand-ins of the parameters (no allocation)."""
    dtype = getattr(torch, cfg.param_dtype)
    return _map_specs(lambda spec: torch.empty(spec[0], dtype=dtype,
                                               device="meta"),
                      tfm.param_specs(cfg))


def abstract_opt_state(cfg: ModelConfig, params_abs: dict) -> OptState:
    dt = getattr(torch, cfg.optimizer_state_dtype)
    mv = _map_specs(lambda p: torch.empty(p.shape, dtype=dt, device="meta"),
                    params_abs)
    return OptState(m=mv, v=mv, count=torch.empty((), dtype=torch.int32,
                                                   device="meta"))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    params = abstract_params(cfg)
    return TrainState(params=params,
                      opt_state=abstract_opt_state(cfg, params),
                      step=torch.empty((), dtype=torch.int32, device="meta"),
                      compress_residual=None)
