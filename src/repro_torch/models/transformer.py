"""Model zoo: the decoder-only LM (dense, MoE and the VLM's vision prefix),
the Mamba2 SSM, the Zamba2-style hybrid and the Whisper-style
encoder-decoder (``repro.models.transformer``).

Parameters are a nested dict of tensors in the reference's layout: the
repeated layers stacked on a leading ``(n_layers, ...)`` axis under
``"blocks"`` (and the hybrid's one shared attention block under
``"shared_attn"``), so carrying the reference's weights across is a copy
(:func:`repro_torch.convert.from_reference_params`).  The forwards unbind
each stacked weight once and loop over the layers in Python; under
autograd each decoder layer body is checkpointed as ``cfg.remat`` says
(the reference's ``jax.checkpoint``), so the backward recomputes it.  An
MoE block's FFN is :func:`repro_torch.models.moe.moe_ffn` (kernel K7), and
the forward sums its aux loss over the layers.  An SSM layer is
:func:`repro_torch.models.ssd.ssd_block` (kernel K8 at prefill, K8b in
its backward); under autograd each Mamba layer is checkpointed as the
reference's ``ssm_forward`` and ``hybrid_forward`` checkpoint their scan
bodies, and the hybrid's shared attention block is not, as there.  The
``vlm`` family is the dense decoder with precomputed patch embeddings
projected and prepended (``vision_embeds``); the ``encdec`` family runs a
non-causal encoder over precomputed frame embeddings (``frames``) and a
decoder whose blocks add cross attention over the encoder's output (K4,
or K6 for a one-token step), each body checkpointed as ``cfg.remat``
says.

Under a bound sharding context (:mod:`repro_torch.runtime.sharding`) the
parameters are this rank's blocks
(:func:`repro_torch.launch.shardspecs.local_params`).  Each layer body
gathers its FSDP leaves whole where it starts, inside the checkpoint, so
that the backward's recompute gathers them again and only the blocks
stay alive between the passes; their gradients leave by reduce-scatter.
Attention and the MLP run tensor parallel on their blocks
(:mod:`repro_torch.models.layers`), the embedding over a split
vocabulary looks up the rank's rows and all-reduces, and the decode
state is allocated at the rank's block of
:func:`repro_torch.launch.shardspecs.decode_state_shardings`.  Under a
sequence split (``seq``) every forward embeds the whole sequence (a
VLM's prefix concatenated first) and keeps this rank's block of its
positions, or, over a vocabulary split on the same dims, reduce-scatters
the ranks' lookups to it; each layer takes and returns the block
(:mod:`repro_torch.models.layers`), the RoPE positions are the rank's
absolute ones, and the encoder-decoder's encoder runs whole on every
rank.  A Mamba2 mixer runs on its rank's block of heads
(:mod:`repro_torch.models.ssd`).  Under ``kv_seq`` the decode caches are
the rank's block of positions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.backend import resolve_device
from repro_torch.models import layers, moe, ssd
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.sharding import (axis_size, check_seq_blocks,
                                          copy_to, current_context,
                                          dims_coordinate, gather_block,
                                          gather_param, gather_seq,
                                          gather_plan, leaf_gathers,
                                          live_dims, local_shape,
                                          scatter_seq, seq_block, seq_split,
                                          sharding_context, spec_for,
                                          split_over, sum_in_rank_order,
                                          sum_over)

# =========================================================== param specs
def _stack(specs: dict, n: int) -> dict:
    """Prepend a stacked-layer axis to every spec in ``specs``."""
    return {k: ((n,) + shape, ("layer",) + axes)
            for k, (shape, axes) in specs.items()}


def block_param_specs(cfg: ModelConfig) -> dict:
    """One decoder block (attention + FFN or MoE) including norms."""
    specs = {
        "ln1": ((cfg.d_model,), (None,)),
        "ln2": ((cfg.d_model,), (None,)),
    }
    specs.update(layers.attention_param_specs(cfg))
    if cfg.family == "moe":
        specs.update(moe.moe_param_specs(cfg))
    else:
        specs.update(layers.mlp_param_specs(cfg))
    return specs


def _enc_block_specs(cfg: ModelConfig) -> dict:
    specs = {"ln1": ((cfg.d_model,), (None,)),
             "ln2": ((cfg.d_model,), (None,))}
    specs.update(layers.attention_param_specs(cfg))
    specs.update(layers.mlp_param_specs(cfg))
    return specs


def _dec_block_specs(cfg: ModelConfig) -> dict:
    specs = dict(block_param_specs(cfg))
    specs["ln_cross"] = ((cfg.d_model,), (None,))
    specs.update({f"cross_{k}": v for k, v in
                  layers.attention_param_specs(cfg).items()})
    return specs


def _ssm_block_specs(cfg: ModelConfig) -> dict:
    specs = {"ln": ((cfg.d_model,), (None,))}
    specs.update(ssd.ssd_param_specs(cfg))
    return specs


#: One layer's specs by the kind of its body.
_BLOCK_SPECS = {"block": block_param_specs, "enc": _enc_block_specs,
                "dec": _dec_block_specs, "ssm": _ssm_block_specs}


def param_specs(cfg: ModelConfig) -> dict:
    """Full tree of ``(shape, logical_axes)`` for the model."""
    specs: dict = {
        "embed": {"table": ((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed_p"))},
        "final_norm": {"scale": ((cfg.d_model,), (None,))},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"table": ((cfg.d_model, cfg.vocab_size),
                                      ("embed_p", "vocab"))}
    if cfg.family in ("dense", "moe", "vlm"):
        specs["blocks"] = _stack(block_param_specs(cfg), cfg.n_layers)
        if cfg.family == "vlm":
            specs["vision_proj"] = {
                "w": ((cfg.d_model, cfg.d_model), ("embed_p", None))}
    elif cfg.family in ("ssm", "hybrid"):
        specs["blocks"] = _stack(_ssm_block_specs(cfg), cfg.n_layers)
        if cfg.family == "hybrid":
            specs["shared_attn"] = block_param_specs(cfg)
    elif cfg.family == "encdec":
        specs["enc_blocks"] = _stack(_enc_block_specs(cfg), cfg.enc_layers)
        specs["dec_blocks"] = _stack(_dec_block_specs(cfg), cfg.n_layers)
        specs["enc_norm"] = {"scale": ((cfg.d_model,), (None,))}
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return specs


def _leaves(specs: dict, prefix=()):
    for name, spec in specs.items():
        if isinstance(spec, dict):
            yield from _leaves(spec, prefix + (name,))
        else:
            yield prefix + (name,), spec[0]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (``None``:
    the GPU): ones for 1-D scales, else a normal truncated at 2 standard
    deviations with ``std = 1 / sqrt(fan_in)``, ``fan_in = shape[-2]``
    (the reference's scheme, which draws a stacked ``(n_layers, d)`` norm
    scale like a weight and an expert weight ``(E, D, F)`` with fan-in D;
    its ``jax.random`` bits differ).  ``generator`` must live on
    ``device``; a stacked weight is drawn a layer at a time in float32.
    The reference's three SSM fix-ups follow by name: ``a_log`` is
    ``log(linspace(1, 16, H))`` in every layer, ``dt_bias`` zero and
    ``d_skip`` one.  Its fix-up of ``"conv_b"`` names no leaf, so the conv
    biases keep their draw, as do ``ln`` and ``norm_scale``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    params: dict = {}
    for path, shape in _leaves(param_specs(cfg)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        name = path[-1]
        if name == "a_log":
            a_log = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                             dtype=torch.float32, device=dev))
            node[name] = a_log.to(dtype).expand(shape).contiguous()
            continue
        if name in ("dt_bias", "d_skip"):
            fill = torch.zeros if name == "dt_bias" else torch.ones
            node[name] = fill(shape, dtype=dtype, device=dev)
            continue
        if len(shape) == 1 or shape[-1] == 1:
            node[path[-1]] = torch.ones(shape, dtype=dtype, device=dev)
            continue
        std = 1.0 / math.sqrt(shape[-2])
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in out.reshape((-1,) + tuple(shape[-2:])):
            draw = torch.empty(part.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=generator)
            part.copy_(draw)
        node[path[-1]] = out
    return params


# ============================================================== forward
@dataclasses.dataclass
class ForwardResult:
    hidden: torch.Tensor               # (B, S, D) final hidden states
    aux_loss: torch.Tensor             # MoE auxiliary loss (0 when dense)
    cache: Optional[dict] = None       # updated decode state


def _remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed as ``cfg.remat`` says: ``"full"`` keeps only its
    inputs and recomputes the rest in the backward; ``"dots"`` also keeps
    the outputs of its matrix products (the reference's
    ``checkpoint_dots_with_no_batch_dims``: the 2-D ``mm`` the products
    lower to); ``"none"`` runs it as is.  Under a bound sharding context
    ``fn`` runs inside the context it was checkpointed in, so that its
    recompute, which autograd runs on its own thread for a CUDA backward,
    splits and gathers as the forward did."""
    if cfg.remat == "none":
        return fn
    ctx = current_context()
    if ctx is not None:
        fn = functools.partial(_in_context, ctx, fn)
    if cfg.remat == "dots":
        context = functools.partial(
            checkpoint.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default])
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return functools.partial(checkpoint.checkpoint, fn, use_reentrant=False)


def _in_context(ctx: tuple, fn, *args):
    with sharding_context(*ctx):
        return fn(*args)


def _training(params: dict) -> bool:
    """Whether this forward records a graph for a backward."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for grp in params.values() for t in grp.values())


@functools.lru_cache(maxsize=64)
def _block_plan(cfg: ModelConfig, kind: str, mesh, rules):
    return gather_plan(_BLOCK_SPECS[kind](cfg), mesh, rules)


def _gathered(blk: dict, cfg: ModelConfig, kind: str) -> dict:
    """A layer's leaves with its FSDP leaves gathered whole (``kind`` names
    its specs in :data:`_BLOCK_SPECS`); ``blk`` itself without a bound
    context."""
    ctx = current_context()
    if ctx is None:
        return blk
    return gather_block(blk, _block_plan(cfg, kind, *ctx))


def _top_leaf(params: dict, group: str, cfg: ModelConfig) -> torch.Tensor:
    """A leaf outside the layers (``embed``, ``unembed`` or
    ``vision_proj``), gathered whole along its FSDP dims."""
    (name, t), = params[group].items()
    ctx = current_context()
    if ctx is None:
        return t
    shape, axes = param_specs(cfg)[group][name]
    return gather_param(t, ctx[0], leaf_gathers(*ctx, shape, axes))


def _column_block(params: dict, group: str, cfg: ModelConfig
                  ) -> Optional[tuple]:
    """``(mesh, dims)`` where the table leaf of ``group`` (``embed`` or
    ``unembed``) is stored over FSDP dims that split no batch: the ranks
    along them hold the same tokens and rows, so each works on its block
    of ``d_model``'s columns and the ranks join the small results, where
    gathering the table would move all of it (MiniCPM-2B's tied table is
    566 MB in bf16).  None where the leaf is whole or a batch dim stores
    it (it is gathered, :func:`_top_leaf`)."""
    ctx = current_context()
    if ctx is None:
        return None
    mesh, rules = ctx
    (name, _), = params[group].items()
    shape, axes = param_specs(cfg)[group][name]
    gathers = leaf_gathers(mesh, rules, shape, axes)
    batch = live_dims(mesh, rules.mesh_axes("batch", mesh))
    if len(gathers) != 1 or set(gathers[0][1]) & set(batch):
        return None
    return mesh, gathers[0][1]


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """The token embeddings in the parameters' dtype.  Over a vocabulary
    split across ranks, each rank looks up the tokens its rows hold, zeros
    the others, and one all-reduce sums the ranks' parts (the identity
    backward: each rank's rows get their own tokens' gradients).  Over
    FSDP dims that split no batch (:func:`_column_block`) each rank looks
    up its block of the columns and the blocks are all-gathered (their
    gradient reduce-scattered back)."""
    cols = _column_block(params, "embed", cfg)
    table = (params["embed"]["table"] if cols is not None
             else _top_leaf(params, "embed", cfg))
    dtype = getattr(torch, cfg.param_dtype)
    tp = split_over("vocab", table.shape[0], cfg.vocab_size)
    e = table[tokens] if tp is None else sum_over(
        _own_rows(table, tokens, tp), tp[0], tp[1])
    if cols is not None:
        e = gather_seq(e, *cols, tensor_dim=-1)
    return e.to(dtype)


def _own_rows(table, tokens, tp):
    """This rank's part of the lookup over a vocabulary split: the rows it
    holds, zeros for the others' tokens."""
    rows = table.shape[0]
    local = tokens - tp[2] * rows
    own = (local >= 0) & (local < rows)
    return torch.where(own[..., None], table[local.clamp(0, rows - 1)], 0.0)


def _embedded(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
              vision_embeds: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, int]:
    """``(h, length)``: the embedded sequence, a ``vlm``'s projected patch
    embeddings (``vision_proj`` in the parameters' dtype) prepended, and
    its whole length.  Under a sequence split ``h`` is this rank's block
    of the positions: over a vocabulary split on the same dims
    (Megatron-SP) the ranks' lookups are reduce-scattered to it (the
    prefix added by the first rank), else it is cut from the whole.
    Raises ``ValueError`` where the ranks do not split the sequence into
    whole blocks."""
    sp = seq_split()
    dtype = getattr(torch, cfg.param_dtype)
    prefix = None
    if cfg.family == "vlm" and vision_embeds is not None:
        prefix = vision_embeds.to(dtype) @ _top_leaf(params, "vision_proj",
                                                     cfg)
    tp = split_over("vocab", params["embed"]["table"].shape[0],
                    cfg.vocab_size)
    if sp is not None and tp is not None and set(tp[1]) & set(sp[1]):
        if tuple(tp[1]) != tuple(sp[1]):
            raise ValueError(f"a vocabulary split over mesh dims {tp[1]}, "
                             f"the sequence over {sp[1]}")
        e = _own_rows(_top_leaf(params, "embed", cfg), tokens, tp)
        if prefix is not None:
            # The sum over the ranks takes the prefix from the first.
            e = torch.cat([(prefix if tp[2] == 0 else prefix * 0)
                           .to(e.dtype), e], 1)
        check_seq_blocks(e.shape[1], sp, "seq")
        return scatter_seq(e, sp[0], sp[1]).to(dtype), e.shape[1]
    h = embed(params, tokens, cfg)
    if prefix is not None:
        h = torch.cat([prefix, h], dim=1)
    if sp is None:
        return h, h.shape[1]
    check_seq_blocks(h.shape[1], sp, "seq")
    return seq_block(h, sp), h.shape[1]


def _no_seq_split(cfg: ModelConfig) -> None:
    """The layers that take no sequence split (MoE, Mamba2) raise
    ``ValueError`` under one: no rule of ``rules_for`` gives them one."""
    sp = seq_split()
    if sp is not None:
        raise ValueError(f"the {cfg.family} family's layers under a "
                         f"sequence split over mesh dims {sp[1]}")


def _attn_block(blk, h, cfg, positions, cache, kv_len=None):
    """One block: ``(h, cache, aux)``, aux the MoE layer's loss (``None``
    when dense), its FSDP leaves gathered first (:func:`_gathered`)."""
    return _attn_sublayers(_gathered(blk, cfg, "block"), h, cfg, positions,
                           cache, kv_len)


def _attn_sublayers(blk, h, cfg, positions, cache, kv_len=None,
                    cross=None):
    """One block's sub-layers on whole (or tensor-parallel) leaves.  With
    ``cross`` (the encoder's ``(k, v)``), a cross attention sub-layer over
    them follows the self attention, its input normed by ``ln_cross`` and
    its weights the ``cross_``-prefixed ones."""
    hn1 = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
    a, cache = layers.attention(blk, hn1, cfg, positions=positions,
                                kv_cache=cache, kv_len=kv_len)
    h = h + a
    if cross is not None:
        c, _ = layers.attention(
            {k[len("cross_"):]: v for k, v in blk.items()
             if k.startswith("cross_")},
            layers.rms_norm(h, blk["ln_cross"], cfg.norm_eps), cfg,
            cross_kv=cross)
        h = h + c
    hn = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        _no_seq_split(cfg)
        f, aux = moe.moe_ffn(blk, hn, cfg)
        return h + f, cache, aux
    return h + layers.mlp(blk, hn, cfg), cache, None


def _make_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                device: torch.device) -> dict:
    """Stacked K/V caches ``(n_layers, B, max_len, Hkv, hd)`` in the
    parameter dtype; the cursor is one host ``int`` for every layer (the
    reference keeps a per-layer int32 on the device), so the kernels'
    ``q_offset`` and ``kv_len`` come from it with no device sync."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = getattr(torch, cfg.param_dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "cursor": 0}


def _step_kv_len(cache: Optional[dict], s: int, b: int,
                 cache_row: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
    """One ``kv_len`` tensor for every layer of a one-token step over
    ``cache`` (``None`` for a longer one): from the host cursor, or from
    ``cache_row``, the cursor read on the device, where given (a captured
    decode step: :mod:`repro_torch.runtime.decode_graph`)."""
    if cache is None or s != 1:
        return None
    if cache_row is not None:
        return layers.row_kv_len(cache_row, b)
    return layers.decode_kv_len(cache["cursor"], b, cache["k"].shape[2],
                                cache["k"].device)


def _layer_cache(cache: dict, i: int, cache_row: Optional[torch.Tensor]
                 ) -> dict:
    """Layer (or site) ``i``'s views of the stacked K/V caches, the host
    cursor, and ``cache_row`` where given."""
    out = {"k": cache["k"][i], "v": cache["v"][i], "cursor": cache["cursor"]}
    if cache_row is not None:
        out["row"] = cache_row
    return out


def decoder_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                    vision_embeds: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    positions: Optional[torch.Tensor] = None,
                    cache_row: Optional[torch.Tensor] = None, **_
                    ) -> ForwardResult:
    """Dense, MoE or VLM decoder-only forward over the stacked blocks.

    A ``vlm`` model given ``vision_embeds`` (B, P, d_model) projects them
    by ``vision_proj`` in the parameters' dtype and prepends them to the
    token embeddings: the positions run over all ``P + S`` rows, and a
    cache takes ``P + S`` rows and advances its cursor by as many.  Under
    a sequence split the hidden states are this rank's block of the
    positions (:func:`_embedded`).  ``cache_row`` (a (1,) int64 device
    tensor) is the row a one-token step writes, read on the device
    (:func:`_step_kv_len`)."""
    h, s = _embedded(params, tokens, cfg, vision_embeds)
    b = h.shape[0]
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :]
    kv_len = _step_kv_len(cache, s, b, cache_row)
    # One unbind a weight: its backward is one stack, where indexing each
    # layer would add a zero-filled (n_layers, ...) gradient a layer.
    layer_weights = {name: w.unbind(0)
                     for name, w in params["blocks"].items()}
    body = _remat(_attn_block, cfg) if _training(params) else _attn_block
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        blk = {name: ws[i] for name, ws in layer_weights.items()}
        layer_cache = None if cache is None else _layer_cache(
            cache, i, cache_row)
        h, _, aux_i = body(blk, h, cfg, positions, layer_cache, kv_len)
        if aux_i is not None:
            aux = aux + aux_i
    h = layers.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = None if cache is None else dict(cache,
                                                cursor=cache["cursor"] + s)
    return ForwardResult(hidden=h, aux_loss=aux, cache=new_cache)


def _layer_state(cache: Optional[dict], i: int) -> Optional[dict]:
    """Layer ``i``'s SSM and conv states: views into the stacked ones."""
    if cache is None:
        return None
    return {"ssm": cache["ssm"][i], "conv": tuple(c[i] for c in
                                                  cache["conv"])}


def _store_state(cache: Optional[dict], i: int, new: dict) -> None:
    """Copy layer ``i``'s new states into the stacked ones, in place."""
    if cache is None:
        return
    cache["ssm"][i].copy_(new["ssm"])
    for stacked, state in zip(cache["conv"], new["conv"]):
        stacked[i].copy_(state)


def _mamba_layer(blk, h, cfg, state):
    blk = _gathered(blk, cfg, "ssm")
    out, new_state = ssd.ssd_block(
        blk, layers.rms_norm(h, blk["ln"], cfg.norm_eps), cfg, state=state)
    return h + out, new_state


def ssm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, **_) -> ForwardResult:
    """Mamba2: a stack of SSD mixers with pre-norm residuals.

    ``cache`` is :func:`init_decode_state`'s stacked states; each layer's
    new SSM and conv states are copied into it in place (the reference
    returns new stacked states), and it comes back as ``cache``.  The conv
    states keep the float32 storage they start in, holding values of the
    activations' dtype, which is what the next step reads.  Without a
    cache the forward runs from zero states and returns none."""
    _no_seq_split(cfg)
    h = embed(params, tokens, cfg)
    layer_weights = {name: w.unbind(0)
                     for name, w in params["blocks"].items()}
    body = _remat(_mamba_layer, cfg) if _training(params) else _mamba_layer
    for i in range(cfg.n_layers):
        blk = {name: ws[i] for name, ws in layer_weights.items()}
        h, new_state = body(blk, h, cfg, _layer_state(cache, i))
        _store_state(cache, i, new_state)
    h = layers.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return ForwardResult(hidden=h, aux_loss=torch.zeros(
        (), dtype=torch.float32, device=h.device), cache=cache)


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   cache: Optional[dict] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache_row: Optional[torch.Tensor] = None, **_
                   ) -> ForwardResult:
    """Zamba2-style: Mamba2 backbone + one shared attention block applied
    after every ``attn_every`` layers (``n_layers // attn_every`` sites,
    each with its own KV cache; the remaining layers run after the last
    site).  ``cache`` is ``{"ssm": stacked states, "kv": stacked KV caches
    of the sites}``, updated in place as :func:`ssm_forward` and
    :func:`repro_torch.models.layers.attention` update theirs; the KV
    cursor advances once a forward, for every site (``cache_row``: as
    :func:`decoder_forward` takes it)."""
    _no_seq_split(cfg)
    h = embed(params, tokens, cfg)
    b, s = h.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :]
    every = cfg.attn_every
    kv = None if cache is None else cache["kv"]
    kv_len = _step_kv_len(kv, s, b, cache_row)
    ssm_cache = None if cache is None else cache["ssm"]
    layer_weights = {name: w.unbind(0)
                     for name, w in params["blocks"].items()}
    body = _remat(_mamba_layer, cfg) if _training(params) else _mamba_layer
    for i in range(cfg.n_layers):
        blk = {name: ws[i] for name, ws in layer_weights.items()}
        h, new_state = body(blk, h, cfg, _layer_state(ssm_cache, i))
        _store_state(ssm_cache, i, new_state)
        if (i + 1) % every == 0:
            g = (i + 1) // every - 1
            site_cache = None if kv is None else _layer_cache(kv, g,
                                                              cache_row)
            h, _, _ = _attn_block(params["shared_attn"], h, cfg, positions,
                                  site_cache, kv_len)
    h = layers.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = None if cache is None else {
        "ssm": ssm_cache, "kv": dict(kv, cursor=kv["cursor"] + s)}
    return ForwardResult(hidden=h, aux_loss=torch.zeros(
        (), dtype=torch.float32, device=h.device), cache=new_cache)


def _enc_layer(blk, h, cfg, positions):
    """One encoder block: non-causal self attention and the MLP, each
    behind its pre-norm residual."""
    blk = _gathered(blk, cfg, "enc")
    a, _ = layers.attention(
        blk, layers.rms_norm(h, blk["ln1"], cfg.norm_eps), cfg,
        causal=False, positions=positions)
    h = h + a
    return h + layers.mlp(blk, layers.rms_norm(h, blk["ln2"], cfg.norm_eps),
                          cfg)


def _dec_layer(blk, h, enc_out, cfg, positions, cache, kv_len):
    """One decoder block with its cross K/V formed from ``enc_out`` inside
    it (so a checkpointed block recomputes them, as the reference's
    ``dec_body`` does).  Under tensor parallelism ``cross_wk`` and
    ``cross_wv`` give the rank's kv heads (or all of them where they stay
    whole), and ``enc_out`` enters through Megatron's ``f``."""
    blk = _gathered(blk, cfg, "dec")
    b, se, _ = enc_out.shape
    hd = cfg.head_dim
    tp = split_over("heads", blk["cross_wq"].shape[1] // hd, cfg.n_heads)
    if tp is not None:
        enc_out = copy_to(enc_out, tp[0], tp[1])
    ck = (enc_out @ blk["cross_wk"]).reshape(b, se, -1, hd)
    cv = (enc_out @ blk["cross_wv"]).reshape(b, se, -1, hd)
    h, _, _ = _attn_sublayers(blk, h, cfg, positions, cache, kv_len,
                              cross=(ck, cv))
    return h


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S_enc, d_model),
    cast to the parameters' dtype: ``enc_layers`` non-causal blocks with
    RoPE at ``arange(S_enc)``, then ``enc_norm``.  Under a sequence split
    the encoder runs whole on every rank (its frames need not split into
    whole blocks): each rank's gradient of it is then its decoder block's
    part."""
    ctx = current_context()
    if ctx is not None and (ctx[1].seq or ctx[1].inner_seq):
        whole = dataclasses.replace(ctx[1], seq=None, inner_seq=None)
        with sharding_context(ctx[0], whole):
            return encode(params, frames, cfg)
    e = frames.to(getattr(torch, cfg.param_dtype))
    positions = torch.arange(e.shape[1], device=e.device)[None, :]
    layer_weights = {name: w.unbind(0)
                     for name, w in params["enc_blocks"].items()}
    body = _remat(_enc_layer, cfg) if _training(params) else _enc_layer
    for i in range(cfg.enc_layers):
        e = body({name: ws[i] for name, ws in layer_weights.items()}, e, cfg,
                 positions)
    return layers.rms_norm(e, params["enc_norm"]["scale"], cfg.norm_eps)


def encdec_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   frames: Optional[torch.Tensor] = None,
                   cache: Optional[dict] = None,
                   enc_out: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   cache_row: Optional[torch.Tensor] = None, **_
                   ) -> ForwardResult:
    """Whisper-style: the encoder over ``frames`` (:func:`encode`; skipped
    when ``enc_out`` is given), then the decoder, each block self attention
    (with ``cache``, as :func:`decoder_forward`'s), cross attention over
    its own K/V of the encoder's output (no RoPE, non-causal) and the
    MLP.  Raises ``ValueError`` without ``frames`` or ``enc_out``: the
    reference's serving and training drivers pass no frames and stop
    there with a ``KeyError``.  ``cache_row``: as :func:`decoder_forward`
    takes it."""
    if enc_out is None:
        if frames is None:
            raise ValueError(
                "the encdec family needs frames (B, enc_seq, d_model), the "
                "audio frontend's precomputed frame embeddings; none were "
                "given (the reference's serve and train drivers pass none "
                "and fail with KeyError: 'frames', ROADMAP fault F4)")
        enc_out = encode(params, frames, cfg)
    h, s = _embedded(params, tokens, cfg)
    b = h.shape[0]
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :]
    kv_len = _step_kv_len(cache, s, b, cache_row)
    layer_weights = {name: w.unbind(0)
                     for name, w in params["dec_blocks"].items()}
    body = _remat(_dec_layer, cfg) if _training(params) else _dec_layer
    for i in range(cfg.n_layers):
        blk = {name: ws[i] for name, ws in layer_weights.items()}
        layer_cache = None if cache is None else _layer_cache(
            cache, i, cache_row)
        h = body(blk, h, enc_out, cfg, positions, layer_cache, kv_len)
    h = layers.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = None if cache is None else dict(cache,
                                                cursor=cache["cursor"] + s)
    return ForwardResult(hidden=h, aux_loss=torch.zeros(
        (), dtype=torch.float32, device=h.device), cache=new_cache)


FORWARDS = {
    "dense": decoder_forward,
    "moe": decoder_forward,
    "vlm": decoder_forward,
    "ssm": ssm_forward,
    "hybrid": hybrid_forward,
    "encdec": encdec_forward,
}


def forward(params: dict, cfg: ModelConfig, **kwargs) -> ForwardResult:
    """The family's forward."""
    return FORWARDS[cfg.family](params, kwargs.pop("tokens"), cfg, **kwargs)


def unembed_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """``(d_model, V)``: the unembedding (the embedding's transpose when
    tied), gathered whole along its FSDP dims; this rank's block of the
    vocabulary where it is split."""
    if cfg.tie_embeddings:
        return _top_leaf(params, "embed", cfg).T
    return _top_leaf(params, "unembed", cfg)


def logits(params: dict, cfg: ModelConfig, h: torch.Tensor
           ) -> torch.Tensor:
    """Serving's float32 logits of hidden states ``h`` (..., d_model): the
    product in ``h``'s type over the unembedding (this rank's block of a
    split vocabulary).  Over FSDP dims that split no batch
    (:func:`_column_block`) each rank multiplies its block of the columns
    in float32 and the ranks' parts are added in rank order and rounded
    once to ``h``'s type, where gathering the table would move all of it.
    Forward only: training's xent gathers the table
    (:func:`unembed_weight`)."""
    group = "embed" if cfg.tie_embeddings else "unembed"
    cols = _column_block(params, group, cfg)
    if cols is None:
        return (h @ unembed_weight(params, cfg)).float()
    mesh, dims = cols
    w = params[group]["table"]
    w = w.T if cfg.tie_embeddings else w                  # (d_l, V_l)
    lo = dims_coordinate(mesh, dims) * w.shape[0]
    part = h[..., lo:lo + w.shape[0]].float() @ w.float()
    return sum_in_rank_order(part, mesh, dims).to(h.dtype).float()


def partial_sum_leaves(cfg: ModelConfig) -> dict:
    """``{leaf path: mesh dims}``: the leaves whose gradient on a rank is
    its part of a sum over those dims in the bound context: ``wk`` and
    ``wv`` where the q heads are split and the kv heads are not
    (:func:`repro_torch.models.layers.attention_partial_leaves`) and,
    under a sequence split, every leaf over the ``seq`` dims that its
    layout does not split (each rank differentiates its own positions).
    Empty without a context."""
    ctx = current_context()
    if ctx is None:
        return {}
    mesh, rules = ctx
    names, dims = layers.attention_partial_leaves(cfg)
    seq = live_dims(mesh, rules.mesh_axes("seq", mesh))
    specs = param_specs(cfg)
    out = {}
    for group, node in specs.items():
        for leaf, (shape, axes) in node.items():
            part = []
            base = leaf[len("cross_"):] if leaf.startswith("cross_") \
                else leaf
            if base in names and group != "embed":
                part += dims
            if seq:
                held = {a for e in spec_for(mesh, rules, axes, shape)
                        for a in live_dims(mesh, e)}
                part += [a for a in seq if a not in held]
            if part:
                out[(group, leaf)] = tuple(dict.fromkeys(part))
    return out


# ======================================================== decode caches
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """The family's decode state: the stacked KV caches (dense, MoE, VLM
    and the encoder-decoder's self attention), the stacked ``(n_layers,
    ...)`` SSM and conv states (ssm), or both, with one KV cache per
    shared-attention site (hybrid).  Under a bound sharding context each
    tensor is this rank's block of
    :func:`repro_torch.launch.shardspecs.decode_state_shardings`' layout
    (``kv_heads`` over the model dims, ``batch`` over the batch dims,
    ``kv_seq`` over the cache's positions: ``ValueError`` where its ranks
    do not split ``max_len`` into whole blocks)."""
    dev = resolve_device(device)
    ctx = current_context()
    if ctx is None:
        return _decode_state(cfg, batch, max_len, dev)
    from repro_torch.launch.shardspecs import decode_state_shardings
    kv_dims = live_dims(ctx[0], ctx[1].mesh_axes("kv_seq", ctx[0]))
    if kv_dims and cfg.family != "ssm" and \
            max_len % axis_size(ctx[0], kv_dims):
        raise ValueError(f"kv_seq: a cache of {max_len} positions does not "
                         f"split into {axis_size(ctx[0], kv_dims)} whole "
                         f"blocks over mesh dims {kv_dims}")
    whole = _decode_state(cfg, batch, max_len, torch.device("meta"))
    specs = decode_state_shardings(cfg, *ctx, whole)

    def block(node, spec):
        if isinstance(node, dict):
            return {k: block(v, spec[k]) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(block(v, sp) for v, sp in zip(node, spec))
        if not isinstance(node, torch.Tensor):
            return node
        return torch.zeros(local_shape(node.shape, spec, ctx[0]),
                           dtype=node.dtype, device=dev)
    return block(whole, specs)


def _decode_state(cfg: ModelConfig, batch: int, max_len: int,
                  dev: torch.device) -> dict:
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        return _make_cache(cfg, cfg.n_layers, batch, max_len, dev)
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(cfg.family)
    st = ssd.ssd_init_state(cfg, batch, dev)

    def stack(t):
        return t.new_zeros((cfg.n_layers,) + tuple(t.shape))

    stacked = {"ssm": stack(st["ssm"]),
               "conv": tuple(stack(c) for c in st["conv"])}
    if cfg.family == "ssm":
        return stacked
    return {"ssm": stacked,
            "kv": _make_cache(cfg, cfg.n_layers // cfg.attn_every, batch,
                              max_len, dev)}


# ================================================================ module
class DecoderLM(nn.Module):
    """A thin ``nn.Module`` over the same parameter tree (no copies):
    ``model(tokens, cache=..., positions=..., vision_embeds=...,
    frames=...)`` is :func:`forward`.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.groups = nn.ModuleDict({
            group: nn.ParameterDict({
                name: nn.Parameter(w, requires_grad=False)
                for name, w in tensors.items()})
            for group, tensors in params.items()})

    def params(self) -> dict:
        return {group: dict(tensors.items())
                for group, tensors in self.groups.items()}

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None, *,
                vision_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> ForwardResult:
        return forward(self.params(), self.cfg, tokens=tokens, cache=cache,
                       positions=positions, vision_embeds=vision_embeds,
                       frames=frames)
