"""Decoder-only LM, dense and MoE families (those parts of
``repro.models.transformer``).

Parameters are a nested dict of tensors in the reference's layout: the
repeated layers stacked on a leading ``(n_layers, ...)`` axis under
``"blocks"``, so carrying the reference's weights across is a copy
(:func:`repro_torch.convert.from_reference_params`).  The forward unbinds
each stacked weight once and loops over the layers in Python; under
autograd each layer body is checkpointed as ``cfg.remat`` says (the
reference's ``jax.checkpoint``), so the backward recomputes it.  An MoE
block's FFN is :func:`repro_torch.models.moe.moe_ffn` (kernel K7), and the
forward sums its aux loss over the layers.  The other families (``vlm``,
``ssm``, ``hybrid``, ``encdec``) are later slices and raise.
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
from repro_torch.models import layers, moe
from repro_torch.models.config import ModelConfig

#: The ROADMAP item that brings each family not ported yet.
_LATER = {
    "vlm": "the VLM prefix (ROADMAP queue 1, item 9)",
    "ssm": "SSM and hybrid serving on K8 (ROADMAP queue 1, item 12)",
    "hybrid": "SSM and hybrid serving on K8 (ROADMAP queue 1, item 12)",
    "encdec": "the encoder-decoder family (ROADMAP queue 1, item 9)",
}


def _ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')}")


# =========================================================== param specs
def _stack(specs: dict, n: int) -> dict:
    """Prepend a stacked-layer axis to every spec in ``specs``."""
    return {k: ((n,) + shape, ("layer",) + axes)
            for k, (shape, axes) in specs.items()}


def block_param_specs(cfg: ModelConfig) -> dict:
    """One decoder block (attention + FFN or MoE) including norms."""
    _ported(cfg)
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


def param_specs(cfg: ModelConfig) -> dict:
    """Full tree of ``(shape, logical_axes)`` for the model."""
    _ported(cfg)
    specs: dict = {
        "embed": {"table": ((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed_p"))},
        "final_norm": {"scale": ((cfg.d_model,), (None,))},
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"table": ((cfg.d_model, cfg.vocab_size),
                                      ("embed_p", "vocab"))}
    specs["blocks"] = _stack(block_param_specs(cfg), cfg.n_layers)
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
    ``device``; a stacked weight is drawn a layer at a time in float32."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    params: dict = {}
    for path, shape in _leaves(param_specs(cfg)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
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
    lower to); ``"none"`` runs it as is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(
            checkpoint.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default])
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return functools.partial(checkpoint.checkpoint, fn, use_reentrant=False)


def _attn_block(blk, h, cfg, positions, cache, kv_len=None):
    """One block: ``(h, cache, aux)``, aux the MoE layer's loss (``None``
    when dense)."""
    hn1 = layers.rms_norm(h, blk["ln1"], cfg.norm_eps)
    a, cache = layers.attention(blk, hn1, cfg, positions=positions,
                                kv_cache=cache, kv_len=kv_len)
    h = h + a
    hn = layers.rms_norm(h, blk["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = moe.moe_ffn(blk, hn, cfg)
        return h + f, cache, aux
    return h + layers.mlp(blk, hn, cfg), cache, None


def _make_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                device=None) -> dict:
    """Stacked K/V caches ``(n_layers, B, max_len, Hkv, hd)`` in the
    parameter dtype; the cursor is one host ``int`` for every layer (the
    reference keeps a per-layer int32 on the device), so the kernels'
    ``q_offset`` and ``kv_len`` come from it with no device sync."""
    dev = resolve_device(device)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = getattr(torch, cfg.param_dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "cursor": 0}


def decoder_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                    vision_embeds: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    positions: Optional[torch.Tensor] = None
                    ) -> ForwardResult:
    """Dense or MoE decoder-only forward over the stacked blocks."""
    _ported(cfg)
    if vision_embeds is not None:
        raise NotImplementedError(f"vision embeddings: {_LATER['vlm']}")
    h = params["embed"]["table"][tokens].to(getattr(torch, cfg.param_dtype))
    b, s = h.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=h.device)[None, :]
    kv_len = None
    if cache is not None and s == 1:
        # One kv_len tensor for every layer of a decode step.
        kv_len = torch.full((b,), cache["cursor"] + 1, dtype=torch.int32,
                            device=h.device)
    # One unbind a weight: its backward is one stack, where indexing each
    # layer would add a zero-filled (n_layers, ...) gradient a layer.
    layer_weights = {name: w.unbind(0)
                     for name, w in params["blocks"].items()}
    training = torch.is_grad_enabled() and any(
        t.requires_grad for grp in params.values() for t in grp.values())
    body = _remat(_attn_block, cfg) if training else _attn_block
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        blk = {name: ws[i] for name, ws in layer_weights.items()}
        layer_cache = None if cache is None else {
            "k": cache["k"][i], "v": cache["v"][i],
            "cursor": cache["cursor"]}
        h, _, aux_i = body(blk, h, cfg, positions, layer_cache, kv_len)
        if aux_i is not None:
            aux = aux + aux_i
    h = layers.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = None if cache is None else dict(cache,
                                                cursor=cache["cursor"] + s)
    return ForwardResult(hidden=h, aux_loss=aux, cache=new_cache)


def forward(params: dict, cfg: ModelConfig, **kwargs) -> ForwardResult:
    """The family's forward (the dense or MoE decoder; the others
    raise)."""
    return decoder_forward(params, kwargs.pop("tokens"), cfg, **kwargs)


def unembed_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["unembed"]["table"]


# ======================================================== decode caches
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """The family's decode state: the stacked KV caches (dense and
    MoE)."""
    _ported(cfg)
    return _make_cache(cfg, cfg.n_layers, batch, max_len, device)


# ================================================================ module
class DecoderLM(nn.Module):
    """A thin ``nn.Module`` over the same parameter tree (no copies):
    ``model(tokens, cache=..., positions=...)`` is :func:`decoder_forward`.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _ported(cfg)
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
                positions: Optional[torch.Tensor] = None) -> ForwardResult:
        return decoder_forward(self.params(), tokens, self.cfg, cache=cache,
                               positions=positions)
