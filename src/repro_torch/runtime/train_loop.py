"""Training step: streamed-xent loss, gradients, AdamW update (the
reference's ``repro.runtime.train_loop``).

The batch is a plain dict (tokens/labels/weights, and the frontend's
``vision_embeds`` or ``frames``).  ``weights`` carries the
power-aware batch mask (:mod:`repro_torch.runtime.power_integration`):
examples a capped pod cannot afford this step weigh zero and the loss
renormalizes.  The state's tensors are updated in place (the optimizer's
departure from the reference); ``step`` is a host ``int``.  The
reference's ``grad_shardings`` constrain gradients to a mesh's layout; one
card has no mesh, so the port has no such argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.backend import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import streamed_xent
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.compress import ErrorFeedbackCompressor
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int
    compress_residual: Optional[dict] = None


def init_train_state(cfg: ModelConfig, opt: AdamW,
                     generator: torch.Generator, device=None,
                     compression: bool = False) -> TrainState:
    """Parameters from ``generator`` (which must live on ``device``;
    ``None``: the GPU), each a leaf that requires grad, and zero moments."""
    params = tfm.init_params(cfg, generator, resolve_device(device))
    for p in leaves(params):
        p.requires_grad_(True)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    if compression:
        state.compress_residual = ErrorFeedbackCompressor().init(params)
    return state


#: The families the port trains (all of the reference's): attention on K4
#: and K5, the MoE layer's experts on K7 (its backward two more K7
#: launches), the SSM and hybrid layers' scan on K8 and K8b.
TRAINED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


#: The batch's keys that are not the forward's frontend inputs.
_TEXT = ("tokens", "labels", "weights")


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01):
    def loss_fn(params, batch):
        """The batch's frontend inputs (``vision_embeds``, ``frames``) go
        to the family's forward, which takes those it knows; an ``encdec``
        forward raises ``ValueError`` without ``frames``.  Only the last
        ``labels.shape[1]`` positions are scored: a ``vlm`` prefix's rows
        are not."""
        extras = {k: v for k, v in batch.items() if k not in _TEXT}
        res = tfm.forward(params, cfg, tokens=batch["tokens"], **extras)
        h = res.hidden[:, res.hidden.shape[1] - batch["labels"].shape[1]:]
        w_out = tfm.unembed_weight(params, cfg)
        loss_sum, w_sum = streamed_xent(h, w_out, batch["labels"],
                                        batch["weights"],
                                        chunk=cfg.xent_chunk)
        w_sum = torch.clamp_min(w_sum, 1.0)
        loss = loss_sum / w_sum + aux_weight * res.aux_loss
        metrics = {"loss": (loss_sum / w_sum).detach(),
                   "aux_loss": res.aux_loss.detach(), "tokens": w_sum}
        return loss, metrics
    return loss_fn


def make_grads_fn(cfg: ModelConfig, aux_weight: float = 0.01):
    """``grads_fn(params, batch) -> (grads, metrics)``: the gradient of the
    loss in every parameter (same tree), accumulated over
    ``cfg.microbatches`` slices of the batch (token-weighted, in float32,
    so it equals the whole batch's gradient under power-aware masking)."""
    loss_fn = make_loss_fn(cfg, aux_weight)
    k = max(cfg.microbatches, 1)

    def grads_of(params, batch):
        loss, metrics = loss_fn(params, batch)
        # A text-only VLM batch does not reach ``vision_proj``: it gets a
        # zero gradient, as ``jax.grad`` gives it.  Any other leaf the loss
        # does not reach is autograd's error.
        unused = ("vision_proj" if cfg.family == "vlm"
                  and "vision_embeds" not in batch else None)
        reached = {g: t for g, t in params.items() if g != unused}
        grads = iter(torch.autograd.grad(loss, leaves(reached)))
        return {g: (map_tree(torch.zeros_like, t) if g == unused
                    else map_tree(lambda _: next(grads), t))
                for g, t in params.items()}, metrics

    def grads_fn(params, batch):
        if k == 1:
            return grads_of(params, batch)
        # Every value of the batch, the frontend's embeddings too, is
        # split along the batch axis.
        mbs = [dict(zip(batch, parts)) for parts in
               zip(*(v.chunk(k, dim=0) for v in batch.values()))]
        gsum = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        zero = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
        loss_sum, tok_sum, aux_sum = zero, zero, zero
        for mb in mbs:
            grads, metrics = grads_of(params, mb)
            tokens = metrics["tokens"]
            for a, g in zip(leaves(gsum), leaves(grads)):
                a.add_(g.float() * tokens)
            loss_sum = loss_sum + metrics["loss"] * tokens
            tok_sum = tok_sum + tokens
            aux_sum = aux_sum + metrics["aux_loss"]
        tok = torch.clamp_min(tok_sum, 1.0)
        # In place: a second float32 tree beside the sums would double the
        # gradients' peak.
        grads = map_tree(lambda g: g.div_(tok), gsum)
        return grads, {"loss": loss_sum / tok, "aux_loss": aux_sum / k,
                       "tokens": tok_sum}

    return grads_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, aux_weight: float = 0.01,
                    compression: bool = False):
    """``train_step(state, batch) -> (state, metrics)``; the metrics are
    device tensors (``loss``, ``aux_loss``, ``tokens``, ``grad_norm``)."""
    grads_fn = make_grads_fn(cfg, aux_weight)

    def train_step(state: TrainState, batch: dict):
        grads, metrics = grads_fn(state.params, batch)
        residual = state.compress_residual
        if compression and residual is not None:
            grads, residual = ErrorFeedbackCompressor().compress(grads,
                                                                 residual)
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, state.opt_state, state.params,
                                       grad_norm=gnorm)
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1,
                          compress_residual=residual), metrics

    return train_step
