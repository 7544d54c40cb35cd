"""Training step: streamed-xent loss, gradients, AdamW update (the
reference's ``repro.runtime.train_loop``).

The batch is a plain dict (tokens/labels/weights, and the frontend's
``vision_embeds`` or ``frames``).  ``weights`` carries the
power-aware batch mask (:mod:`repro_torch.runtime.power_integration`):
examples a capped pod cannot afford this step weigh zero and the loss
renormalizes.  The state's tensors are updated in place (the optimizer's
departure from the reference); ``step`` is a host ``int``.

Data parallelism: under a sharding context
(:mod:`repro_torch.runtime.sharding`) whose batch axes have more than one
rank, each rank takes its shard of each microbatch, and the gradients are
summed over the batch ranks, one all-reduce a leaf in the tree's order,
the twin of the reduction ``jit`` inserts.  The reference runs the whole
microbatch in one program, so each rank differentiates its part of the
microbatch's loss: its xent sum, plus the aux loss times the
microbatch's weight sum (all-reduced, never the rank's own), the aux
loss's value being the whole microbatch's (an MoE layer's dense dispatch
routes the whole microbatch: :func:`repro_torch.models.moe
._moe_ffn_dense`) and its gradient this rank's part.  The sum over ranks
and microbatches, divided by the global weight sum, is then the
reference's gradient, whatever each rank's weights.

Tensor parallelism and FSDP storage: the parameters are each rank's
blocks (:func:`repro_torch.launch.shardspecs.local_params`) and every
rank of a ``model`` split takes the same batch shard.  Three kinds of
gradient each take their own reduction (:func:`grad_reductions`): a
block split over ``model`` is whole on its rank and stays local; an FSDP
leaf's gradient arrives reduce-scattered over the dims it is stored
over (:func:`repro_torch.runtime.sharding.gather_param`'s backward), so
it is summed only over the batch dims it is not stored over; and a leaf
stored whole whose gradient is each rank's part of a sum over ``model``
(the kv projections where the q heads are split and the kv heads are
not) is all-reduced over ``model``.  Under a sequence split (``seq``) the
ranks along its dims take the same examples and each its block of the
positions: the loss and the weights are summed over them
(:func:`repro_torch.models.layers.streamed_xent`), the labels and
weights are the rank's block of the positions (a VLM's prefix rows
weigh zero), and each leaf that the layout does not split over those
dims takes its gradient's sum over them
(:func:`repro_torch.models.transformer.partial_sum_leaves`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.backend import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import streamed_xent
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.compress import ErrorFeedbackCompressor
from repro_torch.runtime.sharding import (FSDP_AXES, all_reduce,
                                          batch_split_dims, current_context,
                                          dims_size, live_dims, seq_split,
                                          spec_for)
from repro_torch.tree import leaves, leaves_with_path, map_tree


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


def _loss_terms(cfg: ModelConfig):
    def terms(params, batch):
        """``(loss_sum, w_sum, aux)``: the token-weighted xent sum, the
        weights' sum and the MoE layers' aux loss.  The batch's frontend
        inputs (``vision_embeds``, ``frames``) go to the family's forward,
        which takes those it knows; an ``encdec`` forward raises
        ``ValueError`` without ``frames``.  Only the last
        ``labels.shape[1]`` positions are scored: a ``vlm`` prefix's rows
        are not."""
        extras = {k: v for k, v in batch.items() if k not in _TEXT}
        res = tfm.forward(params, cfg, tokens=batch["tokens"], **extras)
        labels, weights = batch["labels"], batch["weights"]
        sp = seq_split()
        if sp is None:
            h = res.hidden[:, res.hidden.shape[1] - labels.shape[1]:]
        else:
            # The rank's block of the positions: the labels aligned to
            # the whole sequence, a prefix's rows weighing zero.
            h, n_blk = res.hidden, res.hidden.shape[1]
            pad = n_blk * sp[3] - labels.shape[1]
            lo = sp[2] * n_blk
            labels = F.pad(labels, (pad, 0))[:, lo:lo + n_blk]
            weights = F.pad(weights, (pad, 0))[:, lo:lo + n_blk]
        w_out = tfm.unembed_weight(params, cfg)
        loss_sum, w_sum = streamed_xent(h, w_out, labels, weights,
                                        chunk=cfg.xent_chunk,
                                        vocab=cfg.vocab_size)
        return loss_sum, w_sum, res.aux_loss
    return terms


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01):
    terms = _loss_terms(cfg)

    def loss_fn(params, batch):
        loss_sum, w_sum, aux = terms(params, batch)
        w_sum = torch.clamp_min(w_sum, 1.0)
        loss = loss_sum / w_sum + aux_weight * aux
        metrics = {"loss": (loss_sum / w_sum).detach(),
                   "aux_loss": aux.detach(), "tokens": w_sum}
        return loss, metrics
    return loss_fn


def batch_split(grad_shardings: Optional[dict] = None,
                cfg: Optional[ModelConfig] = None):
    """``(mesh, dims, index, n)`` of the data-parallel split in the bound
    sharding context (the batch's mesh dims larger than 1, this rank's
    row-major position along them), or None.  Any layout of
    :func:`repro_torch.launch.shardspecs.rules_for` is taken:
    ``grad_shardings`` (the parameters' specs, :func:`repro_torch.launch
    .shardspecs.param_shardings`) may shard any leaf, and tensor
    parallelism, FSDP storage and a sequence split are
    :func:`grad_reductions`' to reduce."""
    return batch_split_dims()


def grad_reductions(cfg: ModelConfig, grad_shardings: Optional[dict] = None
                    ) -> Optional[list]:
    """Per leaf in the tree's order, ``(sum dims, partial dims, divisor)``
    in the bound context, or None where no leaf needs anything (no
    context, or one whose splits are all of one rank).  ``sum dims``: the
    batch's mesh dims larger than 1 that the leaf is not stored over
    (FSDP's reduce-scatter summed those); ``partial dims``: the dims over
    which a leaf stored whole holds each rank's part of its gradient
    (:func:`repro_torch.models.transformer.partial_sum_leaves`: the
    kv projections, and under a sequence split the leaves it leaves whole
    over the ``seq`` dims);
    ``divisor``: the ranks of the leaf's FSDP dims that took the same
    batch shard and the same positions (their reduce-scatter summed
    copies).  ``grad_shardings``
    is :func:`repro_torch.launch.shardspecs.param_shardings`' tree (made
    from the context when None)."""
    ctx = current_context()
    if ctx is None:
        return None
    mesh, rules = ctx
    batch = live_dims(mesh, rules.mesh_axes("batch", mesh))
    seq = live_dims(mesh, rules.mesh_axes("seq", mesh))
    partial = tfm.partial_sum_leaves(cfg)
    specs = tfm.param_specs(cfg)
    out, needed = [], False
    for path, (shape, axes) in leaves_with_path(specs):
        spec = spec_for(mesh, rules, axes, shape)
        if grad_shardings is not None:
            node = grad_shardings
            for key in path:
                node = node[key]
            spec = node
        fsdp = tuple(a for ax, e in zip(axes, spec) if ax in FSDP_AXES
                     for a in live_dims(mesh, e))
        red = (tuple(a for a in batch if a not in fsdp),
               partial.get(path, ()),
               dims_size(mesh, [a for a in fsdp
                                if a not in batch and a not in seq]))
        needed = needed or red != (batch, (), 1)
        out.append(red)
    return out if needed else None


def _grad_tree(cfg: ModelConfig, params: dict, batch: dict, objective):
    """The gradient of ``objective`` in every leaf of ``params`` (same
    tree).  A text-only VLM batch does not reach ``vision_proj``: it gets
    a zero gradient, as ``jax.grad`` gives it.  Any other leaf the
    objective does not reach is autograd's error."""
    unused = ("vision_proj" if cfg.family == "vlm"
              and "vision_embeds" not in batch else None)
    reached = {g: t for g, t in params.items() if g != unused}
    grads = iter(torch.autograd.grad(objective, leaves(reached)))
    return {g: (map_tree(torch.zeros_like, t) if g == unused
                else map_tree(lambda _: next(grads), t))
            for g, t in params.items()}


def make_grads_fn(cfg: ModelConfig, aux_weight: float = 0.01,
                  grad_shardings: Optional[dict] = None):
    """``grads_fn(params, batch) -> (grads, metrics)``: the gradient of the
    loss in every parameter (same tree), accumulated over
    ``cfg.microbatches`` slices of the batch (token-weighted, in float32,
    so it equals the whole batch's gradient under power-aware masking),
    and under data parallelism (:func:`batch_split`) over the batch ranks
    too: microbatch ``j`` is the reference's (the batch's ``j``-th
    contiguous slice), of which each rank takes its contiguous shard."""
    loss_fn = make_loss_fn(cfg, aux_weight)
    terms = _loss_terms(cfg)
    k = max(cfg.microbatches, 1)

    def grads_fn(params, batch):
        split = batch_split(grad_shardings, cfg)
        plan = grad_reductions(cfg, grad_shardings)
        if k == 1 and split is None:
            loss, metrics = loss_fn(params, batch)
            grads = _grad_tree(cfg, params, batch, loss)
            if plan is not None:
                mesh = current_context()[0]
                for g, (_, part, div) in zip(leaves(grads), plan):
                    all_reduce(g, mesh, part)
                    if div != 1:
                        g.div_(div)
            return grads, metrics
        # Every value of the batch, the frontend's embeddings too, is
        # split along the batch axis.
        mbs = [dict(zip(batch, parts)) for parts in
               zip(*(v.chunk(k, dim=0) for v in batch.values()))]
        if split is not None:
            _, _, index, n = split
            b = next(iter(mbs[0].values())).shape[0]
            if b % n:
                raise ValueError(f"a microbatch of {b} does not split over "
                                 f"{n} data-parallel ranks")
            mbs = [{key: v[index * (b // n):(index + 1) * (b // n)]
                    for key, v in mb.items()} for mb in mbs]
        gsum = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        zero = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
        loss_sum, tok_sum, aux_sum = zero, zero, zero
        for mb in mbs:
            if split is None:
                loss, metrics = loss_fn(params, mb)
                tokens = metrics["tokens"]
                grads = _grad_tree(cfg, params, mb, loss)
                for a, g in zip(leaves(gsum), leaves(grads)):
                    a.add_(g.float() * tokens)
                loss_sum = loss_sum + metrics["loss"] * tokens
                aux = metrics["aux_loss"]
            else:
                # The microbatch's loss times its (all-reduced) weight:
                # this rank's xent sum, and the aux loss, whose value is
                # the microbatch's and whose gradient is this rank's part.
                mesh, dims, _, _ = split
                part, w_part, aux = terms(params, mb)
                tokens = torch.clamp_min(
                    all_reduce(w_part.detach().clone(), mesh, dims), 1.0)
                grads = _grad_tree(cfg, params, mb,
                                   part + aux_weight * tokens * aux)
                for a, g in zip(leaves(gsum), leaves(grads)):
                    a.add_(g.float())
                loss_sum = loss_sum + part.detach()
                aux = aux.detach()
            tok_sum = tok_sum + tokens
            aux_sum = aux_sum + aux
        if plan is not None:
            mesh = current_context()[0]
            for g, (dims, part, div) in zip(leaves(gsum), plan):
                all_reduce(g, mesh, dims + part)
                if div != 1:
                    g.div_(div)
        elif split is not None:
            for g in leaves(gsum):
                all_reduce(g, split[0], split[1])
        if split is not None:
            mesh, dims, _, _ = split
            loss_sum = all_reduce(loss_sum.clone(), mesh, dims)
        tok = torch.clamp_min(tok_sum, 1.0)
        # In place: a second float32 tree beside the sums would double the
        # gradients' peak.
        grads = map_tree(lambda g: g.div_(tok), gsum)
        return grads, {"loss": loss_sum / tok,
                       "aux_loss": aux_sum / len(mbs),
                       "tokens": tok_sum}

    return grads_fn


def _norm_dims(cfg: ModelConfig, grad_shardings: Optional[dict]):
    """``(mesh, per-leaf mesh dims that shard it)`` for
    :func:`repro_torch.optim.adamw.global_norm` in the bound context, or
    None where no leaf is split over more than one rank."""
    ctx = current_context()
    if ctx is None:
        return None
    mesh, rules = ctx
    dims = []
    for path, (shape, axes) in leaves_with_path(tfm.param_specs(cfg)):
        spec = spec_for(mesh, rules, axes, shape)
        if grad_shardings is not None:
            spec = grad_shardings
            for key in path:
                spec = spec[key]
        dims.append(tuple(a for e in spec for a in live_dims(mesh, e)))
    return (mesh, dims) if any(dims) else None


def make_train_step(cfg: ModelConfig, opt: AdamW, aux_weight: float = 0.01,
                    compression: bool = False,
                    grad_shardings: Optional[dict] = None):
    """``train_step(state, batch) -> (state, metrics)``; the metrics are
    device tensors (``loss``, ``aux_loss``, ``tokens``, ``grad_norm``).
    Under data parallelism every rank passes the whole ``batch`` and
    takes its shard; ``grad_shardings`` as :func:`batch_split` takes
    it."""
    grads_fn = make_grads_fn(cfg, aux_weight, grad_shardings)

    def train_step(state: TrainState, batch: dict):
        grads, metrics = grads_fn(state.params, batch)
        residual = state.compress_residual
        if compression and residual is not None:
            grads, residual = ErrorFeedbackCompressor().compress(grads,
                                                                 residual)
        gnorm = global_norm(grads, _norm_dims(cfg, grad_shardings))
        params, opt_state = opt.update(grads, state.opt_state, state.params,
                                       grad_norm=gnorm)
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1,
                          compress_residual=residual), metrics

    return train_step
