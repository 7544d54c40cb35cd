"""Serving: prefill + decode steps and a capacity-aware request router.

The router is the serving-plane face of CloudPowerCap: replica throughput
is proportional to power-capped capacity, so dispatch weights follow the
caps the manager sets.

Prefill runs kernel K4 in every attention layer and each decode step
kernel K6 (:mod:`repro_torch.models.layers`); an MoE model's expert FFN
runs kernel K7 three times a layer a forward (:mod:`repro_torch.models.
moe`); an SSM layer's prefill runs kernel K8 once and its decode step the
plain recurrence (:mod:`repro_torch.models.ssd`).  A VLM's prefill takes
the patch embeddings from ``extras["vision_embeds"]``; an
encoder-decoder's takes ``extras["frames"]``, keeps them in the state,
and every decode step runs the encoder over them again (K4 a layer) before
its self and cross attention (K6 each), as the reference's does.  As
there, ``state["pos"]`` starts at the text prompt's length, also behind a
vision prefix, while the cache cursor counts the prefix too (ROADMAP fault
F3: a VLM's decode steps rotate their queries and keys by positions short
of their cache rows by the prefix's length).  The decode state
(KV caches, SSM and conv states) is updated in place.  The cache cursor
is a host ``int``, advanced once a forward, so the kernels' ``q_offset``
and ``kv_len`` need no device sync; the
token positions stay a ``(B,)`` device tensor for RoPE, and the greedy
tokens stay on the device from one step to the next.  On one CUDA device
with no sharding context bound, :func:`generate` captures its decode step
once as a CUDA graph and replays it for every decode step of the call
(:mod:`repro_torch.runtime.decode_graph`: the step's cache row and
``kv_len`` read on the device); the CPU and every bound context run the
eager step.

Under a bound sharding context the parameters are a rank's blocks
(:func:`repro_torch.launch.shardspecs.local_params`) and every rank
passes the whole prompt: each takes its rows of a batch split over the
batch dims (:func:`repro_torch.runtime.sharding.batch_block`), its cache
is its block of :func:`repro_torch.launch.shardspecs
.decode_state_shardings`' layout (its kv heads and rows), and its logits
are its rows and its block of the vocabulary.  The greedy token is the
largest logit over every rank's block, ties to the lower global index
(:func:`repro_torch.runtime.sharding.vocab_argmax`), and
:func:`generate` gathers the whole batch's tokens and logits at the end.
Under a sequence split the prefill's logits come from the last
position's hidden state, gathered from the rank whose block holds it;
under ``kv_seq`` each rank's cache is its block of the positions.
:func:`generate` may run its prefill under one layout and its decode
steps under another (``decode_layout``: the state carried across by
:func:`repro_torch.launch.shardspecs.relayout_decode_state`), as the
reference's dry run lowers ``prefill_32k`` and ``decode_32k``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional

import torch

from repro_torch.backend import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import decode_graph, tracing
from repro_torch.runtime.sharding import (batch_block, batch_whole,
                                          current_context, gather_dims,
                                          live_dims, seq_split,
                                          sharding_context, vocab_argmax)


#: Ids of :func:`generate`'s calls: the batch id its requests' spans share.
_BATCHES = itertools.count()


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill(params, tokens, extras: Optional[dict] = None):
        """tokens: (B, S) prompt -> (last-position logits (B, V) float32,
        decode state).  ``extras``: ``vision_embeds`` (vlm), ``frames``
        (encdec; without them the forward raises ``ValueError``).  Under
        a batch split the logits and the state are this rank's rows, and
        under a vocabulary split the logits its block."""
        extras = {k: batch_block(v) for k, v in (extras or {}).items()}
        whole = tokens.shape[0]
        tokens = batch_block(tokens)
        b, s = tokens.shape
        # The whole batch: the state's layout gives each rank its rows.
        cache = tfm.init_decode_state(cfg, whole, max_len, tokens.device)
        res = tfm.forward(params, cfg, tokens=tokens, cache=cache, **extras)
        last = res.hidden[:, -1]
        sp = seq_split()
        if sp is not None:
            # The last position is the last rank's block's.
            last = gather_dims(last[:, None], sp[0], sp[1], 1)[:, -1]
        logits = tfm.logits(params, cfg, last)
        state = {"cache": res.cache,
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device)}
        if cfg.family == "encdec":
            state["enc_frames"] = extras["frames"]
        return logits, state
    return prefill


def make_decode_step(cfg: ModelConfig, sample: str = "greedy"):
    def decode(params, state, tokens):
        """tokens: (B,) last emitted tokens -> (next_logits, new state)."""
        pos = state["pos"]
        extras = ({"frames": state["enc_frames"]} if "enc_frames" in state
                  else {})
        res = tfm.forward(params, cfg, tokens=tokens[:, None],
                          cache=state["cache"], positions=pos[:, None],
                          **extras)
        logits = tfm.logits(params, cfg, res.hidden[:, -1])
        new_state = dict(state)
        new_state["cache"] = res.cache
        new_state["pos"] = pos + 1
        return logits, new_state
    return decode


def _decode_replays(cfg: ModelConfig, params, state: dict, prompt_len: int,
                    out: list, seen: list, forced, steps: int):
    """:func:`generate`'s decode steps as replays of one captured graph
    (:mod:`repro_torch.runtime.decode_graph`), captured in the first
    step's span: each step's tokens and logits copied into ``out`` and
    ``seen``.  The graph is dropped on return."""
    graph = None
    for i in range(steps - 1):
        with tracing.span("repro_torch.serve.decode_step",
                          step=i + 1) as rec:
            if graph is None:
                graph = decode_graph.DecodeGraph(
                    cfg, params, state, prompt_len,
                    out[-1] if forced is None else forced[:, 0],
                    forced is None)
            elif forced is not None:
                graph.feed(forced[:, i])
            logits, tok, state = graph.replay(state)
            out.append(tok.clone())
        seen.append(logits.clone())
        graph.traced(rec)


def _whole_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``logits`` over every rank's block of the vocabulary (the bound
    context's split), ``logits`` itself where it is whole."""
    ctx = current_context()
    if ctx is None or logits.shape[-1] == vocab:
        return logits
    mesh, rules = ctx
    return gather_dims(logits, mesh,
                       live_dims(mesh, rules.mesh_axes("vocab", mesh)),
                       logits.dim() - 1)


def generate(cfg: ModelConfig, params, prompt: torch.Tensor, steps: int,
             max_len: int, forced: Optional[torch.Tensor] = None,
             extras: Optional[dict] = None,
             decode_layout: Optional[tuple] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill (with ``extras``, as :func:`make_prefill_step` takes them)
    + ``steps - 1`` decode steps; returns ``(tokens (B, steps), logits
    (B, steps, V) float32)``, the logits each token was read from.

    Greedy: each step feeds back the argmax of the last logits.  With
    ``forced`` ((B, steps) tokens), step ``i + 1`` is fed ``forced[:, i]``
    instead (teacher forcing), so two runs can be compared logit by logit.
    Under a bound sharding context every rank passes the whole prompt
    and gets the whole batch's tokens and logits (gathered once, at the
    end).  With ``decode_layout = (rules, params)`` the prefill runs under
    the bound context and the decode steps under ``rules`` on the same
    mesh, with ``params`` (this rank's blocks under ``rules``), the state
    carried across by :func:`repro_torch.launch.shardspecs
    .relayout_decode_state`; both layouts split the batch alike.

    Under a ``torch.profiler`` session it records the spans
    ``repro_torch.serve.generate`` (a fresh ``batch`` id, ``n``,
    ``prompt_len``, ``steps``), its child ``.serve.prefill`` and one child
    ``.serve.decode_step`` a decode step (``step``: the index in
    ``tokens`` of the token it picks), :mod:`repro_torch.runtime.tracing`,
    and adds to the counter ``repro_torch.serve.decode_replays`` 1 for a
    step a graph replay served, 0 for an eager one.  On one device nothing
    in them waits for it, but the spans inside a replayed step's forward
    are read after the step, which waits for the card
    (:meth:`repro_torch.runtime.decode_graph.DecodeGraph.traced`).
    """
    b = prompt.shape[0]
    with tracing.span("repro_torch.serve.generate", batch=next(_BATCHES),
                      n=b, prompt_len=prompt.shape[1], steps=steps):
        prefill = make_prefill_step(cfg, max_len)
        decode = make_decode_step(cfg)
        with tracing.span("repro_torch.serve.prefill"):
            logits, state = prefill(params, prompt, extras)
        first = _whole_vocab(logits, cfg.vocab_size)
        layout = contextlib.nullcontext()
        if decode_layout is not None:
            from repro_torch.launch.shardspecs import relayout_decode_state
            rules_to, params = decode_layout
            mesh, rules_from = current_context()
            state = dict(state, cache=relayout_decode_state(
                state["cache"], cfg, mesh, rules_from, rules_to, b,
                max_len))
            layout = sharding_context(mesh, rules_to)
        if forced is not None:
            forced = batch_block(forced)
        with layout:
            out, seen = [vocab_argmax(first, cfg.vocab_size)], []
            replays = decode_graph.takes_graph(state, steps)
            if replays:
                _decode_replays(cfg, params, state, prompt.shape[1], out,
                                seen, forced, steps)
            for i in range(0 if replays else steps - 1):
                with tracing.span("repro_torch.serve.decode_step",
                                  step=i + 1):
                    fed = out[-1] if forced is None else forced[:, i]
                    logits, state = decode(params, state, fed)
                    out.append(vocab_argmax(logits, cfg.vocab_size))
                    tracing.count(decode_graph.REPLAYS, 0)
                seen.append(logits)
            tokens = torch.stack(out, dim=1)
            logits = first[:, None]
            if seen:
                logits = torch.cat([logits, _whole_vocab(
                    torch.stack(seen, dim=1), cfg.vocab_size)], 1)
        return batch_whole(tokens, b), batch_whole(logits, b)


def greedy_generate(cfg: ModelConfig, params, prompt, steps: int,
                    max_len: int, extras: Optional[dict] = None,
                    device=None) -> torch.Tensor:
    """Prefill + N greedy decode steps on ``device`` (``None``: the GPU);
    returns the (B, steps) tokens."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev)
    extras = {k: torch.as_tensor(v, device=dev)
              for k, v in (extras or {}).items()}
    return generate(cfg, params, prompt, steps, max_len,
                    extras=extras)[0]


# ------------------------------------------------------------------ router
@dataclasses.dataclass
class Replica:
    replica_id: str
    host_id: str                  # host in the CPC cluster snapshot
    queue: int = 0                # outstanding requests


class CapacityAwareRouter:
    """Weighted least-loaded dispatch, weights = power-capped capacity.

    ``sync_capacities`` reads the capacities straight from the CloudPowerCap
    snapshot, so a cap redistribution (e.g. after a DPM power-off) shifts
    traffic within one control-loop period with no further coordination.
    """

    def __init__(self, replicas: list[Replica]):
        self.replicas = {r.replica_id: r for r in replicas}
        self.capacity: dict[str, float] = {r: 1.0 for r in self.replicas}

    def sync_capacities(self, snapshot) -> None:
        for rid, rep in self.replicas.items():
            host = snapshot.hosts[rep.host_id]
            self.capacity[rid] = max(host.managed_capacity, 0.0)

    def route(self, n_requests: int = 1) -> list[str]:
        """Assign requests to replicas; returns replica ids (one per req)."""
        out = []
        for _ in range(n_requests):
            live = [(rid, rep) for rid, rep in self.replicas.items()
                    if self.capacity.get(rid, 0.0) > 0.0]
            if not live:
                raise RuntimeError("no replica has capacity")
            rid, rep = min(
                live,
                key=lambda kv: (kv[1].queue + 1) / self.capacity[kv[0]])
            rep.queue += 1
            out.append(rid)
        return out

    def complete(self, replica_id: str) -> None:
        self.replicas[replica_id].queue -= 1
