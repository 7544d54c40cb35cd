"""One ``generate`` call's decode step captured as a CUDA graph and
replayed for every decode step of the call, so that a step is one host
launch and the card, not the host, paces decode.

:func:`serve_loop.generate <repro_torch.runtime.serve_loop.generate>`
takes the graph where :func:`takes_graph` says so: on a CUDA device with
no sharding context bound (a bound context's collectives move tensors
through host memory, which a graph cannot hold), for a call with decode
steps whose cache has room for all of them.  Everywhere else, and for
the prefill, the eager step runs as it is.  Every family's step is
captured: dense, MoE, VLM, SSM, hybrid and the encoder-decoder (whose
step runs its encoder again, K4 a layer, as the eager one does).

The graph is one capture a call: a batch's shapes, its cache and its
buffers are its own (the prefill allocates the cache), and a graph bakes
in shapes and addresses.  :class:`DecodeGraph` captures the step on the
first decode step, with no eager warm-up, and each call replays it:

- the step reads its tokens from a buffer of its own (``fed``): under
  greedy decoding the graph copies its own argmax there; teacher forcing
  copies the next column in before the replay (:meth:`DecodeGraph.feed`);
- the cache cursor is read on the device: the graph keeps the positions
  ``pos`` ((B,) int32, advanced in place by each replay), and the cache
  row a step writes is ``pos + offset`` (the vision prefix's length for a
  VLM, whose positions run short of its cache rows: ROADMAP fault F3; 0
  elsewhere), by an indexed copy, with K6's ``kv_len`` from the same
  tensor (``cache_row`` of :mod:`repro_torch.models.transformer`'s
  forwards).  The host ``int`` cursor in the state advances by one a
  replay, as the eager step's does;
- the logits and the argmax are the graph's outputs, overwritten by the
  next replay: the caller copies what it keeps.

Every capture allocates from one memory pool a device, kept for the
process (:func:`_pool`), so a batch's graph reuses the blocks of the
graphs before it; a graph is dropped with its :class:`DecodeGraph`.
The step's first use of the side stream happens in the capture, which
needs no eager warm-up: the prefill has created the cuBLAS handle (a
handle cannot be created while a stream captures).  A
capture neither synchronizes nor empties the allocator's cache: it runs
on a side stream while the card still runs the prefill.

The kernel wrappers count launches in ``.launches`` when Python calls
them, which a replay does not: the capture's counts are taken back, and
each replay adds them again (every replay launches those kernels).
Spans and counters entered during the capture become the graph's
template under a profiler (:func:`repro_torch.runtime.tracing.captured`);
:meth:`DecodeGraph.traced` adds a replay's spans and counters, and each
replay adds 1 to the counter ``repro_torch.serve.decode_replays``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.moe_gmm.ops import grouped_matmul
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import tracing
from repro_torch.runtime.sharding import current_context, vocab_argmax

#: The forward's kernel wrappers, whose ``.launches`` a replay adds to.
WRAPPERS = (flash_attention, decode_attention, grouped_matmul, ssd_scan)
#: The counter of the decode steps a replay served.
REPLAYS = "repro_torch.serve.decode_replays"

#: One capture stream and one anchor graph a CUDA device index: the
#: anchor, a graph of one kernel kept for the process, holds the memory
#: pool that every decode graph on the device captures into.
_STREAMS: dict = {}
_ANCHORS: dict = {}


def _kv(cache: dict) -> Optional[dict]:
    """The K/V cache with its host cursor (the hybrid's sites' for a
    hybrid), or None for an SSM's states."""
    if "cursor" in cache:
        return cache
    return cache.get("kv")


def _advanced(cache: dict) -> dict:
    """``cache`` with its host cursor one step on, as a one-token forward
    returns it."""
    if "cursor" in cache:
        return dict(cache, cursor=cache["cursor"] + 1)
    if "kv" in cache:
        return dict(cache, kv=dict(cache["kv"],
                                   cursor=cache["kv"]["cursor"] + 1))
    return cache


def takes_graph(state: dict, steps: int) -> bool:
    """Whether a call's ``steps - 1`` decode steps from ``state`` (the
    prefill's) replay a captured graph: on a CUDA device, with no
    sharding context bound, where the cache has a row for every step
    (else the eager step raises where the cache is full)."""
    if steps < 2 or state["pos"].device.type != "cuda" or \
            current_context() is not None:
        return False
    kv = _kv(state["cache"])
    return kv is None or kv["cursor"] + steps - 1 <= kv["k"].shape[2]


def _stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.device(device).index or 0
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _pool(device: torch.device) -> tuple:
    """The id of the device's capture pool.  The caching allocators (the
    device's and, since torch 2.11, the pinned host memory's) refuse a
    pool whose last graph is gone, and a ``MemPool`` holds only the
    device's: so the pool is an anchor graph's, captured once and held
    for the process."""
    index = torch.device(device).index or 0
    if index not in _ANCHORS:
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(_stream(device)):
            anchor.capture_begin()
            try:
                torch.zeros(1, device=device)
            finally:
                anchor.capture_end()
        _ANCHORS[index] = anchor
    return _ANCHORS[index].pool()


def _capture(step: Callable, device: torch.device):
    """``(graph, step's outputs, tracer template, capture s, instantiation
    s)``: ``step`` captured on the device's side stream into its pool,
    then instantiated (the host seconds of each)."""
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.stream(_stream(device)):
        graph.capture_begin(pool=_pool(device))
        try:
            with tracing.captured() as template:
                out = step()
        finally:
            t1 = time.perf_counter()
            graph.capture_end()
    return graph, out, template, t1 - t0, time.perf_counter() - t1


class DecodeGraph:
    """One call's decode step, captured from the prefill's ``state`` with
    ``prompt_len`` text tokens a request, its first replay fed ``fed``
    ((B,) tokens); ``greedy``: each replay feeds the next its own argmax,
    else :meth:`feed` gives each later replay its tokens.  Attributes
    ``capture_s`` and ``instantiate_s``: the host seconds of the capture
    and of ending it (instantiation)."""

    def __init__(self, cfg: ModelConfig, params: dict, state: dict,
                 prompt_len: int, fed: torch.Tensor, greedy: bool):
        device = state["pos"].device
        self.pos = state["pos"].clone()
        self.fed = fed.clone()
        cache = state["cache"]
        kv = _kv(cache)
        offset = 0 if kv is None else kv["cursor"] - prompt_len
        extras = ({"frames": state["enc_frames"]} if "enc_frames" in state
                  else {})

        def step():
            row = None if kv is None else (self.pos[:1] + offset).long()
            res = tfm.forward(params, cfg, tokens=self.fed[:, None],
                              cache=cache, positions=self.pos[:, None],
                              cache_row=row, **extras)
            logits = tfm.logits(params, cfg, res.hidden[:, -1])
            tok = vocab_argmax(logits, cfg.vocab_size)
            self.pos.add_(1)
            if greedy:
                self.fed.copy_(tok)
            return logits, tok

        before = [w.launches for w in WRAPPERS]
        (self.graph, self.out, self.template, self.capture_s,
         self.instantiate_s) = _capture(step, device)
        self.launches = [w.launches - n for w, n in zip(WRAPPERS, before)]
        for w, n in zip(WRAPPERS, before):
            w.launches = n

    def feed(self, tokens: torch.Tensor) -> None:
        """The next replay's input tokens (teacher forcing)."""
        self.fed.copy_(tokens)

    def replay(self, state: dict) -> tuple:
        """One decode step: ``(logits (B, V) float32, argmax (B,), state
        with its host cursor advanced)``; the two tensors are the graph's
        and the next replay overwrites them."""
        self.graph.replay()
        for w, n in zip(WRAPPERS, self.launches):
            w.launches += n
        tracing.count(REPLAYS, 1)
        logits, tok = self.out
        return logits, tok, dict(state, cache=_advanced(state["cache"]),
                                 pos=self.pos)

    def traced(self, span) -> None:
        """After a replay, outside its decode-step span ``span``: that
        replay's spans and counters where a profiler records (waits for
        the card then; nothing otherwise)."""
        tracing.replayed(self.template, span)
