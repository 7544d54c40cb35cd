"""The decode step replayed from a captured CUDA graph
(:mod:`repro_torch.runtime.decode_graph`), on the CPU at the smoke
configurations.

A one-token forward whose cache row and ``kv_len`` come from a device
tensor (``cache_row``) equals the host-cursor forward bit for bit, logits
and caches, over several steps of every family.  The runner's
bookkeeping is held with the CUDA graph replaced by a stand-in that
re-runs the captured step (:class:`StandIn`): tokens and logits equal the
eager step's, greedy and teacher forced; each kernel wrapper's
``.launches`` grows by the capture's count a replay, to the eager run's
count; under ``torch.profiler`` each batch gives the spans that the
benchmark's ``cpcbench.spans.expected`` counts, the MoE counters of the
eager run and one ``decode_replays`` a replayed step.  On the CPU, and
under a bound sharding context, nothing is captured."""

import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tfm
from repro_torch.runtime import decode_graph, serve_loop, tracing
from repro_torch.runtime.sharding import (MeshAxes, Rules,
                                          sharding_context)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from cpcbench import spans as bench_spans  # noqa: E402

ARCHS = ["granite_8b", "olmoe_1b_7b", "internvl2_26b", "zamba2_7b",
         "whisper_tiny", "mamba2_2p7b"]
N, S, STEPS = 3, 6, 5


@pytest.fixture(autouse=True)
def tracer(monkeypatch):
    """A tracer of its own: no session of another test is seen."""
    fresh = tracing.Tracer()
    monkeypatch.setattr(tracing, "_TRACER", fresh)
    return fresh


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        out[arch] = cfg, tfm.init_params(
            cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    return out


def _inputs(cfg, n=N, s=S, seed=1):
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (n, s), generator=g)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = 0.1 * torch.randn(
            n, cfg.n_prefix_embeds, cfg.d_model, generator=g)
    if cfg.family == "encdec":
        extras["frames"] = 0.1 * torch.randn(n, cfg.enc_seq, cfg.d_model,
                                             generator=g)
    return prompt, extras


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("arch", ARCHS)
def test_device_row_step_equals_host_cursor_step(models, arch):
    cfg, params = models[arch]
    prompt, extras = _inputs(cfg)
    max_len = (cfg.n_prefix_embeds or 0) + S + STEPS
    logits, host = serve_loop.make_prefill_step(cfg, max_len)(
        params, prompt, extras)
    dev = _clone(host)
    kv = decode_graph._kv(dev["cache"])
    offset = 0 if kv is None else kv["cursor"] - S
    assert offset == (cfg.n_prefix_embeds if cfg.family == "vlm" else 0)
    frames = {"frames": dev["enc_frames"]} if "enc_frames" in dev else {}
    decode = serve_loop.make_decode_step(cfg)
    tok = logits.argmax(-1)
    for _ in range(STEPS - 1):
        want, host = decode(params, host, tok)
        pos = dev["pos"]
        row = None if kv is None else (pos[:1] + offset).long()
        res = tfm.forward(params, cfg, tokens=tok[:, None],
                          cache=dev["cache"], positions=pos[:, None],
                          cache_row=row, **frames)
        got = tfm.logits(params, cfg, res.hidden[:, -1])
        dev = dict(dev, cache=res.cache, pos=pos + 1)
        assert torch.equal(got, want)
        for a, b in zip(_tensors(dev["cache"]), _tensors(host["cache"])):
            assert torch.equal(a, b)
        if kv is not None:
            assert decode_graph._kv(dev["cache"])["cursor"] == \
                decode_graph._kv(host["cache"])["cursor"]
        tok = want.argmax(-1)


def test_row_kv_len_is_the_row_plus_one_on_every_row():
    got = layers.row_kv_len(torch.tensor([7]), 4)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.tolist() == [8] * 4


class StandIn:
    """A captured graph's stand-in: the capture runs the step once (a
    real capture runs nothing, and its first replay runs the step), and
    each later replay re-runs it as a graph replay does, copying its
    outputs and its counters' values over the capture's; its Python side
    effects (spans, counters, the wrappers' counts) are held back, as a
    replay runs no Python."""

    def __init__(self, step, out, template):
        self.step, self.out, self.template = step, out, template
        self.replays = 0

    def replay(self):
        self.replays += 1
        if self.replays == 1:
            return
        counts = [w.launches for w in decode_graph.WRAPPERS]
        with tracing.captured() as again:
            new = self.step()
        for w, n in zip(decode_graph.WRAPPERS, counts):
            w.launches = n
        for old, fresh in zip(self.out, new):
            old.copy_(fresh)
        if again is not None and again.values is not None:
            self.template.values.copy_(again.values)


@pytest.fixture
def stand_in(monkeypatch):
    """Every ``generate`` on the CPU takes the graph path, its capture a
    :class:`StandIn`; yields the list of the stand-ins made."""
    made = []

    def capture(step, device):
        with tracing.captured() as template:
            out = step()
        made.append(StandIn(step, out, template))
        return made[-1], out, template, 0.0, 0.0

    monkeypatch.setattr(decode_graph, "takes_graph",
                        lambda state, steps: steps > 1)
    monkeypatch.setattr(decode_graph, "_capture", capture)
    return made


@pytest.fixture
def counting(monkeypatch):
    """The model's kernel calls on the CPU counted in their wrappers'
    ``.launches``, as the card's launches are; yields a function giving
    the counts."""
    wrappers = (fa_ops.flash_attention, da_ops.decode_attention,
                gmm_ops.grouped_matmul)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)

    def counted(module, name, wrapper):
        real = getattr(module, name)

        def call(*args, **kwargs):
            wrapper.launches += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    counted(layers, "flash_attention", fa_ops.flash_attention)
    counted(layers, "decode_attention", da_ops.decode_attention)
    counted(moe, "grouped_matmul", gmm_ops.grouped_matmul)
    return lambda: [w.launches for w in wrappers]


@pytest.mark.parametrize("arch", ARCHS)
def test_replays_equal_the_eager_steps(models, arch, monkeypatch):
    cfg, params = models[arch]
    prompt, extras = _inputs(cfg)
    max_len = (cfg.n_prefix_embeds or 0) + S + STEPS
    eager = serve_loop.generate(cfg, params, prompt, STEPS, max_len,
                                extras=extras)
    forced = torch.randint(0, cfg.vocab_size, (N, STEPS),
                           generator=torch.Generator().manual_seed(4))
    eager_forced = serve_loop.generate(cfg, params, prompt, STEPS, max_len,
                                       forced=forced, extras=extras)
    made = []

    def capture(step, device):
        out = step()
        made.append(StandIn(step, out, None))
        return made[-1], out, None, 0.0, 0.0
    monkeypatch.setattr(decode_graph, "takes_graph",
                        lambda state, steps: steps > 1)
    monkeypatch.setattr(decode_graph, "_capture", capture)
    got = serve_loop.generate(cfg, params, prompt, STEPS, max_len,
                              extras=extras)
    got_forced = serve_loop.generate(cfg, params, prompt, STEPS, max_len,
                                     forced=forced, extras=extras)
    assert [g.replays for g in made] == [STEPS - 1] * 2
    for a, b in ((got, eager), (got_forced, eager_forced)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("arch", ["granite_8b", "olmoe_1b_7b",
                                  "whisper_tiny"])
def test_each_replay_adds_the_captures_launches(models, arch, counting,
                                                monkeypatch):
    cfg, params = models[arch]
    prompt, extras = _inputs(cfg)
    serve_loop.generate(cfg, params, prompt, STEPS, S + STEPS,
                        extras=extras)
    eager = counting()
    assert eager[1] > 0
    for w in decode_graph.WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
    made = []

    def capture(step, device):
        out = step()
        made.append(StandIn(step, out, None))
        return made[-1], out, None, 0.0, 0.0
    monkeypatch.setattr(decode_graph, "takes_graph",
                        lambda state, steps: steps > 1)
    monkeypatch.setattr(decode_graph, "_capture", capture)
    serve_loop.generate(cfg, params, prompt, STEPS, S + STEPS,
                        extras=extras)
    assert counting() == eager


def _batch_spans(spans, root):
    """The names of the spans under ``root`` (a ``generate`` span),
    itself included."""
    by_id = {s.id: s for s in spans}

    def under(s):
        while s.parent is not None:
            if s.parent == root.id:
                return True
            s = by_id[s.parent]
        return False
    return Counter(s.name for s in spans if s is root or under(s))


@pytest.mark.parametrize("arch", ["granite_8b", "olmoe_1b_7b"])
def test_traced_replays_give_the_benchmarks_spans(models, arch, stand_in):
    cfg, params = models[arch]
    lengths = (5, 9)
    with profile(activities=[ProfilerActivity.CPU]):
        for s in lengths:
            serve_loop.generate(cfg, params, _inputs(cfg, s=s)[0], STEPS,
                                s + STEPS)
    trace = tracing.collect()
    assert len(stand_in) == 2
    assert all(g.template is not None for g in stand_in)
    roots = [s for s in trace.spans if s.name == "repro_torch.serve.generate"]
    model = {"family": cfg.family, "n_layers": cfg.n_layers}
    for root, s in zip(roots, lengths):
        want = bench_spans.expected(SimpleNamespace(
            batches=[(N, s, STEPS)], model=model))
        want = {k: v for k, v in want.items()
                if not k.startswith("repro_torch.power.") and v}
        assert _batch_spans(trace.spans, root) == want
    steps = {s.id for s in trace.spans if s.name == bench_spans.DECODE}
    for s in trace.spans:
        assert s.captured == (s.name.startswith("repro_torch.moe.")
                              and s.parent in steps)
    assert trace.counters[decode_graph.REPLAYS] == 2 * (STEPS - 1)
    if cfg.family == "moe":
        with profile(activities=[ProfilerActivity.CPU]):
            for s in lengths:
                serve_loop.generate(cfg, params, _inputs(cfg, s=s)[0],
                                    STEPS, s + STEPS)
        replayed = tracing.collect().counters
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(decode_graph, "takes_graph", lambda state, steps:
                       False)
            with profile(activities=[ProfilerActivity.CPU]):
                for s in lengths:
                    serve_loop.generate(cfg, params,
                                        _inputs(cfg, s=s)[0], STEPS,
                                        s + STEPS)
        eager = tracing.collect().counters
        for name in ("repro_torch.moe.pairs_routed",
                     "repro_torch.moe.pairs_kept"):
            assert replayed[name] == eager[name] > 0
        assert eager[decode_graph.REPLAYS] == 0


def test_a_capture_with_no_profiler_holds_no_tracer_work(models, stand_in):
    cfg, params = models["olmoe_1b_7b"]
    serve_loop.generate(cfg, params, _inputs(cfg)[0], STEPS, S + STEPS)
    assert [g.template for g in stand_in] == [None]
    assert tracing.collect().spans == []


def test_on_the_cpu_nothing_is_captured(models, monkeypatch):
    cfg, params = models["olmoe_1b_7b"]

    def refuse(step, device):
        raise AssertionError("captured on the CPU")
    monkeypatch.setattr(decode_graph, "_capture", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        serve_loop.generate(cfg, params, _inputs(cfg)[0], STEPS, S + STEPS)
    trace = tracing.collect()
    assert trace.counters[decode_graph.REPLAYS] == 0
    assert not any(s.captured for s in trace.spans)


def test_the_graph_is_taken_on_one_card_with_no_context_bound(models):
    cfg, params = models["granite_8b"]
    prompt, _ = _inputs(cfg)
    _, state = serve_loop.make_prefill_step(cfg, S + STEPS)(params, prompt)
    assert not decode_graph.takes_graph(state, STEPS)          # the CPU
    card = dict(state, pos=SimpleNamespace(device=torch.device("cuda")))
    assert decode_graph.takes_graph(card, STEPS)
    assert not decode_graph.takes_graph(card, 1)                # no step
    assert decode_graph.takes_graph(card, STEPS + 1)
    assert not decode_graph.takes_graph(card, STEPS + 2)        # no room
    with sharding_context(MeshAxes(("pod", "data", "model"), (1, 1, 1)),
                          Rules()):
        assert not decode_graph.takes_graph(card, STEPS)
