"""The port's tracer (:mod:`repro_torch.runtime.tracing`) on the CPU, at
the smoke configurations: off it records nothing and changes no bit of
``generate``'s output; under ``torch.profiler`` each ``generate`` call is
one tree of spans (the prefill, each decode step, each MoE layer's four
phases under its forward), the MoE layer's kept-pairs counter equals a
plain recount, ``power_event`` gives its three spans, every span's
profiler event lies within the tracer's host interval (one clock), and
``collect`` returns the latest session alone."""

import dataclasses
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core.power_model import H100_HOST
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.runtime import serve_loop, tracing

ARCHS = ["granite_8b", "olmoe_1b_7b"]
PHASES = [f"repro_torch.moe.{p}"
          for p in ("route", "dispatch", "experts", "combine")]


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


def _prompt(cfg, n=3, s=8, seed=1):
    return torch.randint(0, cfg.vocab_size, (n, s),
                         generator=torch.Generator().manual_seed(seed))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_changes_no_bit(models, arch):
    cfg, params = models[arch]
    prompt = _prompt(cfg)
    tokens, logits = serve_loop.generate(cfg, params, prompt, 4, 16)
    off = tracing.collect()
    assert off.spans == [] and off.counters == {}
    (t2, l2), _ = _profiled(
        lambda: serve_loop.generate(cfg, params, prompt, 4, 16))
    assert torch.equal(tokens, t2) and torch.equal(logits, l2)
    assert tracing.collect().spans


def test_off_span_is_one_shared_no_op():
    a, b = tracing.span("x", i=1), tracing.span("y")
    assert a is b
    with a as entered:
        assert entered is None


@pytest.mark.parametrize("arch", ARCHS)
def test_each_generate_is_one_tree(models, arch):
    cfg, params = models[arch]
    steps = 4
    _profiled(lambda: [serve_loop.generate(cfg, params, _prompt(cfg, s=s),
                                           steps, 16) for s in (5, 9)])
    spans = tracing.collect().spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["repro_torch.serve.generate"] * 2
    assert [r.attrs["prompt_len"] for r in roots] == [5, 9]
    assert {r.attrs["n"] for r in roots} == {3}
    assert {r.attrs["steps"] for r in roots} == {steps}
    assert roots[0].attrs["batch"] != roots[1].attrs["batch"]
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    for root in roots:
        kids = [s for s in spans if s.parent == root.id]
        assert [k.name for k in kids] == (
            ["repro_torch.serve.prefill"]
            + ["repro_torch.serve.decode_step"] * (steps - 1))
        assert [k.attrs.get("step") for k in kids[1:]] == \
            list(range(1, steps))
        for fwd in kids:
            assert root.start_ns <= fwd.start_ns <= fwd.end_ns <= root.end_ns
            phases = [s.name for s in spans if s.parent == fwd.id]
            assert phases == PHASES * moe_layers
    for s in spans:
        assert s.ms == s.host_ms > 0            # the CPU: host durations
        if s.parent is not None:
            assert by_id[s.parent].start_ns <= s.start_ns


def test_pairs_kept_equals_a_plain_recount():
    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"),
                              moe_capacity_factor=0.5)
    g = torch.Generator().manual_seed(3)
    params = {k: torch.randn(shape, generator=g) * 0.2
              for k, (shape, _) in moe.moe_param_specs(cfg).items()}
    x = torch.randn(2, 40, cfg.d_model, generator=g)
    t = x.shape[0] * x.shape[1]
    _, ids, _ = moe._route(params, x.reshape(t, cfg.d_model), cfg)
    cap = moe.expert_capacity(t, cfg)
    per_expert = defaultdict(int)
    for e in ids.reshape(-1).tolist():
        per_expert[e] += 1
    kept = sum(min(c, cap) for c in per_expert.values())
    _profiled(lambda: moe.moe_ffn(params, x, cfg))
    counters = tracing.collect().counters
    assert counters["repro_torch.moe.pairs_routed"] == t * cfg.moe_top_k
    assert counters["repro_torch.moe.pairs_kept"] == kept
    assert kept < t * cfg.moe_top_k             # the capacity drops pairs


def _plain_kept(ids: list, n_local: int, first: int, cap: int, m: int,
                before: dict) -> int:
    """Pairs kept by a process whose experts are ``first .. first +
    n_local - 1``: each expert's pairs in pair order, after ``before[e]``
    of earlier shards' pairs, up to ``cap`` of them, within the first
    ``m`` positions of its own pairs sorted by expert."""
    mine = [e - first for e in ids if first <= e < first + n_local]
    per = [mine.count(j) for j in range(n_local)]
    kept = 0
    for j, c in enumerate(per):
        start = sum(per[:j])
        kept += max(0, min(c, cap - before.get(j + first, 0), m - start))
    return kept


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)])
def test_pairs_kept_on_a_mesh_equals_a_plain_recount(shape):
    """Expert parallelism over ``model`` (each data shard routed alone)
    and, at (2, 1), the dense dispatch over ``data`` (routed as the whole
    batch), on CPU ranks."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch import mesh

    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"),
                              moe_capacity_factor=0.5)
    g = torch.Generator().manual_seed(5)
    params = {k: (torch.randn(shape_, generator=g) * 0.2).numpy()
              for k, (shape_, _) in moe.moe_param_specs(cfg).items()}
    x = torch.randn(4, 24, cfg.d_model, generator=g).numpy()
    outs = mesh.spawn(ranks.moe_pairs, shape[0] * shape[1], "cpu", cfg,
                      params, x, shape, timeout_s=120.0)
    k, e = cfg.moe_top_k, cfg.n_experts
    t = x.shape[0] // shape[0] * x.shape[1]
    shards = {o["coord"][0]: o["ids"].reshape(-1).tolist() for o in outs}
    for o in outs:
        di, mi = o["coord"]
        ids = shards[di]
        if shape[1] > 1:
            n_local = e // shape[1]
            cap = moe.expert_capacity(t, cfg)
            want = _plain_kept(ids, n_local, mi * n_local, cap,
                               min(n_local * cap, t * k), {})
            routed = sum(mi * n_local <= i < (mi + 1) * n_local
                         for i in ids)
        else:
            cap = moe.expert_capacity(t * shape[0], cfg)
            earlier = [i for d in range(di) for i in shards[d]]
            want = _plain_kept(ids, e, 0, cap, t * k,
                               {j: earlier.count(j) for j in range(e)})
            routed = t * k
        assert o["counters"] == {"repro_torch.moe.pairs_routed": routed,
                                 "repro_torch.moe.pairs_kept": want}
        assert 0 < want < routed


def test_counters_sum_and_defer_their_work(tracer):
    calls = []

    def later():
        calls.append(1)
        return torch.tensor([2, 3])

    def record():
        tracing.count("c", 4)
        tracing.count("c", torch.tensor([1, 1]))
        tracing.count("c", later)
        assert not calls
    _profiled(record)
    assert tracing.collect().counters == {"c": 11}
    assert calls == [1]


def test_power_event_gives_its_three_spans():
    snap, router = serve.make_fleet(H100_HOST, 2)
    _profiled(lambda: serve.power_event(snap, router, 6, "cpu"))
    spans = tracing.collect().spans
    assert [(s.name, s.parent) for s in spans] == [
        ("repro_torch.power.event", None),
        ("repro_torch.power.invocation", spans[0].id),
        ("repro_torch.power.route", spans[0].id)]


def test_profiler_events_lie_within_the_tracer_intervals(models):
    cfg, params = models["olmoe_1b_7b"]
    _, prof = _profiled(
        lambda: serve_loop.generate(cfg, params, _prompt(cfg), 3, 16))
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch."):
            assert e.is_user_annotation()
            events[e.name()].append(e)
    spans = tracing.collect().spans
    mine = defaultdict(list)
    for s in spans:
        mine[s.name].append(s)
    assert {k: len(v) for k, v in mine.items()} == \
        {k: len(v) for k, v in events.items()}
    for name, ss in mine.items():
        es = sorted(events[name], key=lambda e: e.start_ns())
        for s, e in zip(ss, es):
            assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns


@pytest.mark.parametrize("between", ["unprofiled call", "collect"])
def test_collect_returns_the_latest_session_alone(models, between):
    cfg, params = models["granite_8b"]
    _profiled(lambda: serve_loop.generate(cfg, params, _prompt(cfg), 3, 16))
    if between == "collect":
        assert len(tracing.collect().spans) == 4
    else:
        serve_loop.generate(cfg, params, _prompt(cfg), 3, 16)
    _profiled(lambda: serve_loop.generate(cfg, params, _prompt(cfg), 2, 16))
    spans = tracing.collect().spans
    assert [s.name for s in spans] == ["repro_torch.serve.generate",
                                       "repro_torch.serve.prefill",
                                       "repro_torch.serve.decode_step"]
    assert spans[0].attrs["steps"] == 2
