"""The readers of the port's own spans and counters (``prefill_ms``,
``decode_step_ms``, ``prefill_host_pct``, ``decode_host_pct``,
``moe_dispatch_ms``, ``moe_kept_pct``, ``cap_invocation_ms``) in traced
runs of the harness on the CPU: each is reported where it applies, the
two MoE metrics for OLMoE alone, and none where a span they count is
missing or the program has no tracer."""

import contextlib
import sys
import time

import smoke_root
import pytest

from cpcbench import harness, spec
from repro_torch.runtime import tracing

CELLS = ["granite_smoke.tiny", "olmoe_smoke.tiny"]
SEED = 2**31 + 977
SPANS = {"prefill_ms", "decode_step_ms", "prefill_host_pct",
         "decode_host_pct", "cap_invocation_ms"}
MOE = {"moe_dispatch_ms", "moe_kept_pct"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root.make_root(tmp_path_factory.mktemp("checkout"))


def traced(root, name) -> dict:
    out = harness.run(spec.find_cell(name, root), SEED, 0.2, True, "cpu",
                      time.perf_counter(), say=lambda _: None)
    assert out["correct"], out["checks"]
    return {k: v["value"] for k, v in out["metrics"].items()}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_span_metrics(root, name):
    got = traced(root, name)
    moe = name.startswith("olmoe")
    assert SPANS <= set(got)
    assert (MOE <= set(got)) if moe else not (MOE & set(got))
    assert got["prefill_ms"] > 0 and got["decode_step_ms"] > 0
    # On the CPU a span's stream time is its host time.
    assert got["prefill_host_pct"] == pytest.approx(100.0)
    assert got["decode_host_pct"] == pytest.approx(100.0)
    assert got["cap_invocation_ms"] <= got["cap_event_ms"]
    if moe:
        assert 0 < got["moe_kept_pct"] <= 100
        assert got["moe_dispatch_ms"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_lost_decode_step_span_silences_every_span_metric(
        root, name, monkeypatch):
    real = tracing.span

    def dropping(span_name, **attrs):
        if span_name == "repro_torch.serve.decode_step":
            return contextlib.nullcontext()
        return real(span_name, **attrs)
    monkeypatch.setattr(tracing, "span", dropping)
    got = traced(root, name)
    assert not ((SPANS | MOE) & set(got))
    assert {"cap_event_ms", "mfu_pct", "idle_pct"} <= set(got)


def test_a_program_without_a_tracer_reports_none_of_them(root, monkeypatch):
    """An older checkout of the program, without the tracer: the readers
    find nothing and raise nothing."""
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    run = harness.TracedRun(model={"family": "moe", "n_layers": 1},
                            batches=[(1, 4, 2)], wall_s=1.0, launches={},
                            cap_event_ms=1.0)
    for metric in sorted(SPANS | MOE):
        assert spec.load_reader(metric, root)(run) is None
