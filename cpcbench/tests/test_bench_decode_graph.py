"""``decode_graph_pct`` in traced runs of the harness on the CPU: 0 where
every decode step runs eagerly (the CPU's path), 100 where each is a
replay, with every span metric still read (the graph replaced by a
stand-in that re-runs the captured step), and nothing from a program
that counts no replays."""

import sys
import time

import smoke_root
import pytest

from cpcbench import harness, spec
from repro_torch.runtime import decode_graph, tracing

CELLS = ["granite_smoke.tiny", "olmoe_smoke.tiny"]
SEED = 2**31 + 979
SPANS = {"prefill_ms", "decode_step_ms", "prefill_host_pct",
         "decode_host_pct", "cap_invocation_ms"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root.make_root(tmp_path_factory.mktemp("checkout"))


def traced(root, name) -> dict:
    out = harness.run(spec.find_cell(name, root), SEED, 0.2, True, "cpu",
                      time.perf_counter(), say=lambda _: None)
    assert out["correct"], out["checks"]
    return {k: v["value"] for k, v in out["metrics"].items()}


class _Replayed:
    """Replays by re-running the captured step; the capture's own run is
    the first replay.  A replay's Python effects are held back."""

    def __init__(self, step, out, template):
        self.step, self.out, self.template, self.runs = step, out, template, 0

    def replay(self):
        self.runs += 1
        if self.runs == 1:
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


def _capture(step, device):
    with tracing.captured() as template:
        out = step()
    return _Replayed(step, out, template), out, template, 0.0, 0.0


@pytest.mark.parametrize("name", CELLS)
def test_eager_steps_read_zero(root, name):
    got = traced(root, name)
    assert got["decode_graph_pct"] == 0.0
    assert SPANS <= set(got)


@pytest.mark.parametrize("name", CELLS)
def test_replayed_steps_read_100_and_keep_every_span_metric(
        root, name, monkeypatch):
    monkeypatch.setattr(decode_graph, "takes_graph",
                        lambda state, steps: steps > 1)
    monkeypatch.setattr(decode_graph, "_capture", _capture)
    got = traced(root, name)
    assert got["decode_graph_pct"] == 100.0
    assert SPANS <= set(got)
    if name.startswith("olmoe"):
        assert {"moe_dispatch_ms", "moe_kept_pct"} <= set(got)


def test_a_program_that_counts_no_replays_reports_nothing(root,
                                                          monkeypatch):
    """An older checkout of the program: spans, but no replay counter."""
    real = tracing.count

    def dropping(counter, value):
        if counter != decode_graph.REPLAYS:
            real(counter, value)
    monkeypatch.setattr(tracing, "count", dropping)
    got = traced(root, "granite_smoke.tiny")
    assert "decode_graph_pct" not in got
    assert SPANS <= set(got)


def test_a_program_without_a_tracer_reports_nothing(root, monkeypatch):
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    run = harness.TracedRun(model={"family": "dense", "n_layers": 1},
                            batches=[(1, 4, 2)], wall_s=1.0, launches={},
                            cap_event_ms=1.0)
    assert spec.load_reader("decode_graph_pct", root)(run) is None
