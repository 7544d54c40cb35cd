"""Whole runs of the harness on the CPU at the port's CPU-sized widths,
with the look for a card skipped: a sound run is correct, and each fault
that a serving cell can have, planted in the timed path, and the control
(the reference in float8 in the program's place) come out not correct."""

import time
from collections import Counter

import smoke_root
import pytest
import torch

from cpcbench import check, harness, spec
from repro_torch.launch import serve
from repro_torch.runtime import serve_loop

CELLS = ["granite_smoke.tiny", "olmoe_smoke.tiny"]
SEED = 2**31 + 4321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root.make_root(tmp_path_factory.mktemp("checkout"))


def run(root, name, trace=False, seconds=0.2):
    return harness.run(spec.find_cell(name, root), SEED, seconds, trace,
                       "cpu", time.perf_counter(), say=lambda _: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(root, name):
    out = run(root, name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"tokens_per_s", "request_p95_s",
                                   "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(root, name):
    out = run(root, name, trace=True)
    assert out["correct"], out["checks"]
    # The CPU has no kernels: the trace-only readers find nothing.
    assert {"cap_event_ms", "mfu_pct", "idle_pct"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]


def _decode_state_unchanged(real):
    def make(cfg, sample="greedy"):
        step = real(cfg, sample)

        def decode(params, state, tokens):
            logits, _ = step(params, state, tokens)
            return logits, state
        return decode
    return make


def _token_altered(real):
    def argmax(logits, vocab):
        out = real(logits, vocab).clone()
        out[0] = (out[0] + 1) % vocab
        return out
    return argmax


def _half_batch(real):
    def generate(cfg, params, prompt, steps, max_len, **kw):
        half = max(1, prompt.shape[0] // 2)
        tokens, logits = real(cfg, params, prompt[:half], steps, max_len,
                              **kw)
        idx = torch.arange(prompt.shape[0]) % half
        return tokens[idx], logits[idx]
    return generate


def _no_invocation(snap, router, n_requests, device=None):
    snap.hosts["h0"].power_cap *= 0.5
    router.sync_capacities(snap)

    class Result:
        snapshot = snap
    return serve._count(router.route(n_requests)), [], Result


def _equal_weights(real):
    def sync(self, snapshot):
        real(self, snapshot)
        self.capacity = {r: 1.0 for r in self.capacity}
    return sync


FAULTS = {
    "decode step returns its state unchanged":
        (serve_loop, "make_decode_step", _decode_state_unchanged),
    "a served token altered where it is produced":
        (serve_loop, "vocab_argmax", _token_altered),
    "half of each batch left out": (serve_loop, "generate", _half_batch),
    "the cap event runs no manager invocation":
        (serve, "power_event", lambda real: _no_invocation),
    "the router ignores the caps":
        (serve_loop.CapacityAwareRouter, "sync_capacities", _equal_weights),
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(root, name, fault, monkeypatch):
    owner, attr, plant = FAULTS[fault]
    monkeypatch.setattr(owner, attr, plant(getattr(owner, attr)))
    out = run(root, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(root, name):
    """The reference in float8 in the program's place fails the limits
    that the program meets, by three times and more."""
    cell = spec.find_cell(name, root)
    port = harness.Port(cell.config)
    params = harness.setup(port, cell, SEED, "cpu", False)
    win = harness.run_window(port, cell, params, SEED, 0.2, "cpu")
    sound = check.model_numbers(port, cell, win, SEED, "cpu")
    control = check.model_numbers(port, cell, win, SEED, "cpu", control=True)
    correct, _ = check.judge(control, cell.cell["limits"])
    assert not correct
    assert control["logit_rel_l2"] > 3 * sound["logit_rel_l2"]


def _offer_all(cell: dict, lengths: list, seed: int) -> tuple:
    sample = check.Sample(spec.Cell("c", 1, {}, {}, cell, [], [], None), seed)
    batches = []
    for k, s in enumerate(lengths):
        b = harness.Batch(k // 2, k % 2, 16, s, 1.0, torch.zeros(16, 3), 0)
        b.rows = sample.offer(b)
        if b.rows is not None:
            b.logits = torch.zeros(len(b.rows), 3, 5)
        batches.append(b)
    return sample, batches


@pytest.mark.parametrize("cell, rows", [({"check_rows": 8}, 8), ({}, 16)])
def test_sample_is_the_longest_and_one_drawn_from_the_rest(cell, rows):
    """The check reads a batch at the longest prompt and one drawn
    uniformly from every other batch of the window, whatever its length
    and replica; the window keeps the logits of those alone."""
    lengths = [20, 8, 12, 16, 8, 20, 16, 12, 24, 8, 12, 16]
    drawn = Counter()
    for seed in range(400):
        sample, batches = _offer_all(cell, lengths, 2**31 + seed)
        checked = sample.batches()
        assert checked[0].length == 24 and len(checked) == 2
        assert checked[1].length < 24
        assert all(len(b.rows) == rows == b.logits.shape[0] for b in checked)
        assert [b for b in batches if b.logits is not None] == sorted(
            checked, key=lambda b: batches.index(b))
        drawn[batches.index(checked[1])] += 1
    assert set(drawn) == set(range(len(lengths))) - {8}
    assert min(drawn.values()) > 400 / 11 / 3
