"""Cells, configurations, mixes and per-layer readers are found by name;
one added as files alone, in a temporary checkout, is found the same way.
The generator gives every seed the same lengths in another order, and the
configuration files state what the port runs."""

import json
import re
from collections import Counter

import smoke_root
import pytest

from cpcbench import gen, spec
from cpcbench.harness import Port

BENCH = json.loads((smoke_root.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = spec.find_cell(name)
    assert cell.chips == 1
    assert cell.config["reduced"] == []
    assert cell.cell["requests_per_replica"] > 0
    assert {m["name"] for m in cell.end_to_end} == {
        "tokens_per_s", "request_p95_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert ("k7_roofline_pct" in names) == name.startswith("olmoe")
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("name", sorted({w["config"]
                                         for w in BENCH["workloads"]}))
def test_config_file_is_what_the_port_runs(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = json.loads((smoke_root.ROOT / entry["file"]).read_text())
    port = Port(config)                      # raises where they differ
    assert port.cfg.param_dtype == config["run_as"]["param_dtype"]
    bad = dict(config, run_as=dict(config["run_as"], d_model=1))
    with pytest.raises(ValueError):
        Port(bad)


def test_a_cell_added_as_files_alone(tmp_path):
    root = smoke_root.make_root(tmp_path)
    (root / "cpcbench" / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 2.0 * run\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "new_metric", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "serve loop",
        "moves": "tokens_per_s", "workloads": ["olmoe_smoke.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("olmoe_smoke.tiny", root)
    assert cell.config["arch"] == "olmoe_1b_7b"
    assert cell.mix["output_tokens"] == 3
    assert cell.reader("new_metric")(4) == 8.0
    other = spec.find_cell("granite_smoke.tiny", root)
    assert "new_metric" not in {m["name"] for m in other.per_layer}
    with pytest.raises(KeyError):
        spec.find_cell("no_such.cell", root)


@pytest.mark.parametrize("mix", ["long_prompt", "short_prompt"])
def test_every_seed_sends_the_same_lengths(mix):
    m = json.loads((smoke_root.HERE / "traffic" / f"{mix}.json").read_text())
    rounds = len(gen.pairs(m["prompt_lengths"]))
    pair_sum = min(m["prompt_lengths"]) + max(m["prompt_lengths"])
    orders, sides = set(), set()
    for seed in (0, 1, 2**31 + 77, 2**33 + 5):
        for cycle in range(3):
            got = [gen.round_lengths(m, seed, cycle * rounds + i)
                   for i in range(rounds)]
            assert all(a + b == pair_sum for a, b in got)
            lengths = [s for pair in got for s in pair]
            want = Counter(m["prompt_lengths"])
            want.update(s for s in m["prompt_lengths"] if 2 * s == pair_sum)
            assert Counter(lengths) == want
            orders.add(tuple(got))
            sides.update((i, a > b) for i, (a, b) in enumerate(got))
    assert len(orders) > 1
    # Either replica is sent the longer of a pair: no length is tied to
    # a host.
    assert {longer for _, longer in sides} == {True, False}


def test_prompts_come_from_the_seed():
    a = gen.prompts(2**31 + 9, 3, 1, 4, 7, 100, "cpu")
    assert a.shape == (4, 7) and int(a.max()) < 100
    assert gen.prompts(2**31 + 9, 3, 1, 4, 7, 100, "cpu").equal(a)
    assert not gen.prompts(2**31 + 10, 3, 1, 4, 7, 100, "cpu").equal(a)
    assert not gen.prompts(2**31 + 9, 3, 0, 4, 7, 100, "cpu").equal(a)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 for x in layers)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert (smoke_root.ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (smoke_root.HERE / "metrics" / f"{m['name']}.py").is_file()
