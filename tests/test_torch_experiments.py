"""The paper's evaluation on the port against the JAX package's.

Table II (``deployment_table``) must equal the reference's rows exactly.
Every scenario (``headroom``, ``standby``, ``flexible``) under every
policy runs on the port's legacy per-object engine and its vector engine
(on the CPU: the plain versions of the kernels) and is held against the
reference's legacy engine: exact counts and event strings, payload,
demand, memory and energy (and their window twins) within 1e-9 relative,
the same tags.  The reference's own claims about the three tables
(``tests/test_sim_experiments.py``) are asserted again on the port's
results, and the Table III-V lines are EXPERIMENTS.md's.  The one-host
allocations (``waterfill``, ``divvy``, ``deliver``) are held against the
reference's scalar waterfill at its own bar between its batched and
scalar primitives (``tests/test_vector_parity.py``).
"""

import numpy as np
import pytest
import torch

from repro.core.power_model import PAPER_HOST as REF_HOST
from repro.core.power_model import deployment_table as ref_deployment_table
from repro.drs import entitlement as ref_ent
from repro.drs.snapshot import VirtualMachine as RefVM
from repro.sim import experiments as ref_exp
from repro_torch.core.power_model import PAPER_HOST, deployment_table
from repro_torch.drs import entitlement
from repro_torch.drs.snapshot import VirtualMachine
from repro_torch.sim import experiments
from repro_torch.sim.metrics import ratio_table

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
RTOL = 1e-9
SCENARIOS = ("headroom", "standby", "flexible")
ENGINES = ("legacy", "vector")

#: EXPERIMENTS.md's Tables II-V, as ``benchmarks/run.py`` prints them.
TABLE2 = ("400W:20hosts/cpu1.00/mem1.00;320W:25hosts/cpu1.25/mem1.25;"
          "285W:28hosts/cpu1.09/mem1.40;250W:32hosts/cpu0.90/mem1.60")
TABLES = {
    "headroom": "cpc:cpu0.99/vmo0;static:cpu0.99/vmo4;statichigh:cpu1.00/vmo0",
    "standby": "cpc:cpu1.00/vmo10/pow1.00;static:cpu1.00/vmo20/pow1.07;"
               "statichigh:cpu1.00/vmo10/pow1.00",
    "flexible": "cpc:cpu1.25/mem1.30/trd1.00;static:cpu1.14/mem1.30/trd0.64;"
                "statichigh:cpu1.00/mem1.00/trd1.00",
}


@pytest.fixture(autouse=True)
def deterministic():
    """Every per-host sum of the port must be order-stable (no atomics)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


_REF: dict = {}
_PORT: dict = {}


def reference(scenario: str, policy: str):
    """The reference's legacy engine, once per module."""
    if (scenario, policy) not in _REF:
        _REF[scenario, policy] = ref_exp.run_policy(scenario, policy)
    return _REF[scenario, policy]


def port(scenario: str, policy: str, engine: str):
    if (scenario, policy, engine) not in _PORT:
        _PORT[scenario, policy, engine] = experiments.run_policy(
            scenario, policy, engine=engine, device="cpu")
    return _PORT[scenario, policy, engine]


def table_line(scenario: str, engine: str) -> str:
    """``benchmarks/run.py``'s Table III, IV or V line of the port's
    results."""
    res = {p: port(scenario, p, engine) for p in experiments.POLICIES}
    t = ratio_table({k: v.acc for k, v in res.items()}, "statichigh")
    if scenario == "headroom":
        cells = (f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                 f"/vmo{t[p]['vmotions']}" for p in experiments.POLICIES)
    elif scenario == "standby":
        cells = (f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                 f"/vmo{t[p]['vmotions']}/pow{t[p]['power_ratio']:.2f}"
                 for p in experiments.POLICIES)
    else:
        cells = (f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                 f"/mem{t[p]['mem_payload_ratio']:.2f}"
                 f"/trd{res[p].acc.tag_satisfaction('trading'):.2f}"
                 for p in experiments.POLICIES)
    return ";".join(cells)


def _assert_acc(got, want):
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    assert got.tag_payload.keys() == want.tag_payload.keys()
    assert got.tag_demand.keys() == want.tag_demand.keys()
    for tag in want.tag_payload:
        np.testing.assert_allclose(got.tag_payload[tag],
                                   want.tag_payload[tag], rtol=RTOL)
        np.testing.assert_allclose(got.tag_demand[tag],
                                   want.tag_demand[tag], rtol=RTOL)


# ---------------------------------------------------------------- Table II
def test_deployment_table_equals_the_reference():
    caps = [400, 320, 285, 250]
    got = deployment_table(PAPER_HOST, 8000.0, caps)
    assert got == ref_deployment_table(REF_HOST, 8000.0, caps)
    line = ";".join(f"{int(r['power_cap_w'])}W:{r['host_count']}hosts"
                    f"/cpu{r['capacity_ratio']:.2f}"
                    f"/mem{r['memory_ratio']:.2f}" for r in got)
    assert line == TABLE2


# ------------------------------------------------------- Tables III, IV, V
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", experiments.POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_matches_reference_legacy_engine(scenario, policy, engine):
    want = reference(scenario, policy)
    got = port(scenario, policy, engine)
    _assert_acc(got.acc, want.acc)
    assert (got.window_acc is None) == (want.window_acc is None)
    if want.window_acc is not None:
        _assert_acc(got.window_acc, want.window_acc)
    assert got.events == want.events
    assert got.final.hosts.keys() == want.final.hosts.keys()
    for hid, host in want.final.hosts.items():
        assert got.final.hosts[hid].powered_on == host.powered_on
        np.testing.assert_allclose(got.final.hosts[hid].power_cap,
                                   host.power_cap, rtol=RTOL)
    assert {v: vm.host_id for v, vm in got.final.vms.items()} == {
        v: vm.host_id for v, vm in want.final.vms.items()}


@pytest.mark.parametrize("engine", ENGINES)
def test_headroom_timeline_matches_reference(engine):
    want, got = reference("headroom", "cpc"), port("headroom", "cpc", engine)
    assert len(got.timeline) == len(want.timeline) == 210
    for (tg, hg), (tw, hw) in zip(got.timeline, want.timeline):
        assert tg == tw and hg.keys() == hw.keys()
        for hid in hw:
            (cg, ug, ng), (cw, uw, nw) = hg[hid], hw[hid]
            assert ng == nw
            np.testing.assert_allclose([cg, ug], [cw, uw], rtol=RTOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_table_lines_match_experiments_md(scenario, engine):
    assert table_line(scenario, engine) == TABLES[scenario]


# --------------------------------- the reference's claims, on the port
@pytest.mark.parametrize("engine", ENGINES)
def test_headroom_claims(engine):
    res = {p: port("headroom", p, engine) for p in experiments.POLICIES}
    assert res["cpc"].acc.vmotions == 0
    assert res["cpc"].acc.cap_changes > 0
    assert res["static"].acc.vmotions >= 3
    assert res["statichigh"].acc.vmotions == 0
    t = ratio_table({k: v.acc for k, v in res.items()}, "statichigh")
    assert t["cpc"]["cpu_payload_ratio"] >= \
        t["static"]["cpu_payload_ratio"] - 1e-6
    assert t["cpc"]["cpu_payload_ratio"] >= 0.97
    assert any("host0" in e for _, e in res["cpc"].events
               if e.startswith("cap"))


@pytest.mark.parametrize("engine", ENGINES)
def test_standby_claims(engine):
    res = {p: port("standby", p, engine) for p in experiments.POLICIES}
    for p in experiments.POLICIES:
        assert res[p].acc.power_offs == 1
    assert res["cpc"].acc.power_ons == 0
    assert res["cpc"].acc.vmotions == 10
    assert res["static"].acc.power_ons == 1
    assert res["static"].acc.vmotions > 10
    t = ratio_table({k: v.acc for k, v in res.items()}, "statichigh")
    assert t["static"]["power_ratio"] > 1.02
    assert abs(t["cpc"]["power_ratio"] - 1.0) < 0.02
    assert any("=320W" in e for _, e in res["cpc"].events if "cap" in e)


@pytest.mark.parametrize("engine", ENGINES)
def test_flexible_claims(engine):
    res = {p: port("flexible", p, engine) for p in experiments.POLICIES}
    assert res["cpc"].acc.tag_satisfaction("trading") >= 0.97
    assert 0.55 <= res["static"].acc.tag_satisfaction("trading") <= 0.72
    t = ratio_table({k: v.acc for k, v in res.items()}, "statichigh")
    assert t["cpc"]["mem_payload_ratio"] > 1.2
    assert t["static"]["mem_payload_ratio"] > 1.2
    assert t["cpc"]["cpu_payload_ratio"] > t["static"]["cpu_payload_ratio"]
    assert t["cpc"]["cpu_payload_ratio"] > 1.2


def test_run_all_runs_every_policy_on_the_cpu():
    res = experiments.run_all("headroom", engine="legacy", device="cpu")
    assert list(res) == list(experiments.POLICIES)
    for p, r in res.items():
        _assert_acc(r.acc, reference("headroom", p).acc)


# ------------------------------------------------- one-host allocations
def _rows(seed: int, n_rows: int = 50):
    """Random one-host rows as ``tests/test_vector_parity.py`` draws them,
    degenerate ones (floors above the capacity) and empty ones included."""
    rng = np.random.RandomState(seed)
    for _ in range(n_rows):
        k = rng.randint(0, 10)
        floors = rng.uniform(0.0, 3000.0, k)
        ceils = floors + rng.uniform(0.0, 9000.0, k)
        weights = rng.uniform(1.0, 4000.0, k)
        yield float(rng.uniform(0.0, 30000.0)), floors, ceils, weights


@pytest.mark.parametrize("seed", (42, 7))
def test_waterfill_matches_reference_scalar(seed):
    for cap, floors, ceils, weights in _rows(seed):
        got = entitlement.waterfill(cap, floors, ceils, weights,
                                    device="cpu")
        want = ref_ent.waterfill(cap, floors, ceils, weights)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-6)


def _vms(module_vm, seed: int, n: int):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        vm = module_vm(vm_id=f"vm{i}", vcpus=2, memory_mb=8 * 1024,
                       host_id="h0",
                       reservation=float(rng.choice([0.0, 500.0, 1500.0])),
                       limit=float(rng.choice([np.inf, 2500.0])),
                       shares=float(rng.choice([1000.0, 2000.0, 4000.0])))
        vm.demand = float(rng.uniform(0.0, 4000.0))
        vm.mem_demand = float(rng.uniform(0.0, 8192.0))
        out.append(vm)
    return out


@pytest.mark.parametrize("fn", ("divvy", "deliver"))
@pytest.mark.parametrize("seed", range(4))
def test_divvy_and_deliver_match_reference(fn, seed):
    vms, ref_vms = _vms(VirtualMachine, seed, 9), _vms(RefVM, seed, 9)
    for cap in (0.0, 3000.0, 12_000.0, 40_000.0):
        got = getattr(entitlement, fn)(cap, vms, device="cpu")
        want = getattr(ref_ent, fn)(cap, ref_vms)
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-7, atol=1e-6)
    assert getattr(entitlement, fn)(1000.0, [], device="cpu") == {}


def test_one_host_allocations_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entitlement.waterfill(100.0, [0.0], [50.0], [1.0])
