"""The port's cap-only batched engine against the JAX package's engines.

Both packages build the same scenario grid from the same seeds; the port
packs it into the same bytes, and runs it on the CPU (the plain versions
of its kernels).  The bar is the one the reference sets between its own
engines: exact cap-change counts, 1e-9 relative on the float integrals.
"""

import contextlib
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.drs.rules import AffinityRule as RefAffinityRule
from repro.sim import sweep as ref_sweep
from repro.sim.batch import BatchCell as RefCell
from repro.sim.batch import BatchedSimulator as RefSimulator
from repro.sim.experiments import SCENARIOS
from repro_torch.convert import from_reference_pack
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.power_model import PAPER_HOST
from repro_torch.drs.rules import AffinityRule
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim import sweep
from repro_torch.sim.batch import (PACK_KEYS, BatchCell, BatchedSimulator,
                                   BatchUnsupported)
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.workloads import TraceSpec, spec_trace

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
RTOL = 1e-9
GRID = dict(sizes=(6,), spikes=("flat", "burst", "step", "prime"),
            heterogeneous=(False, True), duration_s=600.0)
POLICIES = ("cpc", "static", "statichigh")


@pytest.fixture
def x64(monkeypatch):
    """JAX float64 for the reference, per test (JAX 0.9 dropped
    ``jax.experimental.enable_x64``, which the reference imports)."""
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        with jax.enable_x64(new_val):
            yield

    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)
    yield


def _grids(policies=POLICIES):
    ref_cells, _ = ref_sweep._build_batch_cells(
        ref_sweep.scenario_families(**GRID), policies)
    cells, keys = sweep.build_batch_cells(sweep.scenario_families(**GRID),
                                          policies)
    return ref_cells, cells, keys


@pytest.mark.parametrize("policies", (("cpc",), ("static",),
                                      ("statichigh",), POLICIES))
def test_pack_is_bitwise_the_reference_pack(policies):
    ref_cells, cells, _ = _grids(policies)
    ref = RefSimulator(ref_cells)._arrays
    port = BatchedSimulator(cells, device="cpu")._arrays
    assert set(port) == set(PACK_KEYS) <= set(ref)
    for k in PACK_KEYS:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_grid_matches_jax_batched_simulator(x64):
    ref_cells, cells, _ = _grids()
    want = RefSimulator(ref_cells).run()
    got = BatchedSimulator(cells, device="cpu").run()
    np.testing.assert_array_equal(got.cap_changes, want.cap_changes)
    assert got.cap_changes.dtype == np.int32
    assert got.cap_changes.sum() > 0
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_allclose(got.final_caps, want.final_caps, rtol=RTOL)


def test_grid_matches_vector_simulator():
    specs = sweep.scenario_families(**GRID)
    want = ref_sweep.run_sweep(ref_sweep.scenario_families(**GRID),
                               POLICIES, engine="vector")
    got = sweep.run_sweep(specs, POLICIES, engine="batch", device="cpu")
    for spec in specs:
        for p in POLICIES:
            g, w = got[spec.name][p], want[spec.name][p]
            assert g.cap_changes == w.cap_changes, (spec.name, p)
            for f in ("cpu_payload_mhz_s", "energy_j", "cpu_satisfaction"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL, err_msg=f)


def _paper_cells(scenario):
    """The paper scenario's three policies as reference cells, the spiking
    VMs tagged so the per-tag integrals are exercised too."""
    cells = []
    for policy in POLICIES:
        snap, traces, cfg, window = SCENARIOS[scenario].build(policy)
        for i, vm in enumerate(snap.vms.values()):
            vm.tags = frozenset({"spiky" if i < 10 else "steady"})
        cells.append(RefCell(name=f"{scenario}/{policy}", snapshot=snap,
                             traces=traces, config=cfg,
                             powercap_enabled=(policy == "cpc"),
                             window=window))
    return cells


@pytest.mark.parametrize("scenario", ("headroom", "standby"))
def test_reference_pack_carries_over(x64, scenario):
    ref = RefSimulator(_paper_cells(scenario))
    want = ref.run()
    got = from_reference_pack(ref._arrays, ref._static, device="cpu").run()
    np.testing.assert_array_equal(got.cap_changes, want.cap_changes)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
        np.testing.assert_allclose(got.window_fields[f],
                                   want.window_fields[f], rtol=RTOL,
                                   err_msg=f"window {f}")
    np.testing.assert_array_equal(got.has_window, want.has_window)
    assert got.tag_payload.shape == want.tag_payload.shape == (3, 2)
    np.testing.assert_allclose(got.tag_payload, want.tag_payload, rtol=RTOL)
    np.testing.assert_allclose(got.tag_demand, want.tag_demand, rtol=RTOL)
    if scenario == "headroom":
        assert got.has_window.all() and got.cap_changes[0] > 0


def test_timeseries_fold_is_bitwise_the_reduced_run():
    _, cells, _ = _grids()
    reduced = BatchedSimulator(cells, device="cpu").run()
    full = BatchedSimulator(cells, keep_timeseries=True, device="cpu").run()
    assert full.timeseries["energy_j"].shape == (reduced.ticks, len(cells))
    folded = full.reduced_timeseries()
    for f in FLOATS:
        np.testing.assert_array_equal(folded[f], getattr(reduced, f))
        np.testing.assert_array_equal(getattr(full, f), getattr(reduced, f))
    np.testing.assert_array_equal(folded["cap_changes"], reduced.cap_changes)


def _cell(name="c", **kw):
    hosts = [Host(f"host{i}", PAPER_HOST, power_cap=250.0) for i in range(2)]
    vms = [VirtualMachine(f"vm{i}", host_id=f"host{i % 2}") for i in range(4)]
    traces = {v.vm_id: spec_trace(TraceSpec(((0.0, 1000.0, 2048.0),)))
              for v in vms}
    snap = ClusterSnapshot(hosts, vms, power_budget=500.0,
                           rules=kw.pop("rules", None),
                           budget_tree=kw.pop("budget_tree", None))
    cfg = SimConfig(duration_s=600.0, power_events=kw.pop("events", ()),
                    tick_s=kw.pop("tick_s", 10.0))
    return BatchCell(name=name, snapshot=snap, traces=traces, config=cfg,
                     **kw)


@pytest.mark.parametrize("bad", (
    dict(dpm_enabled=True),                  # ungated timed migrations
    dict(events=((300.0, "host9", False),)),  # an unknown host
    # A budget tree with placement rules (the reference refuses it too).
    dict(rules=[AffinityRule(("vm0", "vm2"))],
         budget_tree=BudgetTree([-1, 0, 0], [500.0, 200.0, 400.0], [1, 2])),
    dict(tick_s=20.0),
))
def test_unsupported_cells_raise(bad):
    with pytest.raises(BatchUnsupported):
        BatchedSimulator([_cell("ok"), _cell("bad", **bad)], device="cpu")


def test_spec_less_traces_raise():
    cell = _cell()
    cell.traces = {vid: (lambda t: (1.0, 1.0)) for vid in cell.traces}
    with pytest.raises(BatchUnsupported):
        BatchedSimulator([cell], device="cpu")


@pytest.mark.parametrize("field", (dict(churn="timed_churn"),
                                   dict(rules="violation_burst"),
                                   dict(churn="failure_cascade")))
def test_unported_sweep_families_raise(field):
    """The migration families run on both of the port's engines as on the
    reference's vector engine (8 hosts, cpc and static): exact counts,
    payload and energy to 1e-9."""
    kw = dict(name="s", n_hosts=8, duration_s=1500.0, tick_s=15.0, **field)
    policies = ("cpc", "static")
    want = {p: ref_sweep.run_cell(ref_sweep.SweepSpec(**kw), p)
            for p in policies}
    spec = sweep.SweepSpec(**kw)
    for engine in ("batch", "vector"):
        got = sweep.run_sweep([spec], policies, engine=engine, device="cpu")
        for p in policies:
            g, w = got["s"][p], want[p]
            for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
                assert getattr(g, f) == getattr(w, f), (engine, p, f)
            for f in ("cpu_payload_mhz_s", "energy_j"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL, err_msg=(engine, p))
    assert sum(w.vmotions for w in want.values()) > 0


def test_dynamic_reference_pack_raises(x64):
    """A pack of the reference's migration layer (an affinity rule violated
    at the start compiles constraint correction in) carries over and runs
    as the reference's batched engine runs it."""
    cell = _paper_cells("headroom")[0]
    first = {}
    for v in cell.snapshot.vms.values():
        first.setdefault(v.host_id, v.vm_id)
    hosts = sorted(first)
    cell.snapshot.rules = [RefAffinityRule((first[hosts[0]],
                                            first[hosts[1]]))]
    cell.config = dataclasses.replace(cell.config, instant_migrations=True)
    ref = RefSimulator([cell])
    assert ref._static.migration and ref._static.rules.n_groups == 1
    want = ref.run()
    got = from_reference_pack(ref._arrays, ref._static, device="cpu").run()
    for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_array_equal(got.final_occ, want.final_occ)
    assert want.vmotions[0] == 1


# ------------------------------------------------------------- churn grids
#: ``sweep_grid_dpm``'s grid (``benchmarks/run.py``), cut to a host count.
def _dpm_grid(n, churns=("none", "dpm", "maintenance", "failure")):
    return dict(sizes=(n,), budgets_per_host_w=(250.0,),
                spikes=("burst", "prime"), heterogeneous=(False, True),
                churns=churns, duration_s=1500.0, tick_s=15.0)


def _final_on(module, spec, policy, **kw):
    """The vector engine's final power states for one cell of ``module``'s
    sweep (the reference's or the port's)."""
    snap, traces, cfg = module.build_sweep(spec, policy)
    manager = module._sweep_manager(policy, spec=spec, **kw)
    if module is sweep:
        from repro_torch.sim.engine import VectorSimulator
        sim = VectorSimulator(snap, manager, traces, cfg, device="cpu")
    else:
        from repro.sim.engine import VectorSimulator as RefVector
        sim = RefVector(snap, manager, traces, cfg)
    return np.array([h.powered_on for h in sim.run().final.hosts.values()])


@pytest.fixture
def deterministic():
    """Every per-host sum of the port must be order-stable (no atomics)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _hold_churn_grid(grid):
    """The grid through both batched engines at ``slot_slack`` 1.5 (the
    benchmark's): exact counts, 1e-9 floats, equal final states.

    One kind of cell is a tie, not a decision: in a homogeneous ``dpm``
    cell under cpc, BalancePowerCap equalizes every host's utilization to
    within rounding (a spread of about 1e-16), so DPM's power-off victim
    is whichever host rounds lowest.  There the reference's own vector and
    batched engines pick different hosts; counts and integrals still
    agree (the hosts are alike), and the port's two engines must pick the
    same host as each other."""
    specs = sweep.scenario_families(**grid)
    policies = ("cpc", "static")
    ref_cells, _ = ref_sweep._build_batch_cells(
        ref_sweep.scenario_families(**grid), policies)
    want = RefSimulator(ref_cells, slot_slack=1.5).run()
    cells, keys = sweep.build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=1.5, device="cpu")
    got = sim.run()
    for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    assert want.power_offs.sum() > 0 and want.power_ons.sum() > 0
    assert want.vmotions.sum() > 0
    assert sim.info["branch_reads"] == sim.info["ticks"] == got.ticks
    ref_specs = {s.name: s for s in ref_sweep.scenario_families(**grid)}
    ties = 0
    for i, (spec, p) in enumerate(keys):
        if spec.churn == "dpm" and not spec.heterogeneous and p == "cpc":
            ties += 1
            ref_vec = _final_on(ref_sweep, ref_specs[spec.name], p)
            assert not np.array_equal(ref_vec, want.final_on[i])
            np.testing.assert_array_equal(
                _final_on(sweep, spec, p, device="cpu"), got.final_on[i])
            continue
        np.testing.assert_array_equal(got.final_on[i], want.final_on[i])
        np.testing.assert_array_equal(got.final_occ[i], want.final_occ[i])
        np.testing.assert_allclose(got.final_caps[i], want.final_caps[i],
                                   rtol=RTOL)
    assert ties == 2


def test_sweep_grid_dpm_at_10_hosts_matches_reference(x64, deterministic):
    _hold_churn_grid(_dpm_grid(10))


def test_sweep_grid_dpm_cells_at_100_hosts_match_reference(x64,
                                                          deterministic):
    _hold_churn_grid(_dpm_grid(100, churns=("dpm",)))


def test_churn_grid_timeseries_is_bitwise_the_reduced_run():
    specs = sweep.scenario_families(**_dpm_grid(6))
    cells, _ = sweep.build_batch_cells(specs, ("cpc", "static"))
    reduced = BatchedSimulator(cells, slot_slack=3.0, device="cpu").run()
    full = BatchedSimulator(cells, slot_slack=3.0, keep_timeseries=True,
                            device="cpu").run()
    folded = full.reduced_timeseries()
    for f in FLOATS:
        np.testing.assert_array_equal(getattr(full, f), getattr(reduced, f))
        np.testing.assert_array_equal(folded[f], getattr(reduced, f))
    for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
        np.testing.assert_array_equal(full.timeseries[f].sum(0),
                                      getattr(reduced, f))
    np.testing.assert_array_equal(full.final_occ, reduced.final_occ)


def test_churn_grid_with_slot_slack_1_raises():
    # The exact pack: ``run_sweep``'s pad buckets round 10 VMs a host up
    # to 16 slots, which leaves the evacuations room at slack 1.0.
    specs = sweep.scenario_families(**_dpm_grid(10, churns=("dpm",)))
    with pytest.raises(RuntimeError, match="slot_slack"):
        sweep.run_sweep_batched(specs, ("cpc", "static"), device="cpu",
                                slot_slack=1.0)
