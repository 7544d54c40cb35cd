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

from repro.sim import sweep as ref_sweep
from repro.sim.batch import BatchCell as RefCell
from repro.sim.batch import BatchedSimulator as RefSimulator
from repro.sim.experiments import SCENARIOS
from repro_torch.convert import from_reference_pack
from repro_torch.core.power_model import PAPER_HOST
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
    got = sweep.run_sweep(specs, POLICIES, device="cpu")
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
                           rules=kw.pop("rules", None))
    cfg = SimConfig(duration_s=600.0, power_events=kw.pop("events", ()),
                    tick_s=kw.pop("tick_s", 10.0))
    return BatchCell(name=name, snapshot=snap, traces=traces, config=cfg,
                     **kw)


@pytest.mark.parametrize("bad", (
    dict(dpm_enabled=True),
    dict(events=((300.0, "host0", False),)),
    dict(rules=["vm0 with vm1"]),
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


@pytest.mark.parametrize("field", (dict(churn="dpm"),
                                   dict(rules="violation_burst"),
                                   dict(tree="two_row")))
def test_unported_sweep_families_raise(field):
    spec = sweep.SweepSpec(name="s", n_hosts=4, **field)
    with pytest.raises(BatchUnsupported):
        sweep.run_sweep([spec], device="cpu")


def test_dynamic_reference_pack_raises():
    """A pack of the reference's dynamic regime (here: a scripted power
    event) is refused."""
    cell = _paper_cells("headroom")[0]
    cell.config = dataclasses.replace(
        cell.config, power_events=((600.0, "host0", False),))
    ref = RefSimulator([cell])
    with pytest.raises(BatchUnsupported):
        from_reference_pack(ref._arrays, ref._static, device="cpu")
