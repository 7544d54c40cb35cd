"""``run_sweep``'s pad-bucket front door on the port, against the JAX
package's.

The reference's bar for the bucketed grid against the exact pack
(``tests/test_sharded_parity.py``: equal counts, payload and energy within
1e-12) and its pipeline cases (``tests/test_sweep.py``: the unsupported
partition and its warning, any harvest order giving ``specs x policies``
order) hold on the port; the port's bucketed ``run_sweep`` equals the
reference's on the same grids (exact counts, 1e-9); poisoned host and slot
padding changes no bit (trap T3); more than one device raises without a
process group.
"""

import contextlib
import warnings

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.sim import sweep as ref_sweep
from repro_torch.sim import sweep
from repro_torch.sim.batch import BatchedSimulator, BatchUnsupported

POLICIES = ("cpc", "static")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
RTOL = 1e-9


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


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def hetero_specs(module):
    """``tests/test_sharded_parity.py``'s grid: two pad buckets, (4, 16)
    and (16, 16), with the migration layer live."""
    return [
        module.SweepSpec(name="s4", n_hosts=4, spike="burst",
                         duration_s=600.0, tick_s=30.0),
        module.SweepSpec(name="s4r", n_hosts=4, spike="prime",
                         rules="violation_burst", duration_s=600.0,
                         tick_s=30.0),
        module.SweepSpec(name="s12", n_hosts=12, spike="step",
                         heterogeneous=True, duration_s=600.0, tick_s=30.0),
        module.SweepSpec(name="s10", n_hosts=10, spike="burst",
                         duration_s=600.0, tick_s=30.0),
    ]


def churn_specs(module):
    """A 4/12-host grid with placement rules and DPM: two pad buckets of
    the churn program."""
    return [
        module.SweepSpec(name="r4", n_hosts=4, spike="prime",
                         rules="violation_burst", duration_s=1500.0,
                         tick_s=30.0),
        module.SweepSpec(name="d12", n_hosts=12, churn="dpm",
                         heterogeneous=True, duration_s=1500.0, tick_s=30.0),
        module.SweepSpec(name="f12", n_hosts=12, churn="failure",
                         duration_s=1500.0, tick_s=30.0),
    ]


def mixed_grid_specs(module):
    """``tests/test_sweep.py``'s pipeline grid: buckets (4, 16) and (8, 16)
    and a cell on another time grid."""
    return [module.SweepSpec(name="small", n_hosts=4, spike="burst",
                             duration_s=600.0, tick_s=30.0),
            module.SweepSpec(name="big", n_hosts=8, spike="burst",
                             duration_s=600.0, tick_s=30.0),
            module.SweepSpec(name="odd", n_hosts=4, spike="flat",
                             duration_s=300.0, tick_s=30.0)]


def assert_cells(got, want, names, rtol):
    for name in names:
        for p in POLICIES:
            g, w = got[name][p], want[name][p]
            for f in COUNTS:
                assert getattr(g, f) == getattr(w, f), (name, p, f)
            for f in ("cpu_payload_mhz_s", "energy_j", "cpu_satisfaction"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=rtol, err_msg=f"{name} {p}")


@pytest.mark.parametrize("grid", ("hetero", "churn"))
def test_bucketed_run_sweep_matches_exact_pack(grid):
    specs = (hetero_specs if grid == "hetero" else churn_specs)(sweep)
    bucketed = sweep.run_sweep(specs, POLICIES, engine="batch", device="cpu")
    buckets = [r["bucket"] for r in sweep.LAST_BATCH_INFO]
    assert buckets == [(4, 16), (16, 16)]
    for r in sweep.LAST_BATCH_INFO:
        assert r["n_devices"] == 1 and r["compile_s"] == 0.0
        assert r["wall_s"] == r["run_s"] and r["pack_s"] > 0.0
        assert r["info"]["ticks"] == r["result"].ticks
        assert r["result"].final_caps.shape[1] == r["bucket"][0]
    assert sum(r["n_cells"] for r in sweep.LAST_BATCH_INFO) == \
        len(specs) * len(POLICIES)
    exact = sweep.run_sweep_batched(specs, POLICIES, device="cpu")
    (record,) = sweep.LAST_BATCH_INFO
    assert record["bucket"] == (None, None)
    assert record["result"].final_caps.shape[1] == 12
    assert_cells(bucketed, exact, [s.name for s in specs], 1e-12)
    total = {f: sum(getattr(r, f) for per in exact.values()
                    for r in per.values()) for f in COUNTS}
    assert total["cap_changes"] > 0 and total["vmotions"] > 0
    if grid == "churn":
        assert total["power_offs"] > 0


@pytest.mark.parametrize("grid", ("hetero", "churn"))
def test_run_sweep_matches_reference_run_sweep(x64, grid):
    build = hetero_specs if grid == "hetero" else churn_specs
    got = sweep.run_sweep(build(sweep), POLICIES, engine="batch",
                          device="cpu")
    want = ref_sweep.run_sweep(build(ref_sweep), POLICIES, engine="batch",
                               n_devices=1)
    assert [r["bucket"] for r in sweep.LAST_BATCH_INFO] == [
        tuple(r["bucket"]) for r in ref_sweep.LAST_BATCH_INFO]
    assert_cells(got, want, [s.name for s in build(sweep)], RTOL)


def test_run_sweep_batch_preserves_grid_order():
    specs = hetero_specs(sweep)[::-1]          # the big bucket first
    res = sweep.run_sweep(specs, POLICIES, engine="batch", device="cpu")
    assert list(res) == [s.name for s in specs]
    assert all(list(by_p) == list(POLICIES) for by_p in res.values())
    assert [r["bucket"] for r in sweep.LAST_BATCH_INFO] == [(4, 16),
                                                            (16, 16)]


def test_run_sweep_batch_fallback_partitions_grid():
    specs = [sweep.SweepSpec(name="a", n_hosts=4, spike="flat",
                             duration_s=300.0, tick_s=30.0),
             sweep.SweepSpec(name="b", n_hosts=4, spike="flat",
                             duration_s=600.0, tick_s=30.0)]
    with pytest.raises(BatchUnsupported, match="time grid"):
        sweep.run_sweep(specs, ("cpc",), engine="batch", device="cpu")
    with pytest.warns(RuntimeWarning, match="sequential vector engine"):
        res = sweep.run_sweep(specs, ("cpc",), engine="batch", device="cpu",
                              on_unsupported="fallback")
    assert set(res) == {"a", "b"}
    assert [r["n_cells"] for r in sweep.LAST_BATCH_INFO] == [1]
    for spec in specs:
        ref = sweep.run_sweep([spec], ("cpc",), device="cpu")
        assert res[spec.name]["cpc"].cap_changes == \
            ref[spec.name]["cpc"].cap_changes
        np.testing.assert_allclose(res[spec.name]["cpc"].energy_j,
                                   ref[spec.name]["cpc"].energy_j,
                                   rtol=RTOL)


@pytest.mark.parametrize("order", ("reversed", "shuffled"))
def test_run_sweep_async_completion_order_independent(monkeypatch, order):
    specs = mixed_grid_specs(sweep)
    ref = sweep.run_sweep(specs, POLICIES, device="cpu")
    orders: list = []

    def scrambled(n):
        idx = list(range(n))
        if order == "reversed":
            idx.reverse()
        else:
            np.random.RandomState(0).shuffle(idx)
        orders.append(list(idx))
        return idx

    monkeypatch.setattr(sweep, "_harvest_order", scrambled)
    with pytest.warns(RuntimeWarning, match="sequential vector engine"):
        res = sweep.run_sweep(specs, POLICIES, engine="batch", device="cpu",
                              on_unsupported="fallback")
    assert orders and max(len(o) for o in orders) >= 2
    assert [r["bucket"] for r in sweep.LAST_BATCH_INFO] == [(4, 16),
                                                            (8, 16)]
    assert list(res) == [s.name for s in specs]
    for name in res:
        assert list(res[name]) == list(POLICIES)
    assert_cells(res, ref, [s.name for s in specs], RTOL)


def test_more_than_one_device_raises():
    """Without a process group the world is one rank: two devices raise
    (``tests/test_torch_sharded_sweep.py`` splits grids over ranks)."""
    specs = hetero_specs(sweep)[:1]
    cells, _ = sweep.build_batch_cells(specs, POLICIES)
    for call in (lambda: sweep.run_sweep(specs, POLICIES, engine="batch",
                                         n_devices=2, device="cpu"),
                 lambda: sweep.run_sweep_batched(specs, POLICIES,
                                                 n_devices=2, device="cpu"),
                 lambda: BatchedSimulator(cells, n_devices=2, device="cpu")):
        with pytest.raises(ValueError, match="process group"):
            call()
    assert sweep.run_sweep(specs, POLICIES, engine="batch", n_devices=1,
                           device="cpu")["s4"]["cpc"].cap_changes > 0


def test_run_async_harvests_later():
    specs = hetero_specs(sweep)
    cells, _ = sweep.build_batch_cells(specs, POLICIES)
    sim = BatchedSimulator(cells, pad_hosts=16, pad_slots=16, device="cpu")
    assert sim.compile() == 0.0
    pending = sim.run_async()
    res = pending.result()
    assert res.final_caps.shape == (len(cells), 16)
    assert res.compile_s == 0.0 and res.wall_s == res.run_s
    again = BatchedSimulator(cells, device="cpu").run()
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(res, f), getattr(again, f))
    for f in FLOATS:
        np.testing.assert_allclose(getattr(res, f), getattr(again, f),
                                   rtol=1e-12)


def test_poisoned_padding_changes_nothing():
    """Trap T3 at the pad buckets' shapes: padded hosts that look alive
    (huge capacity, power and caps, occupied slots with huge demand and
    reservations) and padded slots (huge demand and reservations, rule
    columns that would bind) change no count and no bit, with placement
    rules and DPM in the grid."""
    specs = churn_specs(sweep)
    cells, _ = sweep.build_batch_cells(specs, POLICIES)
    kw = dict(slot_slack=3.0, balancer=sweep.grid_balancer(specs),
              device="cpu", pad_hosts=16, pad_slots=16)
    clean = BatchedSimulator(cells, **kw).run()
    dirty = BatchedSimulator(cells, **kw)
    a = dirty._arrays
    pad_host = ~a["exists"]
    assert pad_host[0].sum() == 12 and pad_host[2].sum() == 4
    empty = ~a["occ"]
    for k in ("idle", "peak", "cap_peak", "host_mem", "caps0", "cpu_res"):
        scale = 10.0 if k == "peak" else 1.0
        a[k] = np.where(pad_host, 1e9 * scale, a[k])
    a["occ"] = a["occ"] | pad_host[..., None]
    for k in ("cpu_vals", "mem_vals"):
        a[k] = np.where((empty | pad_host[..., None])[..., None], 1e12, a[k])
    a["reservation"] = np.where(empty, 1e9, a["reservation"])
    a["weights"] = np.where(empty, 1e6, a["weights"])
    if "aff_group" in a:
        a["aff_group"] = np.where(empty, 0, a["aff_group"])
    if "anti" in a:
        a["anti"] = a["anti"] | empty[..., None]
    if "allowed" in a:
        a["allowed"] = a["allowed"] & ~empty[..., None]
    got = dirty.run()
    for f in COUNTS + FLOATS:
        np.testing.assert_array_equal(getattr(got, f), getattr(clean, f))
    # A padded host's cap is its pack's fill, read by nothing.
    np.testing.assert_array_equal(got.final_caps[~pad_host],
                                  clean.final_caps[~pad_host])
    np.testing.assert_array_equal(got.final_on, clean.final_on)
    assert not got.final_on[pad_host].any()
    assert clean.vmotions.sum() > 0 and clean.power_offs.sum() > 0


def test_legacy_engine_runs_single_cells():
    spec = sweep.SweepSpec(name="l6", n_hosts=6, spike="burst",
                           duration_s=600.0, tick_s=30.0)
    legacy = sweep.run_sweep([spec], POLICIES, engine="legacy", device="cpu")
    vector = sweep.run_sweep([spec], POLICIES, device="cpu")
    assert_cells(legacy, vector, [spec.name], RTOL)
    with pytest.raises(ValueError, match="engine"):
        sweep.run_cell(spec, "cpc", engine="batch", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sweep.run_sweep([spec], POLICIES, engine="batch",
                               on_unsupported="fallback",
                               device="cpu")["l6"]["cpc"].cap_changes > 0
