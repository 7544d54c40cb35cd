"""The port's sharded sweep: a grid's cells split over the ``("cells",)``
mesh of CPU ranks (gloo), against one rank and against the JAX package.

The reference's bar (``tests/test_sharded_parity.py``): cells are
independent, so each rank runs the same per-cell arithmetic on its shard
and every per-cell result -- counts, energy, payload, final placements,
power states and caps -- is bitwise the single-rank run's.  Here its
``SHARDED_SCRIPT`` grid (two pad buckets, the migration layer live) and
its row-contention grid run at world sizes 1 and 4; against the
reference's single-device results counts are exact and energy and
payload within 1e-9 (the reference's batched engine under the F1
stand-in).  The cells axis is padded with copies of the leading cells
when the ranks do not divide it: poisoned copies change no kept bit
(ROADMAP trap T3), and ``keep_timeseries`` stays bitwise under the split
(T2).  Every spawn has its own timeout and kills its ranks when it runs
out.
"""

import contextlib

import jax
import jax.experimental
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.sim import sweep as ref_sweep
from repro_torch.launch import mesh
from repro_torch.sim import sweep
from repro_torch.sim.batch import check_n_devices

POLICIES = ("cpc", "static")
RTOL = 1e-9
TIMEOUT_S = 120.0


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


def hetero_specs(module):
    """``SHARDED_SCRIPT``'s grid: pad buckets (4, 16) and (16, 16)."""
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


GRIDS = {
    "sharded_script": hetero_specs,
    "row_contention": lambda m: m.row_contention_specs(sizes=(10,),
                                                       duration_s=600.0),
}


def _same_runs(a: dict, b: dict) -> None:
    """Two ranks' or two worlds' runs bitwise equal: every cell, its
    order, and each bucket's final states."""
    assert a["order"] == b["order"]
    assert a["cells"] == b["cells"]
    assert len(a["finals"]) == len(b["finals"])
    for fa, fb in zip(a["finals"], b["finals"]):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_split_over_four_ranks_is_bitwise_one_rank(grid, x64):
    """World 1 and world 4 give the same bits on every rank; each bucket
    records the split it ran (clamped to its cells); against the
    reference's single device, counts exact and energy and payload within
    1e-9."""
    specs = GRIDS[grid](sweep)
    one = mesh.spawn(ranks.sweep, 1, "cpu", specs, POLICIES,
                     timeout_s=TIMEOUT_S)[0]
    four = mesh.spawn(ranks.sweep, 4, "cpu", specs, POLICIES,
                      timeout_s=TIMEOUT_S)
    assert one["n_devices"] == [1] * len(one["n_devices"])
    # Row contention's two cells split over two of the four ranks: the
    # other two run no cell and still get the grid.
    assert max(four[0]["n_devices"]) == min(4, 2 * len(specs))
    for run in four:
        _same_runs(run, one)
    here = ranks.sweep(specs, POLICIES)
    _same_runs(here, one)

    ref = ref_sweep.run_sweep(GRIDS[grid](ref_sweep), POLICIES,
                              engine="batch", n_devices=1)
    fields = ranks.CELL_FIELDS
    for (name, p), got in four[0]["cells"].items():
        want = ref[name][p]
        for f, g in zip(fields, got):
            w = getattr(want, f)
            if f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
                assert g == w, (name, p, f)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL,
                                           err_msg=f"{name}/{p}/{f}")
    if grid == "sharded_script":
        assert any(c[1] > 0 for c in one["cells"].values())   # migrations
    else:
        assert any(c[0] > 0 for (n, p), c in one["cells"].items()
                   if p == "cpc")


def test_padded_cells_poisoned_change_no_kept_bit():
    """Three cells over two ranks pad one copy of the first cell; with
    the copy's demand and budget poisoned, the kept cells' results, final
    states included, are bitwise the single rank's (trap T3)."""
    specs = hetero_specs(sweep)[1:]
    one = ranks.sweep(specs, ("cpc",), exact=True)
    two = mesh.spawn(ranks.sweep, 2, "cpu", specs, ("cpc",), None, True,
                     True, timeout_s=TIMEOUT_S)
    assert two[0]["n_devices"] == [2]
    for run in two:
        _same_runs(run, one)


def test_timeseries_bitwise_under_the_split():
    """``keep_timeseries`` on four ranks: the per-tick series, their fold
    and every per-cell array equal the single rank's bit for bit (trap
    T2), with the cells axis padded (six cells over four ranks); each
    rank sizes K2's plan for the whole grid."""
    specs = [s for s in hetero_specs(sweep) if s.name != "s4r"]
    one = ranks.batched(specs, POLICIES, 1, True)
    four = mesh.spawn(ranks.batched, 4, "cpu", specs, POLICIES, 4, True,
                      timeout_s=TIMEOUT_S)
    # K2's cluster width, and so the order of each cell's sums on the
    # card, is planned for the whole grid's cells on every rank.
    assert one["plan_cells"] == {len(specs) * len(POLICIES)}
    for run in four:
        assert run["n_devices"] == 4
        assert run["plan_cells"] == one["plan_cells"]
        for k, v in one.items():
            if k in ("n_devices", "plan_cells"):
                continue
            if isinstance(v, dict):
                for kk in v:
                    np.testing.assert_array_equal(run[k][kk], v[kk])
            else:
                np.testing.assert_array_equal(run[k], v)


def test_n_devices_clamps_to_the_cells_and_raises_above_the_world():
    """The reference's clamp ``max(1, min(n, S))``; without a process
    group the world is one rank, so a split that survives the clamp
    raises ``ValueError``, and ``None`` runs one rank as before."""
    assert check_n_devices(None, 5) == 1
    assert check_n_devices(0, 5) == 1
    assert check_n_devices(8, 1) == 1
    with pytest.raises(ValueError, match="process group"):
        check_n_devices(2, 5)
    sweep.run_sweep(hetero_specs(sweep)[:1], POLICIES, engine="batch",
                    device="cpu")
    assert [b["n_devices"] for b in sweep.LAST_BATCH_INFO] == [1]
