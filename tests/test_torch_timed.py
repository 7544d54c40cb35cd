"""The port's gated timed vMotions against the JAX package's.

``tests/test_migration_parity.py``'s timed scenarios (copy windows, launch
slots and bandwidth gates, FIFO completion, exempt evacuations, a
destination that fails mid-copy) through the port's vector and batched
engines against the reference's vector engine; the refusals the reference
makes (ungated timed cells, cells that disagree on the migration model);
``run_sweep`` on the migration families (``sweep_grid_rules``'s and
``sweep_grid_timed``'s grids, ``benchmarks/run.py``, whose comparison with
the reference is ``tests/test_torch_sweep_migration.py``'s) on both
engines; a reference pack of the timed regime carried over; the per-tick
series folding back bitwise (trap T2); and poisoned padding and in-flight
table rows (trap T3).  The bar: exact counts of cap changes, vMotions,
power-ons and power-offs, 1e-9 relative on payload and energy, the same
final placement.
"""

import contextlib
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.sim import sweep as ref_sweep
from repro.sim.batch import BatchedSimulator as RefSimulator
from repro.sim.engine import VectorSimulator as RefVectorSimulator
from repro_torch.convert import (from_reference_config, from_reference_pack,
                                from_reference_snapshot)
from repro_torch.drs import rules as rules_mod
from repro_torch.sim import batch as batch_mod
from repro_torch.sim import sweep
from repro_torch.sim.batch import (BatchCell, BatchedSimulator,
                                   BatchUnsupported)
from repro_torch.sim.engine import VectorSimulator

import test_migration_parity as ref_scenarios
from test_torch_migration import (COUNTS, FLOATS, RTOL, _managers,
                                  hold_scenario)


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


_timed = ref_scenarios._timed


# ------------------------------------------------------ timed scenarios
def test_timed_rule_correction_parity():
    """Corrections launch at the invocation, burn endpoint overhead for a
    copy window of at least two ticks and commit FIFO."""
    out, _ = hold_scenario(_timed(ref_scenarios._rules_build, slots=2))
    for want, got in out.values():
        assert want.acc.vmotions >= 3
        assert not rules_mod.all_violations(got.final)


def test_timed_balancer_parity_under_bandwidth_gate():
    """Two launches an invocation: deferred balancer moves are scored again
    at the next invocation."""
    out, _ = hold_scenario(_timed(ref_scenarios._contended_build,
                                  slots=None, bw=2))
    assert out["static"][1].acc.vmotions > 2


def test_timed_churn_rules_parity():
    """DPM churn, placement rules and gated timed migrations on the
    batched engine, no cell refused, lifecycle counts exact."""
    build = _timed(ref_scenarios._churn_rules_build, slots=2)
    snap, traces = from_reference_snapshot(*build()[:2])
    assert BatchedSimulator.unsupported_cells([BatchCell(
        "probe", snap, traces, from_reference_config(build()[2]),
        dpm_enabled=True)]) == {}
    out, _ = hold_scenario(build, max_moves=0, dpm_enabled=True)
    got = out["cpc"][1]
    assert got.acc.power_offs == 1 and got.acc.vmotions == 10


def test_timed_zero_slots_blocks_all_launches():
    """``migration_slots_per_host=0``: the manager launches nothing, and the
    violations stay."""
    out, _ = hold_scenario(_timed(ref_scenarios._rules_build, slots=0))
    for want, got in out.values():
        assert got.acc.vmotions == 0
        assert rules_mod.all_violations(got.final)


def test_timed_evacuation_exempt_from_slot_limits():
    """A power-off's evacuation launches every evacuee at once, past a
    one-slot gate."""
    out, _ = hold_scenario(_timed(ref_scenarios._churn_rules_build,
                                  slots=1), max_moves=0, dpm_enabled=True)
    got = out["cpc"][1]
    assert got.acc.power_offs == 1 and got.acc.vmotions == 10


def test_timed_destination_powers_off_mid_flight():
    """The destination fails mid-copy; the migration commits on schedule
    and the VM lands on the powered-off host, in both engines."""
    snap, traces, cfg = ref_scenarios._endpoint_failure_build()
    want = RefVectorSimulator(snap, ref_scenarios._manager("static",
                                                           max_moves=0),
                              traces, cfg).run()
    assert want.final.vms["big"].host_id == "h1"
    _, pman = _managers("static", max_moves=0)
    psnap, ptraces = from_reference_snapshot(
        *ref_scenarios._endpoint_failure_build()[:2])
    got = VectorSimulator(psnap, pman, ptraces, from_reference_config(cfg),
                          device="cpu").run()
    psnap, ptraces = from_reference_snapshot(
        *ref_scenarios._endpoint_failure_build()[:2])
    res = BatchedSimulator([BatchCell(
        "fail", psnap, ptraces, from_reference_config(cfg),
        powercap_enabled=False, balancer_enabled=False)], slot_slack=3.0,
        device="cpu").run()
    acc = res.accumulators(0)
    for f in COUNTS:
        assert getattr(got.acc, f) == getattr(acc, f) \
            == getattr(want.acc, f), f
    for f in FLOATS:
        for a in (got.acc, acc):
            np.testing.assert_allclose(getattr(a, f), getattr(want.acc, f),
                                       rtol=RTOL, err_msg=f)
    assert got.final.vms["big"].host_id == "h1"
    assert not got.final.hosts["h1"].powered_on
    h1 = list(psnap.hosts).index("h1")
    assert not res.final_on[0, h1] and res.final_occ[0, h1].sum() == 2


def test_host_migration_overhead_is_the_vector_engines(monkeypatch):
    """The simulator's per-host vMotion overhead of the running migrations
    (``Simulator._host_migration_overhead``) is what the vector engine
    charges each host a tick, through a timed run with copies in flight."""
    build = _timed(ref_scenarios._rules_build, slots=2)
    snap, traces = from_reference_snapshot(*build()[:2])
    _, pman = _managers("static")
    sim = VectorSimulator(snap, pman, traces,
                          from_reference_config(build()[2]), device="cpu")
    seen = []
    real = VectorSimulator._overhead

    def overhead(self):
        got = real(self)
        want = [self._host_migration_overhead(h) for h in self._host_ids]
        seen.append(max(want))
        assert (got is None and not any(want)) or (
            got.tolist() == want)
        return got

    monkeypatch.setattr(VectorSimulator, "_overhead", overhead)
    sim.run()
    assert max(seen) > 0


def _port_cell(name, build, **kw):
    snap, traces, cfg = build()
    psnap, ptraces = from_reference_snapshot(snap, traces)
    return BatchCell(name, psnap, ptraces, from_reference_config(cfg), **kw)


def test_ungated_timed_migration_rejected():
    """Timed migrations without launch gates stay on the vector engine."""
    with pytest.raises(BatchUnsupported, match="launch gating"):
        BatchedSimulator([_port_cell("a", lambda: (
            *ref_scenarios._rules_build()[:2], dataclasses.replace(
                ref_scenarios._rules_build()[2],
                instant_migrations=False)))], device="cpu")


def test_unsupported_cells_partition():
    """The reason map names exactly the offending cells: an ungated timed
    cell, and a timed cell beside the batch's instant migration model."""
    ungated = _timed(ref_scenarios._rules_build, slots=None)
    reasons = BatchedSimulator.unsupported_cells(
        [_port_cell("good", ref_scenarios._rules_build),
         _port_cell("bad", ungated)])
    assert set(reasons) == {"bad"} and "launch gating" in reasons["bad"]
    timed = _timed(ref_scenarios._rules_build, slots=2)
    assert BatchedSimulator.unsupported_cells(
        [_port_cell("timed", timed)]) == {}
    mixed = BatchedSimulator.unsupported_cells(
        [_port_cell("good", ref_scenarios._rules_build),
         _port_cell("timed", timed)])
    assert set(mixed) == {"timed"}
    assert "migration execution model" in mixed["timed"]


# -------------------------------------------------- the sweep families
#: ``sweep_grid_rules``'s and ``sweep_grid_timed``'s grids
#: (``benchmarks/run.py``), cut to a host count.
def rules_grid(n):
    return dict(sizes=(n,), budgets_per_host_w=(250.0,),
                spikes=("flat", "burst", "step", "prime"),
                heterogeneous=(False, True),
                rules=("violation_burst", "cap_blocked"),
                duration_s=600.0, tick_s=10.0)


def timed_grid(n):
    return dict(sizes=(n,), budgets_per_host_w=(250.0,),
                spikes=("burst", "prime"), heterogeneous=(False, True),
                churns=("timed_churn", "failure_cascade"),
                rules=("none", "violation_burst"), duration_s=600.0,
                tick_s=10.0)


def _vector_final(module, spec, policy, **kw):
    """One cell on ``module``'s vector engine: its accumulators and the
    final VM count on each host."""
    snap, traces, cfg = module.build_sweep(spec, policy)
    manager = module._sweep_manager(policy, spec=spec, **kw)
    if module is sweep:
        sim = VectorSimulator(snap, manager, traces, cfg, device="cpu")
    else:
        sim = RefVectorSimulator(snap, manager, traces, cfg)
    res = sim.run()
    return res.acc, [len(res.final.vms_on(h)) for h in res.final.hosts]


def _same(a, b) -> bool:
    return (all(getattr(a, f) == getattr(b, f) for f in COUNTS)
            and all(abs(getattr(a, f) - getattr(b, f))
                    <= RTOL * abs(getattr(b, f)) for f in FLOATS))


def _hold_family(grid):
    """A family through all four engines.  Where the reference's vector
    and batched engines agree (counts, floats, every host's VM count), the
    port's batched engine equals the reference's (final occupancy and power
    states too) and the port's vector engine equals it; where they split
    (ties the reference's own engines round apart), the port's vector
    engine equals the reference's vector engine and the port's batched
    engine one of the two.  Returns the cells the reference splits on."""
    policies = ("cpc", "static")
    ref_specs = ref_sweep.scenario_families(**grid)
    ref_cells, _ = ref_sweep._build_batch_cells(ref_specs, policies)
    want = RefSimulator(ref_cells, slot_slack=1.5,
                        balancer=ref_sweep._grid_balancer(ref_specs)).run()
    specs = sweep.scenario_families(**grid)
    cells, keys = sweep.build_batch_cells(specs, policies)
    got = BatchedSimulator(cells, slot_slack=1.5,
                           balancer=sweep.grid_balancer(specs),
                           device="cpu").run()
    split = []
    for i, (spec, p) in enumerate(keys):
        ref_v, ref_hosts = _vector_final(ref_sweep, ref_specs[i // 2], p)
        vec, hosts = _vector_final(sweep, spec, p, device="cpu")
        assert _same(vec, ref_v) and hosts == ref_hosts, (spec.name, p)
        ref_b, bat = want.accumulators(i), got.accumulators(i)
        n = len(hosts)
        if _same(ref_b, ref_v) and list(
                want.final_occ[i, :n].sum(-1)) == ref_hosts:
            assert _same(bat, ref_b), (spec.name, p)
            np.testing.assert_array_equal(got.final_occ[i],
                                          want.final_occ[i])
            np.testing.assert_array_equal(got.final_on[i], want.final_on[i])
            np.testing.assert_allclose(got.final_caps[i], want.final_caps[i],
                                       rtol=RTOL)
        else:
            split.append((spec.name, p))
            assert _same(bat, ref_b) or (
                _same(bat, ref_v)
                and list(got.final_occ[i, :n].sum(-1)) == ref_hosts), (
                spec.name, p)
    assert want.vmotions.sum() > 0
    return split


def test_run_sweep_runs_the_migration_families_on_both_engines():
    """``run_sweep`` with ``scenario_families(..., rules=...)`` and
    ``(..., churns=...)`` on each engine: the batched engine's cells equal
    the vector engine's, and the rule families correct their violations.
    The two families run as two batches: a batch shares one migration
    model (instant or timed), as the reference's does."""
    for specs in (sweep.scenario_families(**dict(rules_grid(8),
                                                 spikes=("flat",))),
                  sweep.scenario_families(**dict(timed_grid(8),
                                                 spikes=("burst",),
                                                 heterogeneous=(False,)))):
        bat = sweep.run_sweep(specs, ("cpc", "static"), engine="batch",
                              device="cpu", slot_slack=1.5)
        (record,) = sweep.LAST_BATCH_INFO     # one pad bucket, (8, 16)
        info = record["info"]
        vec = sweep.run_sweep(specs, ("cpc", "static"), device="cpu")
        for s in specs:
            for p in ("cpc", "static"):
                b, v = bat[s.name][p], vec[s.name][p]
                for f in COUNTS:
                    assert getattr(b, f) == getattr(v, f), (s.name, p, f)
                for f in ("cpu_payload_mhz_s", "energy_j"):
                    np.testing.assert_allclose(getattr(b, f), getattr(v, f),
                                               rtol=RTOL)
        assert info["migration_reads"] > 0
        assert info["branch_reads"] == info["ticks"] + info[
            "migration_reads"]
        assert sum(bat[s.name]["cpc"].vmotions for s in specs) > 0


# ----------------------------------------------- packs, series, padding
def _timed_cells(n=8):
    specs = sweep.scenario_families(**dict(timed_grid(n),
                                           spikes=("burst",)))
    cells, _ = sweep.build_batch_cells(specs, ("cpc", "static"))
    return specs, cells


def test_timed_reference_pack_carries_over(x64):
    """The reference's pack of a timed grid with rules (its in-flight table,
    launch gates, vMotion model and rule columns) runs in the port as in
    the reference's batched engine, and the port packs it bitwise."""
    grid = dict(timed_grid(8), spikes=("burst",))
    ref_specs = ref_sweep.scenario_families(**grid)
    ref_cells, _ = ref_sweep._build_batch_cells(ref_specs, ("cpc", "static"))
    ref = RefSimulator(ref_cells, slot_slack=1.5,
                       balancer=ref_sweep._grid_balancer(ref_specs))
    assert ref._static.timed and ref._static.migration
    want = ref.run()
    got = from_reference_pack(ref._arrays, ref._static, device="cpu").run()
    specs, cells = _timed_cells()
    own = BatchedSimulator(cells, slot_slack=1.5,
                           balancer=sweep.grid_balancer(specs), device="cpu")
    for k in batch_mod.PACK_KEYS + batch_mod.RULE_KEYS:
        np.testing.assert_array_equal(own._arrays[k], ref._arrays[k],
                                      err_msg=k)
    assert own._mig.mig_table == ref._static.mig_table
    for res in (got, own.run()):
        for f in COUNTS:
            np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                          err_msg=f)
        for f in FLOATS:
            np.testing.assert_allclose(getattr(res, f), getattr(want, f),
                                       rtol=RTOL, err_msg=f)
        np.testing.assert_array_equal(res.final_occ, want.final_occ)
    assert want.vmotions.sum() > 0


def test_timed_keep_timeseries_is_bitwise_the_reduced_run():
    """Trap T2 with the in-flight table: the per-tick series (vMotions
    counted as they commit) fold back to the reduced run bit for bit."""
    specs, cells = _timed_cells()
    kw = dict(slot_slack=1.5, balancer=sweep.grid_balancer(specs),
              device="cpu")
    reduced = BatchedSimulator(cells, **kw).run()
    full = BatchedSimulator(cells, keep_timeseries=True, **kw).run()
    folded = full.reduced_timeseries()
    for f in FLOATS:
        np.testing.assert_array_equal(getattr(full, f), getattr(reduced, f))
        np.testing.assert_array_equal(folded[f], getattr(reduced, f))
    for f in COUNTS:
        np.testing.assert_array_equal(full.timeseries[f].sum(0),
                                      getattr(reduced, f))
    np.testing.assert_array_equal(full.final_occ, reduced.final_occ)
    assert reduced.vmotions.sum() > 0


def test_timed_poisoned_padding_changes_nothing(monkeypatch):
    """Trap T3 in the timed regime: the rule columns, demands and
    reservations of empty slots (the slack moves land in), and garbage in
    the in-flight table's empty rows, change no count and no bit."""
    specs, cells = _timed_cells()
    kw = dict(slot_slack=1.5, balancer=sweep.grid_balancer(specs),
              device="cpu")
    clean = BatchedSimulator(cells, **kw).run()
    dirty = BatchedSimulator(cells, **kw)
    a = dirty._arrays
    empty = ~a["occ"]
    for k in ("cpu_vals", "mem_vals"):
        a[k] = np.where(empty[..., None], 1e12, a[k])
    a["reservation"] = np.where(empty, 1e9, a["reservation"])
    a["aff_group"] = np.where(empty, 0, a["aff_group"])
    a["anti"] = a["anti"] | empty[..., None]
    a["allowed"] = a["allowed"] & ~empty[..., None]
    monkeypatch.setattr(batch_mod, "_TABLE_PAD", {
        "mig_j": 3, "mig_dst": 1, "mig_prev": 0, "mig_end": -1e9})
    got = dirty.run()
    for f in COUNTS + FLOATS:
        np.testing.assert_array_equal(getattr(got, f), getattr(clean, f))
    np.testing.assert_array_equal(got.final_occ, clean.final_occ)
    np.testing.assert_array_equal(got.final_caps, clean.final_caps)
    assert clean.vmotions.sum() > 0
