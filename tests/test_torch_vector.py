"""The port's vector engine against the JAX package's, cap-only regime.

The same scenarios run through the reference's NumPy ``VectorSimulator``
and the port's (on the CPU: the plain versions of kernels K2 and K3): the
paper's ``headroom`` and ``standby`` scenarios under the sweeps' cap-only
manager (no DPM, no migration search), carried over with
``convert.from_reference_snapshot``, and cap-only sweep cells built by
both packages from the same seeds.  The bar is the one the reference sets
between its own engines: exact cap-change, vMotion and power-event counts,
1e-9 relative on every float integral (payload, demand, memory, energy,
per-tag payload, window accumulators).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.manager import CloudPowerCapManager as RefManager
from repro.core.manager import ManagerConfig as RefManagerConfig
from repro.drs import balancer as ref_balancer
from repro.sim import sweep as ref_sweep
from repro.sim.engine import VectorSimulator as RefVectorSimulator
from repro.sim.experiments import SCENARIOS
from repro_torch.convert import from_reference_snapshot
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import PAPER_HOST
from repro_torch.drs.balancer import BalancerConfig
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim import sweep
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.engine import VectorSimulator
from repro_torch.sim.workloads import constant

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
RTOL = 1e-9
POLICIES = ("cpc", "static", "statichigh")


@pytest.fixture(autouse=True)
def deterministic():
    """Every per-host sum of the port must be order-stable (no atomics)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _ref_manager(policy):
    cfg = RefManagerConfig(powercap_enabled=(policy == "cpc"),
                           dpm_enabled=False)
    cfg.balancer = ref_balancer.BalancerConfig(max_moves=0)
    return RefManager(cfg)


def _manager(policy, **kw):
    cfg = ManagerConfig(powercap_enabled=(policy == "cpc"), dpm_enabled=False,
                        balancer=BalancerConfig(max_moves=0))
    for k, v in kw.items():
        setattr(cfg, k, v)
    return CloudPowerCapManager(cfg, device="cpu")


def _config(ref_cfg, **kw) -> SimConfig:
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(SimConfig)}
    return SimConfig(**dict(fields, **kw))


def _both(scenario, policy, record_timeline=False):
    """(reference result, port result) of one paper scenario, the first
    ten VMs tagged ``spiky`` and the rest ``steady``."""
    snap, traces, cfg, window = SCENARIOS[scenario].build(policy)
    cfg.record_timeline = record_timeline
    for i, vm in enumerate(snap.vms.values()):
        vm.tags = frozenset({"spiky" if i < 10 else "steady"})
    port_snap, port_traces = from_reference_snapshot(snap, traces)
    port = VectorSimulator(port_snap, _manager(policy), port_traces,
                           _config(cfg), window=window, device="cpu").run()
    want = RefVectorSimulator(snap, _ref_manager(policy), traces, cfg,
                              window=window).run()
    return want, port


def _assert_acc(got, want):
    for f in COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    assert got.tag_payload.keys() == want.tag_payload.keys()
    for tag in want.tag_payload:
        np.testing.assert_allclose(got.tag_payload[tag],
                                   want.tag_payload[tag], rtol=RTOL)
        np.testing.assert_allclose(got.tag_demand[tag],
                                   want.tag_demand[tag], rtol=RTOL)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", ("headroom", "standby"))
def test_paper_scenario_matches_reference_vector_engine(scenario, policy):
    want, got = _both(scenario, policy)
    _assert_acc(got.acc, want.acc)
    assert (got.window_acc is None) == (want.window_acc is None)
    if want.window_acc is not None:
        _assert_acc(got.window_acc, want.window_acc)
    if scenario == "headroom":
        assert want.window_acc is not None
        assert (got.acc.cap_changes > 0) == (policy == "cpc")
    assert len(got.events) == len(want.events)
    for (tg, eg), (tw, ew) in zip(got.events, want.events):
        assert tg == tw and eg.split(" imbalance")[0] == \
            ew.split(" imbalance")[0]
    assert got.final.hosts.keys() == want.final.hosts.keys()
    for hid, host in want.final.hosts.items():
        assert got.final.hosts[hid].powered_on == host.powered_on
        np.testing.assert_allclose(got.final.hosts[hid].power_cap,
                                   host.power_cap, rtol=RTOL)


def test_headroom_timeline_matches():
    want, got = _both("headroom", "cpc", record_timeline=True)
    assert len(got.timeline) == len(want.timeline) == 210
    for (tg, hg), (tw, hw) in zip(got.timeline, want.timeline):
        assert tg == tw and hg.keys() == hw.keys()
        for hid in hw:
            (cg, ug, ng), (cw, uw, nw) = hg[hid], hw[hid]
            assert ng == nw
            np.testing.assert_allclose([cg, ug], [cw, uw], rtol=RTOL)


def _ladder(module, size, spike, het):
    spec = module.scale_ladder(sizes=(size,), spike=spike)[0]
    return dataclasses.replace(spec, heterogeneous=het,
                               name=spec.name + ("_het" if het else ""))


@pytest.mark.parametrize("het", (False, True), ids=("homog", "het"))
@pytest.mark.parametrize("spike", ("burst", "step", "prime"))
@pytest.mark.parametrize("size", (10, 30))
def test_sweep_cells_match_reference_vector_engine(size, spike, het):
    spec = _ladder(sweep, size, spike, het)
    ref_spec = _ladder(ref_sweep, size, spike, het)
    got = sweep.run_sweep([spec], POLICIES, device="cpu")[spec.name]
    want = ref_sweep.run_sweep([ref_spec], POLICIES,
                               engine="vector")[ref_spec.name]
    for p in POLICIES:
        g, w = got[p], want[p]
        for f in COUNTS + ("ticks",):
            assert getattr(g, f) == getattr(w, f), (p, f)
        for f in ("cpu_payload_mhz_s", "energy_j", "cpu_satisfaction"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL, err_msg=f"{p} {f}")
    assert got["cpc"].cap_changes > 0


def test_vector_engine_matches_the_batch_engine():
    specs = sweep.scenario_families(sizes=(6,),
                                    spikes=("flat", "burst", "step", "prime"),
                                    heterogeneous=(False, True),
                                    duration_s=600.0)
    vec = sweep.run_sweep(specs, POLICIES, engine="vector", device="cpu")
    bat = sweep.run_sweep(specs, POLICIES, engine="batch", device="cpu")
    for spec in specs:
        for p in POLICIES:
            v, b = vec[spec.name][p], bat[spec.name][p]
            for f in COUNTS + ("ticks",):
                assert getattr(v, f) == getattr(b, f), (spec.name, p, f)
            for f in ("cpu_payload_mhz_s", "energy_j"):
                np.testing.assert_allclose(getattr(v, f), getattr(b, f),
                                           rtol=RTOL, err_msg=f)
    assert sum(vec[s.name]["cpc"].cap_changes for s in specs) > 0


def _cluster(rules=None, hot=False, **snap_kw):
    """Two paper hosts with four VMs; ``hot`` piles them all on host0 at
    9000 MHz each, past what BalancePowerCap's Watts can absorb."""
    hosts = [Host(f"host{i}", PAPER_HOST, power_cap=250.0) for i in range(2)]
    vms = [VirtualMachine(f"vm{i}", host_id="host0" if hot
                          else f"host{i % 2}") for i in range(4)]
    traces = {v.vm_id: constant(9000.0 if hot else 1000.0, 2048.0)
              for v in vms}
    return ClusterSnapshot(hosts, vms, power_budget=500.0, rules=rules,
                           **snap_kw), traces


def _ref_cluster(rules=(), hot=False):
    """:func:`_cluster`'s cluster built by the reference, with its
    traces."""
    from repro.core.power_model import PAPER_HOST as REF_HOST
    from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
    from repro.drs.snapshot import Host as RefHost
    from repro.drs.snapshot import VirtualMachine as RefVM
    from repro.sim import workloads as ref_workloads

    hosts = [RefHost(f"host{i}", REF_HOST, power_cap=250.0)
             for i in range(2)]
    vms = [RefVM(f"vm{i}", host_id="host0" if hot else f"host{i % 2}")
           for i in range(4)]
    traces = {v.vm_id: ref_workloads.constant(9000.0 if hot else 1000.0,
                                              2048.0) for v in vms}
    return RefSnapshot(hosts, vms, power_budget=500.0,
                       rules=list(rules)), traces


def _hold_vector_run(ref_snap, ref_traces, ref_cfg, ref_mgr, mgr):
    """One scenario through both vector engines: exact counts, 1e-9
    floats, the final placement and power states equal."""
    from repro_torch.convert import from_reference_config

    snap, traces = from_reference_snapshot(ref_snap, ref_traces)
    want = RefVectorSimulator(ref_snap, ref_mgr, ref_traces, ref_cfg).run()
    got = VectorSimulator(snap, mgr, traces, from_reference_config(ref_cfg),
                          device="cpu").run()
    for f in COUNTS:
        assert getattr(got.acc, f) == getattr(want.acc, f), f
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got.acc, f),
                                   getattr(want.acc, f), rtol=RTOL,
                                   err_msg=f)
    assert ({v.vm_id: v.host_id for v in got.final.vms.values()}
            == {v.vm_id: v.host_id for v in want.final.vms.values()})
    assert ([h.powered_on for h in got.final.hosts.values()]
            == [h.powered_on for h in want.final.hosts.values()])
    return got


@pytest.mark.parametrize("regime", ("rules", "max_moves", "dpm"))
def test_unported_manager_regimes_raise_at_the_first_invocation(regime):
    """The regimes that needed the migration layer run as the reference's:
    an affinity rule violated at the start (corrected at the first
    invocation), the hill-climb balancer on a strained host (static caps,
    so Watts cannot absorb it), and DPM under placement rules (rule-aware
    evacuations)."""
    from repro.drs.rules import AffinityRule as RefAffinity
    from repro.sim.cluster import SimConfig as RefSimConfig

    rules = ([RefAffinity(("vm0", "vm1"))] if regime in ("rules", "dpm")
             else [])
    ref_snap, ref_traces = _ref_cluster(rules, hot=regime == "max_moves")
    kw = {"rules": {}, "max_moves": dict(max_moves=4),
          "dpm": dict(dpm_enabled=True)}[regime]
    policy = "static" if regime == "max_moves" else "cpc"
    ref_cfg = RefManagerConfig(powercap_enabled=policy == "cpc",
                               dpm_enabled=kw.get("dpm_enabled", False))
    ref_cfg.balancer = ref_balancer.BalancerConfig(
        max_moves=kw.get("max_moves", 0))
    mgr = _manager(policy, dpm_enabled=kw.get("dpm_enabled", False),
                   balancer=BalancerConfig(max_moves=kw.get("max_moves", 0)))
    got = _hold_vector_run(ref_snap, ref_traces, RefSimConfig(
        duration_s=600.0), RefManager(ref_cfg), mgr)
    if regime != "dpm":
        assert got.acc.vmotions > 0


def test_unported_simulator_regimes_raise():
    """Gated migration launches run as the reference's (one launch an
    invocation, then one a host; FIFO completion): the balancer spreads a
    hot host over the invocations.  Scripted power events and budget trees
    run too, and a tree over the wrong host count is refused."""
    from repro.sim.cluster import SimConfig as RefSimConfig

    for gate in (dict(migration_bandwidth=1),
                 dict(migration_slots_per_host=1)):
        ref_snap, ref_traces = _ref_cluster(hot=True)
        ref_cfg = RefManagerConfig(powercap_enabled=False, dpm_enabled=False)
        ref_cfg.balancer = ref_balancer.BalancerConfig(max_moves=4)
        got = _hold_vector_run(
            ref_snap, ref_traces,
            RefSimConfig(duration_s=1200.0, record_timeline=False, **gate),
            RefManager(ref_cfg),
            _manager("static", balancer=BalancerConfig(max_moves=4)))
        assert got.acc.vmotions > 0
    snap, traces = _cluster()
    with pytest.raises(ValueError, match="host count"):
        _cluster(budget_tree=BudgetTree([-1], [500.0], [0, 0, 0]))
    VectorSimulator(snap, _manager("cpc"), traces,
                    SimConfig(power_events=((300.0, "host0", False),)),
                    device="cpu")
    assert snap.effective_tree() is None and snap.tree_respected()
    flat, _ = _cluster(budget_tree=BudgetTree([-1], [500.0], [0, 0]))
    assert flat.budget_tree is not None and flat.effective_tree() is None


def test_manager_and_simulator_must_share_a_device():
    snap, traces = _cluster()

    class OnTheCard:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="one device"):
        VectorSimulator(snap, OnTheCard(), traces, device="cpu")


def _reference_cluster(seed):
    """A reference snapshot with both host types, a host powered off, VM
    reservations, limits, memory reservations and an unplaced VM."""
    from repro.core.power_model import PAPER_HOST as REF_HOST
    from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
    from repro.drs.snapshot import Host as RefHost
    from repro.drs.snapshot import VirtualMachine as RefVM
    from repro.sim.sweep import SMALL_HOST as REF_SMALL

    rng = np.random.RandomState(seed)
    hosts = [RefHost(f"host{i}", REF_SMALL if i % 2 else REF_HOST,
                     power_cap=float(rng.uniform(150.0, 240.0)),
                     powered_on=i != 3) for i in range(6)]
    vms = []
    for v in range(40):
        res = float(rng.choice([0.0, rng.uniform(100.0, 800.0)]))
        vms.append(RefVM(
            f"vm{v}", vcpus=int(rng.randint(1, 3)), reservation=res,
            limit=float(rng.choice([np.inf, res + rng.uniform(500, 3000)])),
            mem_reservation=float(rng.uniform(0, 1024)),
            demand=float(rng.uniform(0, 4000)),
            mem_demand=float(rng.uniform(512, 8192)),
            host_id=None if v == 39 else f"host{v % 6}"))
    return RefSnapshot(hosts, vms, power_budget=1300.0)


@pytest.mark.parametrize("seed", (0, 1))
def test_array_view_and_snapshot_match_the_reference(seed):
    ref_snap = _reference_cluster(seed)
    snap, _ = from_reference_snapshot(ref_snap, {})
    want, got = ref_snap.as_arrays(), snap.as_arrays("cpu")
    caps = want.power_cap * 0.97
    for name, args in (("capped_capacity", ()), ("managed_capacity", ()),
                       ("managed_capacity", (caps,)),
                       ("peak_managed_capacity", ()), ("active_vms", ()),
                       ("cpu_reserved", ()), ("mem_reserved", ()),
                       ("mem_demand_sum", ()), ("reserved_power_cap", ()),
                       ("host_demand", ()), ("host_cpu_utilization", ()),
                       ("host_mem_utilization", ()),
                       ("entitlement_sums", ()), ("entitlement_sums", (caps,)),
                       ("normalized_entitlements", ())):
        np.testing.assert_allclose(getattr(got, name)(*args),
                                   getattr(want, name)(*args), rtol=RTOL,
                                   atol=1e-9, err_msg=name)
    for got_col, want_col in zip(got.waterfill_cols(), want.waterfill_cols()):
        np.testing.assert_array_equal(got_col, want_col)
    np.testing.assert_allclose(got.imbalance(), want.imbalance(), rtol=RTOL)
    np.testing.assert_allclose(snap.imbalance("cpu"), ref_snap.imbalance(),
                               rtol=RTOL)
    for hid in ref_snap.hosts:
        for name in ("reserved_power_cap", "host_cpu_utilization",
                     "host_mem_utilization", "cpu_reserved", "mem_used",
                     "mem_reserved"):
            np.testing.assert_allclose(getattr(snap, name)(hid),
                                       getattr(ref_snap, name)(hid),
                                       rtol=RTOL, err_msg=name)
        assert snap.reservations_respected(hid) == \
            ref_snap.reservations_respected(hid)
        h, rh = snap.hosts[hid], ref_snap.hosts[hid]
        for name in ("capped_capacity", "managed_capacity",
                     "peak_managed_capacity", "memory_mb"):
            assert getattr(h, name) == getattr(rh, name), name
    np.testing.assert_allclose(snap.unreserved_power_budget(),
                               ref_snap.unreserved_power_budget(), rtol=RTOL)
    assert snap.budget_respected() == ref_snap.budget_respected()

    def validated(s):
        try:
            s.validate()
        except AssertionError as e:
            return str(e).split(":")[0]
        return "valid"

    assert validated(snap) == validated(ref_snap)
    for spec, ref_spec in ((h.spec, rh.spec) for h, rh in zip(
            snap.hosts.values(), ref_snap.hosts.values())):
        for name in ("power_consumed", "capped_capacity", "cap_for_capacity",
                     "managed_capacity", "cap_for_managed_capacity"):
            x = np.linspace(-50.0, 40_000.0, 7)
            np.testing.assert_array_equal(getattr(spec, name)(x),
                                          getattr(ref_spec, name)(x))


# ------------------------------------------------------------- churn cells
def _churn_specs(module):
    """``sweep_grid_dpm``'s ``dpm``, ``maintenance`` and ``failure`` specs
    at 10 hosts, burst spike, both host mixes."""
    return module.scenario_families(
        sizes=(10,), spikes=("burst",), heterogeneous=(False, True),
        churns=("dpm", "maintenance", "failure"), duration_s=1500.0,
        tick_s=15.0)


def test_churn_cells_match_reference_vector_engine_and_the_batch():
    """``run_cell`` on the churn specs (DPM with its evacuations and
    redistribution, scripted maintenance and failure) against the
    reference's vector engine, and the port's batched engine on the same
    cells against both."""
    specs = _churn_specs(sweep)
    policies = ("cpc", "static")
    want = {(r.name, p): ref_sweep.run_cell(r, p, engine="vector")
            for r in _churn_specs(ref_sweep) for p in policies}
    got = {(s.name, p): sweep.run_cell(s, p, device="cpu")
           for s in specs for p in policies}
    batch = sweep.run_sweep(specs, policies, engine="batch", device="cpu",
                            slot_slack=1.5)
    for (name, p), w in want.items():
        for g in (got[name, p], batch[name][p]):
            for f in COUNTS:
                assert getattr(g, f) == getattr(w, f), (name, p, f)
            for f in ("cpu_payload_mhz_s", "energy_j", "cpu_satisfaction"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL, err_msg=f)
    assert sum(w.power_offs for w in want.values()) > 0
    assert sum(w.vmotions for w in want.values()) > 0
