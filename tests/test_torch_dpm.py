"""The port's dynamic regime, part 1, against the JAX package's.

DPM, Powercap Redistribution (Algorithm 3) and scripted power events, from
the kernel functions up: the port's ``core/kernels.py`` DPM functions and
``move_slot`` against the reference's on the same NumPy inputs, ``run_dpm``
and the redistribution adapters on the scenarios of the reference's edge
tests, the object-plane manager, and the batched engine's churn program
against the reference's ``BatchedSimulator`` (through the same pack, and
through cells the port packs itself).  The bar is ROADMAP's: exact counts
of cap changes, power-ons, power-offs and vMotions, 1e-9 relative on
payload and energy, final power states, occupancy and caps equal.  Sorts
must be stable and per-host sums ordered (trap T1), so the parity tests
run under ``torch.use_deterministic_algorithms(True)``.
"""

import contextlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import kernels as rk
from repro.core.manager import CloudPowerCapManager as RefManager
from repro.core.manager import ManagerConfig as RefManagerConfig
from repro.core.power_model import PAPER_HOST as REF_HOST
from repro.core.redistribute import (redistribute_after_power_off as
                                     ref_after_off)
from repro.core.redistribute import (redistribute_for_power_on as
                                     ref_for_on)
from repro.drs import balancer as ref_balancer
from repro.drs import dpm as ref_dpm
from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
from repro.drs.snapshot import Host as RefHost
from repro.drs.snapshot import VirtualMachine as RefVM
from repro.sim import workloads as ref_workloads
from repro.sim.batch import BatchCell as RefCell
from repro.sim.batch import BatchedSimulator as RefSimulator
from repro.sim.cluster import SimConfig as RefSimConfig
from repro.sim.engine import VectorSimulator as RefVectorSimulator
from repro_torch.convert import (from_reference_config, from_reference_pack,
                                from_reference_snapshot)
from repro_torch.core import kernels
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.redistribute import (redistribute_after_power_off,
                                           redistribute_for_power_on)
from repro_torch.drs import dpm
from repro_torch.drs.balancer import BalancerConfig
from repro_torch.sim.batch import PACK_KEYS, BatchCell, BatchedSimulator
from repro_torch.sim.engine import VectorSimulator

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
RTOL = 1e-9
S, H, J = 3, 12, 6


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


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------- kernel functions
def _columns(seed: int, ties: bool = True):
    """Host and slot columns at S 3, H 12, J 6: paper and small hosts, a
    few powered off, and (``ties``) utilizations that tie exactly."""
    rng = np.random.default_rng(seed)
    small = rng.random((S, H)) < 0.4
    on = rng.random((S, H)) > 0.2
    on[:, 0] = True
    cols = dict(
        on=on,
        idle=np.where(small, 120.0, 160.0), peak=np.where(small, 240.0,
                                                          320.0),
        cap_peak=np.where(small, 19_200.0, 34_800.0),
        hyp=np.where(rng.random((S, H)) < 0.3, 500.0, 0.0),
        host_mem=np.where(small, 65536.0, 98304.0))
    cols["caps"] = np.where(on, cols["idle"] + rng.random((S, H))
                            * (cols["peak"] - cols["idle"]), 0.0)
    util = rng.uniform(0.05, 0.95, (S, H))
    if ties:
        util[:, 3:6] = util[:, 2:3]            # three-way exact ties
        util[:, 8] = 0.81                      # on the trigger
    cols["util"] = np.where(on, util, 0.0)
    cols["demand"] = rng.uniform(1000.0, 20000.0, (S, H))
    cols["reserved"] = np.where(rng.random((S, H)) < 0.5,
                                rng.uniform(0.0, 3000.0, (S, H)), 0.0)
    cols["budget"] = (cols["caps"] * on).sum(-1) + rng.uniform(
        -100.0, 200.0, S)
    return cols


def _hosts(cols, mod):
    args = [cols[k] for k in ("on", "idle", "peak", "cap_peak", "hyp")]
    if mod is rk:
        return rk.HostCols(*args)
    return kernels.HostCols(*(_t(a) for a in args))


def _tree_cols(seed: int):
    """A random tree per cell (root, rows, a rack) over the 12 hosts, its
    limits tight enough to bind."""
    rng = np.random.default_rng(seed)
    n = 5
    parent = [-1, 0, 0, 1, 2]
    anc_nodes = np.eye(n, dtype=bool)
    for m in range(1, n):
        anc_nodes[m] |= anc_nodes[parent[m]]
    anc = np.zeros((S, H, n), dtype=bool)
    limit = np.zeros((S, n))
    for s in range(S):
        host_node = rng.integers(1, n, H)
        anc[s] = anc_nodes[host_node]
        limit[s] = anc[s].sum(0) * rng.uniform(150.0, 330.0, n)
    depth = np.broadcast_to(anc_nodes.sum(1) - 1, (S, n)).copy()
    return (rk.TreeCols(anc, limit, depth),
            kernels.TreeCols(_t(anc), _t(limit), _t(depth)))


def test_utilizations_and_triggers_match_reference():
    cols = _columns(0)
    eff = cols["demand"] * 0.3
    mem = cols["demand"] * 2.0
    want = rk.host_utilizations(np, _hosts(cols, rk), cols["caps"], eff,
                                mem, cols["host_mem"])
    got = kernels.host_utilizations(_hosts(cols, kernels),
                                    _t(cols["caps"]), _t(eff), _t(mem),
                                    _t(cols["host_mem"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    on = cols["on"]
    for high in (0.5, 0.81):
        np.testing.assert_array_equal(
            kernels.dpm_hot_mask(_t(on), *got, high).numpy(),
            rk.dpm_hot_mask(np, on, *want, high))
    for low in (0.45, 1.5):
        np.testing.assert_array_equal(
            kernels.dpm_all_low(_t(on), *got, low).numpy(),
            rk.dpm_all_low(np, on, *want, low))


def test_stable_argsort_and_sequential_cumsum():
    """Ties keep index order (NumPy's ``kind="stable"``), and the prefix
    sum adds left to right, bitwise NumPy's ``cumsum``."""
    x = np.array([[3.0, 1.0, 1.0, 2.0, 1.0, np.inf, np.inf, 0.5]])
    np.testing.assert_array_equal(kernels.stable_argsort(_t(x)).numpy(),
                                  np.argsort(x, axis=-1, kind="stable"))
    y = np.random.default_rng(1).uniform(0.0, 1e3, (4, 37))
    np.testing.assert_array_equal(kernels.sequential_cumsum(_t(y)).numpy(),
                                  np.cumsum(y, axis=-1))


def test_util_rank_key_breaks_rounding_ties_by_index():
    """Utilizations a few ULPs apart (BalancePowerCap's equalized hosts,
    trap T5) rank as equal, the lower index first; values further apart
    than 2^-30 keep their order; the key is exact (floor of a power-of-two
    multiple), so every device computes the same bits."""
    u = 0.1 + np.array([3e-17, 0.0, 1e-16, -2e-17, 2e-6, -2e-6])
    key = kernels.util_rank_key(_t(u)).numpy()
    assert kernels.stable_argsort(_t(key)).tolist() == [5, 0, 1, 2, 3, 4]
    assert np.argsort(u, kind="stable").tolist() == [5, 3, 1, 0, 2, 4]
    np.testing.assert_array_equal(key, np.floor(u * 2.0 ** 30))


@pytest.mark.parametrize("with_tree", (False, True), ids=("flat", "tree"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_power_on_funding_matches_reference(seed, with_tree):
    cols = _columns(seed)
    cand = np.array([1, 7, 11])
    cand_off = cols["on"].copy()
    cand_off[np.arange(S), cand[:2].tolist() + [11]] = [False, False, True]
    cols["on"] = cand_off                # two candidates off, one on
    rtree, ptree = _tree_cols(seed) if with_tree else (None, None)
    want = rk.power_on_funding_caps(
        ref_backend.NUMPY, _hosts(cols, rk), cols["caps"], cand,
        cols["util"], cols["demand"], cols["reserved"], cols["budget"],
        0.81, tree=rtree)
    got = kernels.power_on_funding_caps(
        _hosts(cols, kernels), _t(cols["caps"]), _t(cand), _t(cols["util"]),
        _t(cols["demand"]), _t(cols["reserved"]), _t(cols["budget"]), 0.81,
        tree=ptree)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-12,
                               atol=1e-9)
    # The donors that gave anything are the same hosts.
    gave = lambda c: (c < cols["caps"] - 1e-9) & cols["on"]  # noqa: E731
    np.testing.assert_array_equal(gave(got[0].numpy()), gave(want[0]))


@pytest.mark.parametrize("with_tree", (False, True), ids=("flat", "tree"))
def test_power_off_reabsorb_matches_reference(with_tree):
    cols = _columns(3)
    off = np.array([0, 4, 9])
    rtree, ptree = _tree_cols(3) if with_tree else (None, None)
    want = rk.power_off_reabsorb_caps(np, _hosts(cols, rk), cols["caps"],
                                      off, cols["budget"], tree=rtree)
    got = kernels.power_off_reabsorb_caps(
        _hosts(cols, kernels), _t(cols["caps"]), _t(off),
        _t(cols["budget"]), tree=ptree)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    assert (got.numpy()[np.arange(S), off] == 0.0).all()


def _slots(seed: int, fill: float = 0.6):
    rng = np.random.default_rng(seed)
    occ = rng.random((S, H, J)) < fill
    return dict(
        occ=occ,
        eff=np.where(occ, rng.uniform(100.0, 3000.0, (S, H, J)), 0.0),
        mem=np.where(occ, rng.choice([1024.0, 2048.0, 4096.0],
                                     (S, H, J)), 0.0),
        res=np.where(occ & (rng.random((S, H, J)) < 0.3), 500.0, 0.0),
        mig=np.ones((S, H, J), dtype=bool))


@pytest.mark.parametrize("case", ("fits", "unmigratable", "slot_pressure",
                                  "scoped"))
def test_plan_evacuation_matches_reference(case):
    cols = _columns(4, ties=False)
    sl = _slots(4, fill=0.95 if case == "slot_pressure" else 0.5)
    victim = np.array([0, 2, 5])
    cols["on"][np.arange(S), victim] = True
    if case == "unmigratable":
        sl["mig"][1, 2, :] = False
    scope = None
    if case == "scoped":
        scope = np.random.default_rng(5).random((S, H)) < 0.6
    want = rk.plan_evacuation(
        ref_backend.NUMPY, _hosts(cols, rk), cols["caps"], victim,
        sl["occ"], sl["eff"], sl["mem"], sl["res"], sl["mig"],
        cols["host_mem"], 0.9, scope=scope)
    got = kernels.plan_evacuation(
        _hosts(cols, kernels), _t(cols["caps"]), _t(victim), _t(sl["occ"]),
        _t(sl["eff"]), _t(sl["mem"]), _t(sl["res"]), _t(sl["mig"]),
        _t(cols["host_mem"]), 0.9,
        scope=None if scope is None else _t(scope))
    for name, g, w in zip(("ok", "order", "dests", "n_evac", "pressure"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    ok, pressure = want[0], want[4]
    if case == "fits":
        assert ok.any()
    if case == "unmigratable":
        assert not ok[1]
    if case == "slot_pressure":
        assert pressure.any()


def test_move_slot_sequences_match_reference():
    """Random moves, each landing in the destination's first free slot and
    reusing the holes earlier moves left, every column carried."""
    rng = np.random.default_rng(6)
    sl = _slots(6, fill=0.5)
    work = dict(occ=sl["occ"], reservation=sl["res"],
                limit=np.where(sl["occ"], 4000.0, np.inf),
                weights=np.where(sl["occ"], 1000.0, 1e-12),
                migratable=sl["mig"], cpu=sl["eff"], mem=sl["mem"])
    pwork = {k: _t(v) for k, v in work.items()}
    for _ in range(40):
        do = rng.random(S) < 0.8
        src = rng.integers(0, H, S)
        j = rng.integers(0, J, S)
        do &= work["occ"][np.arange(S), src, j]
        dst = rng.integers(0, H, S)
        work, moved = rk.move_slot(np, work, do, src, j, dst)
        pwork, pmoved = kernels.move_slot(pwork, _t(do), _t(src), _t(j),
                                          _t(dst))
        np.testing.assert_array_equal(pmoved.numpy(), moved)
        for k in work:
            np.testing.assert_array_equal(pwork[k].numpy(), work[k],
                                          err_msg=k)
    assert work["occ"].sum() == sl["occ"].sum()


# --------------------------------------------------------------- run_dpm
def _dpm_cluster(mod, demands_per_host, cap=250.0, standby=0,
                 migratable=True):
    """``tests/test_dpm_edges.py``'s cluster, in either package."""
    Host_, VM_, Snap_ = mod
    hosts, vms = [], []
    for i, dems in enumerate(demands_per_host):
        hosts.append(Host_(f"h{i}", _spec(Host_), power_cap=cap))
        for k, d in enumerate(dems):
            vms.append(VM_(vm_id=f"vm{i}_{k}", demand=d, mem_demand=1024.0,
                           memory_mb=8 * 1024, host_id=f"h{i}",
                           migratable=migratable))
    for s in range(standby):
        hosts.append(Host_(f"standby{s}", _spec(Host_), power_cap=0.0,
                           powered_on=False))
    return Snap_(hosts, vms, power_budget=cap * len(demands_per_host))


def _spec(host_cls):
    if host_cls is RefHost:
        return REF_HOST
    from repro_torch.core.power_model import PAPER_HOST
    return PAPER_HOST


REF = (RefHost, RefVM, RefSnapshot)


def _port():
    from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
    return (Host, VirtualMachine, ClusterSnapshot)


def _u(util, n):
    return util * REF_HOST.managed_capacity(250.0) / n


DPM_CASES = {
    "power_on_wins": ([[_u(.95, 2)] * 2, [_u(.05, 2)] * 2, [_u(.05, 2)] * 2],
                      1, dict(stable_window_s=0.0),
                      dict(low_since={"h1": 0.0, "h2": 0.0}, now=1e5)),
    "hot_no_standby": ([[_u(.95, 2)] * 2] * 2, 0, {}, {}),
    "window_open": ([[_u(.05, 2)] * 2] * 2, 0, dict(stable_window_s=300.0),
                    dict(low_since={"h0": 0.0, "h1": 0.0}, now=299.0)),
    "window_elapsed": ([[_u(.05, 2)] * 2] * 2, 0,
                       dict(stable_window_s=300.0),
                       dict(low_since={"h0": 0.0, "h1": 0.0}, now=300.0)),
    "recent_change": ([[_u(.05, 2)] * 2] * 2, 0,
                      dict(stable_window_s=300.0),
                      dict(low_since={"h0": 0.0, "h1": 0.0}, now=1000.0,
                           last_config_change=900.0)),
    "no_target": ([[_u(.44, 4)] * 4, [_u(.44, 4)] * 4, [_u(.10, 2)] * 2], 0,
                  dict(stable_window_s=0.0, target_util=0.45),
                  dict(low_since={f"h{i}": 0.0 for i in range(3)}, now=1e5)),
    "evacuates_lightest": ([[_u(.2, 2)] * 2, [_u(.04, 2)] * 2,
                            [_u(.2, 2)] * 2], 0, dict(stable_window_s=0.0),
                           dict(low_since={f"h{i}": 0.0 for i in range(3)},
                                now=1e5)),
}


@pytest.mark.parametrize("case", sorted(DPM_CASES) + ["unmigratable"])
def test_run_dpm_matches_reference(case):
    """``tests/test_dpm_edges.py``'s scenarios through both packages: the
    same recommendation, evacuations in the same order."""
    if case == "unmigratable":
        dems, standby, cfg, kw = DPM_CASES["window_elapsed"]
        mig = False
    else:
        (dems, standby, cfg, kw), mig = DPM_CASES[case], True
    want = ref_dpm.run_dpm(_dpm_cluster(REF, dems, standby=standby,
                                        migratable=mig),
                           ref_dpm.DPMConfig(**cfg), **kw)
    got = dpm.run_dpm(_dpm_cluster(_port(), dems, standby=standby,
                                   migratable=mig),
                      dpm.DPMConfig(**cfg), **kw)
    assert (got.power_on, got.power_off, got.evacuations) == (
        want.power_on, want.power_off, want.evacuations)


def test_capacity_at_util_matches_reference():
    for dems, on in (([1000.0, 1000.0], False), ([0.0, 0.0], True),
                     ([600.0, 400.0], True)):
        r = _dpm_cluster(REF, [dems])
        p = _dpm_cluster(_port(), [dems])
        r.hosts["h0"].powered_on = p.hosts["h0"].powered_on = on
        assert dpm.capacity_at_util(p, "h0", 0.5) == \
            ref_dpm.capacity_at_util(r, "h0", 0.5)


# ---------------------------------------------------- redistribution
def _strained(mod, util, n_hosts=3, cap=250.0, vms_per_host=5):
    """``tests/test_redistribute_edges.py``'s fully allocated cluster."""
    Host_, VM_, Snap_ = mod
    spec = _spec(Host_)
    hosts = [Host_(f"h{i}", spec, power_cap=cap) for i in range(n_hosts)]
    hosts.append(Host_("standby", spec, power_cap=0.0, powered_on=False))
    per_vm = util * spec.managed_capacity(cap) / vms_per_host
    vms = [VM_(vm_id=f"vm{i}_{k}", demand=per_vm, memory_mb=8 * 1024,
               mem_demand=1024.0, host_id=f"h{i}")
           for i in range(n_hosts) for k in range(vms_per_host)]
    return Snap_(hosts, vms, power_budget=n_hosts * cap)


def _topped(mod, caps, demand, budget):
    Host_, VM_, Snap_ = mod
    spec = _spec(Host_)
    hosts = [Host_(f"h{i}", spec, power_cap=c) for i, c in enumerate(caps)]
    vms = [VM_(vm_id=f"v{i}", demand=demand, host_id=f"h{i}")
           for i in range(len(caps))]
    return Snap_(hosts, vms, power_budget=budget)


REDIST_CASES = {
    "drains_to_floor": (lambda m: _strained(m, 0.6), "standby"),
    "donors_pinned": (lambda m: _strained(m, 0.95), "standby"),
    "candidate_on": (lambda m: _topped(m, [250.0, 200.0], 20000.0, 540.0),
                     "h1"),
    "candidate_at_peak": (lambda m: _topped(m, [320.0, 250.0], 1000.0,
                                            1000.0), "h0"),
}


@pytest.mark.parametrize("case", sorted(REDIST_CASES))
def test_redistribution_matches_reference(case):
    build, cand = REDIST_CASES[case]
    want, w_granted = ref_for_on(build(REF), cand, ref_dpm.DPMConfig())
    got, g_granted = redistribute_for_power_on(build(_port()), cand,
                                               dpm.DPMConfig())
    assert g_granted == pytest.approx(w_granted, rel=1e-12, abs=1e-9)
    for hid, h in want.hosts.items():
        assert got.hosts[hid].power_cap == pytest.approx(
            h.power_cap, rel=1e-12, abs=1e-9), hid
    if case != "candidate_at_peak":
        off = "h0"
        w_off = ref_after_off(build(REF), off)
        g_off = redistribute_after_power_off(build(_port()), off)
        for hid, h in w_off.hosts.items():
            assert g_off.hosts[hid].powered_on == h.powered_on
            assert g_off.hosts[hid].power_cap == pytest.approx(
                h.power_cap, rel=1e-12, abs=1e-9), hid


# ------------------------------------------------- object-plane manager
def _churn_build(events=(), spare=False, budget_per_host=300.0):
    """``tests/test_batch_parity.py``'s valley-then-burst on 3 hosts / 30
    VMs (reference objects): DPM powers host0 off mid-run, the burst powers
    it back on with Powercap Redistribution funding its cap."""
    hosts = [RefHost(f"host{i}", REF_HOST, power_cap=250.0)
             for i in range(3)]
    if spare:
        hosts.append(RefHost("spare", REF_HOST, power_cap=120.0,
                             powered_on=False))
    vms, traces = [], {}
    for i in range(30):
        vm = RefVM(vm_id=f"vm{i}", vcpus=1, memory_mb=8 * 1024,
                   host_id=f"host{i // 10}")
        vms.append(vm)
        traces[vm.vm_id] = ref_workloads.step_trace([
            (0.0, 1200.0, 2 * 1024), (700.0, 300.0, 2 * 1024),
            (1400.0, 2400.0, 2 * 1024)])
    snap = RefSnapshot(hosts, vms, power_budget=3 * budget_per_host)
    cfg = RefSimConfig(duration_s=2100.0, drs_first_at_s=300.0,
                       record_timeline=False, instant_migrations=True,
                       power_events=tuple(events))
    return snap, traces, cfg


def _managers(policy, dpm_on=True):
    rcfg = RefManagerConfig(powercap_enabled=(policy == "cpc"),
                            dpm_enabled=dpm_on)
    rcfg.dpm = ref_dpm.DPMConfig(stable_window_s=150.0)
    rcfg.balancer = ref_balancer.BalancerConfig(max_moves=0)
    pcfg = ManagerConfig(powercap_enabled=(policy == "cpc"),
                         dpm_enabled=dpm_on,
                         dpm=dpm.DPMConfig(stable_window_s=150.0),
                         balancer=BalancerConfig(max_moves=0))
    return RefManager(rcfg), CloudPowerCapManager(pcfg, "cpu")


def test_manager_invocation_with_dpm_matches_reference():
    """One invocation in the valley: the same evacuations, power-off and
    reabsorbed caps, with the same prerequisite edges."""
    snap, traces, _ = _churn_build()
    for v in snap.vms.values():
        v.demand, v.mem_demand = traces[v.vm_id](800.0)
    psnap, _ = from_reference_snapshot(snap, traces)
    low = {h: 0.0 for h in snap.hosts}
    rman, pman = _managers("cpc")
    want = rman.run_invocation(snap, now=800.0, low_since=low)
    got = pman.run_invocation(psnap, now=800.0, low_since=low)

    def shape(res):
        ids = {a.action_id: i for i, a in enumerate(res.actions)}
        return [(a.kind, a.target, getattr(a, "dest", None),
                 tuple(ids[p] for p in a.prereqs)) for a in res.actions]

    assert shape(got) == shape(want)
    assert any(a.kind == "power_off" for a in got.actions)
    for wa, ga in zip(want.actions, got.actions):
        if wa.kind == "set_power_cap":
            assert ga.value == pytest.approx(wa.value, rel=1e-12)
    assert got.notes == want.notes


# ------------------------------------------------------ batched engine
def _ref_cells(policies=("cpc", "static"), dpm_on=True, **kw):
    cells = []
    for policy in policies:
        snap, traces, cfg = _churn_build(**kw)
        cells.append(RefCell(name=policy, snapshot=snap, traces=traces,
                             config=cfg, powercap_enabled=(policy == "cpc"),
                             dpm_enabled=dpm_on))
    return cells


def _port_cells(ref_cells):
    out = []
    for c in ref_cells:
        snap, traces = from_reference_snapshot(c.snapshot, c.traces)
        out.append(BatchCell(name=c.name, snapshot=snap, traces=traces,
                             config=from_reference_config(c.config),
                             powercap_enabled=c.powercap_enabled,
                             dpm_enabled=c.dpm_enabled))
    return out


def _assert_batch(got, want):
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_array_equal(got.final_on, want.final_on)
    np.testing.assert_array_equal(got.final_occ, want.final_occ)
    np.testing.assert_allclose(got.final_caps, want.final_caps, rtol=RTOL)


CHURN = {
    "power_off_then_on": dict(),
    "scripted_events": dict(dpm_on=False, events=(
        (700.0, "host1", False), (1400.0, "host1", True))),
    "boot_during_pending_power_off": dict(spare=True, events=(
        (920.0, "spare", True),)),
}


@pytest.mark.parametrize("case", sorted(CHURN))
def test_churn_scenarios_match_reference(x64, case):
    """``tests/test_batch_parity.py``'s churn scenarios: the port over the
    reference's pack, and over cells it packs itself (bitwise the same
    pack), against the reference's batched engine."""
    ref = RefSimulator(_ref_cells(**CHURN[case]),
                       dpm=rk.DPMParams(stable_window_s=150.0),
                       slot_slack=3.0)
    want = ref.run()
    got = from_reference_pack(ref._arrays, ref._static, device="cpu").run()
    _assert_batch(got, want)
    own = BatchedSimulator(_port_cells(_ref_cells(**CHURN[case])),
                           dpm=kernels.DPMParams(stable_window_s=150.0),
                           slot_slack=3.0, device="cpu")
    for k in PACK_KEYS:
        np.testing.assert_array_equal(own._arrays[k], ref._arrays[k],
                                      err_msg=k)
    _assert_batch(own.run(), want)
    if case == "power_off_then_on":
        assert (got.power_offs == 1).all() and (got.power_ons == 1).all()
        assert (got.vmotions == 10).all() and got.cap_changes[0] > 0
        assert got.final_on[0, 0]
    if case == "boot_during_pending_power_off":
        assert (want.power_offs >= 1).all()


def test_churn_scenario_matches_reference_vector_engine():
    """The same lifecycle on the port's vector engine against the
    reference's (the object plane's DPM and redistribution)."""
    for policy in ("cpc", "static"):
        snap, traces, cfg = _churn_build()
        rman, pman = _managers(policy)
        want = RefVectorSimulator(snap, rman, traces, cfg).run()
        psnap, ptraces = from_reference_snapshot(*_churn_build()[:2])
        got = VectorSimulator(psnap, pman, ptraces, from_reference_config(cfg),
                              device="cpu").run()
        for f in COUNTS:
            assert getattr(got.acc, f) == getattr(want.acc, f), (policy, f)
        for f in FLOATS:
            np.testing.assert_allclose(getattr(got.acc, f),
                                       getattr(want.acc, f), rtol=RTOL)
        assert [h.powered_on for h in got.final.hosts.values()] == \
            [h.powered_on for h in want.final.hosts.values()]


def test_slot_pressure_raises_instead_of_diverging():
    cells = _port_cells(_ref_cells(("cpc",)))
    sim = BatchedSimulator(cells, dpm=kernels.DPMParams(stable_window_s=150.0),
                           slot_slack=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="slot_slack"):
        sim.run()


def test_keep_timeseries_is_bitwise_the_reduced_run():
    """Trap T2 in the churn regime: the per-tick series (action counts as
    end-minus-start deltas) fold back to the reduced run bit for bit."""
    cells = _port_cells(_ref_cells(events=((700.0, "host1", False),)))
    kw = dict(dpm=kernels.DPMParams(stable_window_s=150.0), slot_slack=3.0,
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
    assert reduced.power_offs.sum() > 0 and reduced.vmotions.sum() > 0


def test_poisoned_padding_changes_nothing():
    """Trap T3: huge demands in empty slots (the slack an evacuation lands
    in, and the slots it vacates) and occupied-looking slots of a padded
    host that never powers on change no count and no bit of the result."""
    cells = _port_cells(_ref_cells(("cpc",)) + _ref_cells(("static",),
                                                          spare=True))
    kw = dict(dpm=kernels.DPMParams(stable_window_s=150.0), slot_slack=3.0,
              device="cpu")
    clean = BatchedSimulator(cells, **kw)
    dirty = BatchedSimulator(cells, **kw)
    a = dirty._arrays
    empty = ~a["occ"]
    for k in ("cpu_vals", "mem_vals"):
        a[k] = np.where(empty[..., None], 1e12, a[k])
    # Cell 0 has three hosts: its host 3 is padding, never powered on.
    assert not a["exists"][0, 3]
    a["occ"][0, 3, :2] = True
    a["cpu_vals"][0, 3, :2] = 1e12
    a["reservation"][0, 3, :2] = 1e9
    got, want = dirty.run(), clean.run()
    assert not want.final_on[0, 3]
    assert (want.power_offs >= 1).all()
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in FLOATS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.final_caps, want.final_caps)
