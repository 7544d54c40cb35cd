"""The port's budget trees against the JAX package's.

:class:`repro_torch.core.budget_tree.BudgetTree` and the kernel layer's
``tree_*`` functions against the reference's on the same inputs; the
snapshot's tree plumbing (host-count check, clones, ``effective_tree``,
``tree_respected``); the reference's tree properties
(``tests/test_budget_tree.py``: the manager keeps every node within its
limit, a flat tree is bitwise the scalar answer, funding stops at a
binding row); and the ``two_row`` ``row_contention`` family on both
engines against the reference, with ``over_tree`` within 1e-6.
"""

import contextlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import kernels as rk
from repro.core.budget_tree import BudgetTree as RefTree
from repro.core.manager import CloudPowerCapManager as RefManager
from repro.core.manager import ManagerConfig as RefManagerConfig
from repro.core.power_model import PAPER_HOST as REF_HOST
from repro.core.redistribute import redistribute_for_power_on as ref_for_on
from repro.drs import balancer as ref_balancer
from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
from repro.drs.snapshot import Host as RefHost
from repro.drs.snapshot import VirtualMachine as RefVM
from repro.sim import sweep as ref_sweep
from repro.sim import workloads as ref_workloads
from repro.sim.batch import BatchedSimulator as RefSimulator
from repro.sim.cluster import SimConfig as RefSimConfig
from repro.sim.engine import VectorSimulator as RefVectorSimulator
from repro_torch.convert import from_reference_config, from_reference_snapshot
from repro_torch.core import kernels
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.redistribute import redistribute_for_power_on
from repro_torch.drs.balancer import BalancerConfig
from repro_torch.sim import sweep
from repro_torch.sim.batch import BatchCell, BatchedSimulator
from repro_torch.sim.engine import VectorSimulator

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
RTOL = 1e-9
SEEDS = tuple(range(5))


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


def random_tree(rng, n_hosts, budget, cls=RefTree):
    """``tests/test_budget_tree.py``'s random feasible hierarchy: parents
    precede children, hosts hang off any node, and the non-root limits
    often undercut the pro-rata share."""
    n_nodes = 1 + rng.randint(0, 4)
    parent = [-1] + [int(rng.randint(0, m)) for m in range(1, n_nodes)]
    host_node = rng.randint(0, n_nodes, size=n_hosts)
    probe = cls(parent, [budget] * n_nodes, host_node)
    limit = [float(budget)]
    for m in range(1, n_nodes):
        k = max(int(probe.subtree_hosts(m).sum()), 1)
        limit.append(k * float(rng.uniform(185.0, 330.0)))
    return cls(parent, limit, host_node)


def _port_tree(tree: RefTree) -> BudgetTree:
    return BudgetTree(tree.parent, tree.limit, tree.host_node)


# ------------------------------------------------------------ BudgetTree
@pytest.mark.parametrize("seed", SEEDS)
def test_budget_tree_matches_reference(seed):
    rng = np.random.RandomState(seed)
    n_hosts = int(rng.randint(3, 9))
    ref = random_tree(rng, n_hosts, 300.0 * n_hosts)
    tree = _port_tree(ref)
    for k in ("host_anc", "depth", "pair_host", "pair_node"):
        np.testing.assert_array_equal(getattr(tree, k), getattr(ref, k),
                                      err_msg=k)
    caps = rng.uniform(100.0, 320.0, n_hosts)
    on = rng.rand(n_hosts) > 0.2
    floors = caps * rng.uniform(0.0, 0.6, n_hosts)
    for fn in ("node_sums", "headroom", "host_slack"):
        np.testing.assert_array_equal(getattr(tree, fn)(caps, on),
                                      getattr(ref, fn)(caps, on), err_msg=fn)
    assert tree.max_overshoot(caps, on) == ref.max_overshoot(caps, on)
    np.testing.assert_allclose(tree.project(caps, on, floors),
                               ref.project(caps, on, floors), rtol=1e-12)
    assert tree.is_trivial(300.0 * n_hosts) == ref.is_trivial(
        300.0 * n_hosts)


def test_budget_tree_builders_and_errors():
    two = BudgetTree.two_rows(1000.0, 5, row0_limit=450.0)
    ref = RefTree.two_rows(1000.0, 5, row0_limit=450.0)
    np.testing.assert_array_equal(two.host_anc, ref.host_anc)
    np.testing.assert_array_equal(two.limit, ref.limit)
    assert BudgetTree([-1], [500.0], [0, 0, 0]).is_trivial(500.0)
    assert not BudgetTree([-1], [400.0], [0, 0, 0]).is_trivial(500.0)
    for bad in (([], [], []), ([-1, 0], [1.0], [0]), ([0], [1.0], [0]),
                ([-1, 1], [1.0, 1.0], [0]), ([-1], [-1.0], [0]),
                ([-1], [1.0], [3])):
        with pytest.raises(ValueError):
            BudgetTree(*bad)
    assert two.max_overshoot(np.full(5, 90.0), np.ones(5, dtype=bool)) < 0
    assert two.max_overshoot(np.full(5, 300.0), np.ones(5, dtype=bool)) \
        == pytest.approx(500.0)           # the root: 1,500 W over 1,000


# --------------------------------------------------------- tree kernels
def _cols(seed: int, s: int = 3, h: int = 12):
    rng = np.random.RandomState(seed)
    trees = [random_tree(rng, h, 300.0 * h) for _ in range(s)]
    n = max(t.n_nodes for t in trees)
    anc = np.zeros((s, h, n), dtype=bool)
    limit = np.full((s, n), np.inf)
    depth = np.full((s, n), -1, dtype=np.int64)
    for i, t in enumerate(trees):
        anc[i, :, :t.n_nodes] = t.host_anc
        limit[i, :t.n_nodes] = t.limit
        depth[i, :t.n_nodes] = t.depth
    on = rng.rand(s, h) > 0.2
    caps = np.where(on, rng.uniform(150.0, 330.0, (s, h)), 0.0)
    floors = caps * rng.uniform(0.0, 0.7, (s, h))
    return (rk.TreeCols(anc, limit, depth),
            kernels.TreeCols(_t(anc), _t(limit), _t(depth)), on, caps,
            floors)


@pytest.mark.parametrize("seed", SEEDS)
def test_tree_kernels_match_reference(seed):
    rt, pt, on, caps, floors = _cols(seed)
    host = np.array([0, 5, 11])
    np.testing.assert_array_equal(kernels.tree_anc_at(pt, _t(host)).numpy(),
                                  rk.tree_anc_at(np, rt, host))
    sums = kernels.tree_node_sums(pt, _t(on), _t(caps)).numpy()
    np.testing.assert_allclose(sums, rk.tree_node_sums(np, rt, on, caps),
                               rtol=1e-14)
    head = rk.tree_headroom(np, rt, on, caps)
    np.testing.assert_allclose(
        kernels.tree_headroom(pt, _t(on), _t(caps)).numpy(), head,
        rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(
        kernels.tree_host_slack(pt, _t(head)).numpy(),
        rk.tree_host_slack(np, rt, head))
    np.testing.assert_allclose(
        kernels.tree_project_caps(pt, _t(on), _t(caps), _t(floors)).numpy(),
        rk.tree_project_caps(np, rt, on, caps, floors), rtol=1e-12)
    # Evacuation scope at caps saturating every row.
    full = rk.tree_project_caps(np, rt, on, np.where(on, 400.0, 0.0),
                                floors)
    for victim in (host, np.array([1, 2, 3])):
        np.testing.assert_array_equal(
            kernels.tree_evac_scope(pt, _t(on), _t(full),
                                    _t(victim)).numpy(),
            rk.tree_evac_scope(np, rt, on, full, victim))


def test_power_on_funding_stops_at_a_binding_row():
    """``tests/test_budget_tree.py``'s regression: row 1 (400 W) holds one
    busy host at 320 W, so funding its standby neighbour grants the row's
    80 W even though the rack has 280 W unallocated."""
    def build(mod, with_tree):
        Host_, VM_, Snap_, Tree_, spec = mod
        tree = Tree_.two_rows(1100.0, 4, row0_limit=700.0, row1_limit=400.0)
        hosts = [Host_("h0", spec, power_cap=250.0),
                 Host_("h1", spec, power_cap=250.0),
                 Host_("h2", spec, power_cap=320.0),
                 Host_("h3", spec, power_cap=160.0, powered_on=False)]
        vms = [VM_(vm_id="busy0", vcpus=8, memory_mb=8192.0,
                   demand=33000.0, host_id="h2"),
               VM_(vm_id="idle0", vcpus=1, memory_mb=2048.0, demand=500.0,
                   host_id="h0"),
               VM_(vm_id="idle1", vcpus=1, memory_mb=2048.0, demand=500.0,
                   host_id="h1")]
        return Snap_(hosts, vms, power_budget=1100.0,
                     budget_tree=tree if with_tree else None)

    from repro_torch.core.power_model import PAPER_HOST
    from repro_torch.drs.snapshot import (ClusterSnapshot, Host,
                                          VirtualMachine)
    ref = (RefHost, RefVM, RefSnapshot, RefTree, REF_HOST)
    port = (Host, VirtualMachine, ClusterSnapshot, BudgetTree, PAPER_HOST)
    for with_tree in (True, False):
        want, w_granted = ref_for_on(build(ref, with_tree), "h3")
        got, g_granted = redistribute_for_power_on(build(port, with_tree),
                                                   "h3")
        assert g_granted == pytest.approx(w_granted, rel=1e-12)
        for hid, h in want.hosts.items():
            assert got.hosts[hid].power_cap == pytest.approx(
                h.power_cap, rel=1e-12), hid
    assert g_granted > 80.0 + 1.0           # no tree: the rack pool drains
    got, granted = redistribute_for_power_on(build(port, True), "h3")
    assert granted == pytest.approx(80.0, abs=1e-6)


# -------------------------------------------------------------- snapshot
def test_snapshot_carries_its_tree():
    from repro_torch.core.power_model import PAPER_HOST
    from repro_torch.drs.snapshot import ClusterSnapshot, Host
    hosts = [Host(f"h{i}", PAPER_HOST, power_cap=250.0) for i in range(4)]
    tree = BudgetTree.two_rows(1000.0, 4, row0_limit=450.0)
    with pytest.raises(ValueError, match="host count"):
        ClusterSnapshot(hosts, [], 1000.0,
                        budget_tree=BudgetTree([-1], [1000.0], [0, 0, 0]))
    snap = ClusterSnapshot(hosts, [], 1000.0, budget_tree=tree)
    assert snap.effective_tree() is tree
    assert snap.clone().budget_tree is tree
    assert not snap.tree_respected()          # row 0 holds 500 W > 450 W
    snap.hosts["h0"].power_cap = 200.0
    assert snap.tree_respected()
    flat = ClusterSnapshot(hosts, [], 1000.0,
                           budget_tree=BudgetTree([-1], [1000.0],
                                                  [0, 0, 0, 0]))
    assert flat.effective_tree() is None and flat.tree_respected()


# ------------------------------------------------ manager and engines
def random_cluster(rng, tree, budget, n_hosts):
    """``tests/test_budget_tree.py``'s random cluster (reference objects)."""
    hosts = [RefHost(f"h{i}", REF_HOST,
                     power_cap=float(rng.uniform(170.0, 320.0)),
                     powered_on=bool(rng.rand() > 0.15))
             for i in range(n_hosts)]
    if not any(h.powered_on for h in hosts):
        hosts[0].powered_on = True
    vms = []
    for i in range(2 * n_hosts):
        owner = hosts[i % n_hosts]
        if not owner.powered_on:
            continue
        vms.append(RefVM(
            vm_id=f"vm{i}", vcpus=2, memory_mb=4096.0,
            demand=float(rng.uniform(0.0, 6000.0)),
            mem_demand=float(rng.uniform(256.0, 2048.0)),
            host_id=owner.host_id))
    return RefSnapshot(hosts, vms, power_budget=budget, budget_tree=tree)


def _managers(dpm_on=False):
    rcfg = RefManagerConfig(powercap_enabled=True, dpm_enabled=dpm_on)
    rcfg.balancer = ref_balancer.BalancerConfig(max_moves=0)
    pcfg = ManagerConfig(powercap_enabled=True, dpm_enabled=dpm_on,
                         balancer=BalancerConfig(max_moves=0))
    return RefManager(rcfg), CloudPowerCapManager(pcfg, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_manager_keeps_the_tree_like_the_reference(seed):
    """One invocation on a random tree and cluster: the same actions and
    caps as the reference's manager, every node within its limit."""
    rng = np.random.RandomState(seed)
    n_hosts = int(rng.randint(3, 7))
    budget = 300.0 * n_hosts
    ref_snap = random_cluster(rng, random_tree(rng, n_hosts, budget), budget,
                              n_hosts)
    snap, _ = from_reference_snapshot(ref_snap, {})
    rman, pman = _managers()
    want = rman.run_invocation(ref_snap)
    got = pman.run_invocation(snap)
    assert [(a.kind, a.target) for a in got.actions] == \
        [(a.kind, a.target) for a in want.actions]
    caps = np.array([h.power_cap for h in got.snapshot.hosts.values()])
    on = np.array([h.powered_on for h in got.snapshot.hosts.values()])
    np.testing.assert_allclose(
        caps, [h.power_cap for h in want.snapshot.hosts.values()],
        rtol=1e-12)
    assert snap.budget_tree.max_overshoot(caps, on) <= 1e-6


def star_flat_tree(cls, budget, n_hosts):
    """A tree that runs the tree code but binds nothing: the root at the
    scalar budget and an unlimited leaf per host."""
    return cls([-1] + [0] * n_hosts, [float(budget)] + [np.inf] * n_hosts,
               np.arange(1, n_hosts + 1))


def _burst_build(with_tree):
    """``tests/test_budget_tree.py``'s burst on 4 hosts (reference
    objects)."""
    hosts = [RefHost(f"h{i}", REF_HOST, power_cap=250.0) for i in range(4)]
    vms, traces = [], {}
    for i in range(8):
        vm = RefVM(vm_id=f"vm{i}", vcpus=2, memory_mb=4096.0,
                   host_id=f"h{i % 4}")
        vms.append(vm)
        segs = [(0.0, 800.0, 1024.0)]
        if i % 4 == 0:
            segs.append((400.0, 6000.0, 1024.0))
        traces[vm.vm_id] = ref_workloads.step_trace(segs)
    tree = star_flat_tree(RefTree, 1000.0, 4) if with_tree else None
    snap = RefSnapshot(hosts, vms, power_budget=1000.0, budget_tree=tree)
    cfg = RefSimConfig(duration_s=900.0, drs_first_at_s=300.0,
                       record_timeline=False)
    return snap, traces, cfg


@pytest.mark.parametrize("engine", ("vector", "batch"))
def test_flat_tree_is_bitwise_the_scalar_answer(engine):
    """A tree that binds nothing runs the tree code and changes no bit."""
    out = []
    for with_tree in (False, True):
        ref_snap, ref_traces, cfg = _burst_build(with_tree)
        snap, traces = from_reference_snapshot(ref_snap, ref_traces)
        assert (snap.effective_tree() is None) != with_tree
        if engine == "batch":
            res = BatchedSimulator([BatchCell("c", snap, traces,
                                              from_reference_config(cfg))],
                                   device="cpu").run()
            out.append((res.accumulators(0), res.final_caps[0]))
        else:
            res = VectorSimulator(snap, _managers()[1], traces,
                                  from_reference_config(cfg), device="cpu").run()
            out.append((res.acc, np.array(
                [h.power_cap for h in res.final.hosts.values()])))
    (acc0, caps0), (acc1, caps1) = out
    assert acc0.cap_changes > 0
    for f in COUNTS + ("cpu_payload_mhz_s", "mem_payload_mb_s", "energy_j"):
        assert getattr(acc1, f) == getattr(acc0, f), f
    np.testing.assert_array_equal(caps1, caps0)


def test_row_contention_matches_reference_on_both_engines(x64):
    """``row_contention_specs(sizes=(10,))``: the two-row tree binds row 0,
    on the batched engine (against the reference's, ``over_tree`` within
    1e-6) and on the vector engine (against the reference's)."""
    specs = sweep.row_contention_specs(sizes=(10,))
    ref_specs = ref_sweep.row_contention_specs(sizes=(10,))
    policies = ("cpc", "static")
    ref_cells, _ = ref_sweep._build_batch_cells(ref_specs, policies)
    want = RefSimulator(ref_cells).run()
    cells, keys = sweep.build_batch_cells(specs, policies)
    got = BatchedSimulator(cells, device="cpu").run()
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_allclose(got.final_caps, want.final_caps, rtol=RTOL)
    assert got.over_tree is not None and got.over_tree.max() <= 1e-6
    assert got.cap_changes[0] > 0
    for spec, ref_spec in zip(specs, ref_specs):
        for p in policies:
            w = ref_sweep.run_cell(ref_spec, p, engine="vector")
            g = sweep.run_cell(spec, p, device="cpu")
            for f in COUNTS:
                assert getattr(g, f) == getattr(w, f), (p, f)
            for f in ("cpu_payload_mhz_s", "energy_j"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL)


def test_row_contention_deployment_respects_the_tree():
    snap, _, _ = sweep.build_sweep(sweep.row_contention_specs((10,))[0],
                                   "cpc")
    ref, _, _ = ref_sweep.build_sweep(
        ref_sweep.row_contention_specs((10,))[0], "cpc")
    np.testing.assert_allclose([h.power_cap for h in snap.hosts.values()],
                               [h.power_cap for h in ref.hosts.values()],
                               rtol=1e-12)
    assert snap.tree_respected() and snap.effective_tree() is not None


def test_scripted_boot_is_clipped_to_the_tree_slack():
    """A host returning from maintenance into a saturated row boots within
    the row's headroom, on both vector engines."""
    out = []
    for mod in ("ref", "port"):
        hosts = [RefHost(f"h{i}", REF_HOST, power_cap=250.0)
                 for i in range(4)]
        vms = [RefVM(vm_id=f"v{i}", demand=15000.0, host_id=f"h{i % 4}")
               for i in range(8)]
        tree = RefTree.two_rows(1000.0, 4, row0_limit=420.0)
        hosts[0].power_cap = hosts[1].power_cap = 210.0
        snap = RefSnapshot(hosts, vms, power_budget=1000.0, budget_tree=tree)
        traces = {v.vm_id: ref_workloads.constant(15000.0, 1024.0)
                  for v in vms}
        cfg = RefSimConfig(duration_s=1200.0, record_timeline=False,
                           power_events=((200.0, "h0", False),
                                         (700.0, "h0", True)))
        rman, pman = _managers()
        if mod == "ref":
            res = RefVectorSimulator(snap, rman, traces, cfg).run()
        else:
            psnap, ptraces = from_reference_snapshot(snap, traces)
            res = VectorSimulator(psnap, pman, ptraces, from_reference_config(cfg),
                                  device="cpu").run()
        out.append(res)
    want, got = out
    for f in COUNTS:
        assert getattr(got.acc, f) == getattr(want.acc, f), f
    for f in FLOATS:
        np.testing.assert_allclose(getattr(got.acc, f),
                                   getattr(want.acc, f), rtol=RTOL)
    np.testing.assert_allclose(
        [h.power_cap for h in got.final.hosts.values()],
        [h.power_cap for h in want.final.hosts.values()], rtol=RTOL)
    assert any("power_event h0 on" in e for _, e in got.events)
