"""The port's budget service against the JAX package's, event for event.

Every case of ``tests/test_budget_service.py`` (malformed input and its
error codes, powered-off leaves, limit changes racing a pending power-on,
replays, demand semantics, the router bridge) and the service properties
of ``tests/test_budget_tree.py`` (headroom equal to brute force,
tightening a limit never raising a cap, with their hypothesis variants)
run through both packages on the same events: the answers, the streamed
decisions, the error codes and the final caps, power states and pending
grants must be bitwise equal, and the reference's own assertions hold on
the port's service.  The ``budget_service`` benchmark's replay (50 hosts,
the two-row tree, 4,000 events from seed 0) is held the same way.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.budget_tree import BudgetTree as RefTree
from repro.core.power_model import PAPER_HOST as REF_HOST
from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
from repro.drs.snapshot import Host as RefHost
from repro.drs.snapshot import VirtualMachine as RefVM
from repro.runtime import budget_service as ref_bs
from repro.runtime import serve_loop as ref_serve
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.power_model import PAPER_HOST
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.runtime import budget_service as bs
from repro_torch.runtime import serve_loop

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

SEEDS = tuple(range(5))

#: package -> (BudgetTree, the service module).
PKGS = {"ref": (RefTree, ref_bs), "port": (BudgetTree, bs)}


def ev(pkg: str, name: str, *args):
    """The event ``name`` of package ``pkg``."""
    return getattr(PKGS[pkg][1], name)(*args)


def two_row_service(pkg, row0=700.0, row1=400.0, budget=1100.0):
    """Rows of two hosts each; h3 starts in standby."""
    tree_cls, mod = PKGS[pkg]
    tree = tree_cls.two_rows(budget, 4, row0_limit=row0, row1_limit=row1)
    caps = np.array([250.0, 250.0, 320.0, 0.0])
    on = np.array([True, True, True, False])
    return mod.BudgetService(tree, [f"h{i}" for i in range(4)], caps, on)


def _plain(answer):
    return tuple(answer) if isinstance(answer, tuple) else answer


def _decisions(decisions):
    return [(d.host_id, d.cap_w, d.reason) for d in decisions]


def apply(svc, mod, event):
    """``(answer, decisions, error code)`` of one event."""
    try:
        answer, decisions = svc.handle(event)
    except mod.BudgetServiceError as e:
        return None, [], e.code
    return _plain(answer), _decisions(decisions), None


def assert_same_state(svc, ref):
    for f in ("caps", "on", "pending"):
        np.testing.assert_array_equal(getattr(svc, f), getattr(ref, f))
    np.testing.assert_array_equal(svc.tree.limit, ref.tree.limit)
    assert svc.budget == ref.budget


def both(build, events):
    """Run ``events(pkg)`` through ``build(pkg)``'s service in both
    packages; every output must be equal.  Returns the port's service and
    its outputs."""
    outs, svcs = {}, {}
    for pkg in PKGS:
        svcs[pkg] = build(pkg)
        outs[pkg] = [apply(svcs[pkg], PKGS[pkg][1], e) for e in events(pkg)]
    assert outs["port"] == outs["ref"]
    assert_same_state(svcs["port"], svcs["ref"])
    return svcs["port"], outs["port"]


def replay_both(build, events, **kw):
    reports, svcs = {}, {}
    for pkg in PKGS:
        svcs[pkg] = build(pkg)
        reports[pkg] = svcs[pkg].replay(events(pkg), **kw)
    got, want = reports["port"], reports["ref"]
    assert (got.n_events, got.n_decisions, got.n_errors) == (
        want.n_events, want.n_decisions, want.n_errors)
    assert [_plain(a) for a in got.answers] == [_plain(a)
                                                for a in want.answers]
    assert _decisions(got.decisions) == _decisions(want.decisions)
    assert [c for c, _ in got.errors] == [c for c, _ in want.errors]
    assert_same_state(svcs["port"], svcs["ref"])
    return svcs["port"], got


# -------------------------------------------------------- malformed input
@pytest.mark.parametrize("name,args,code", [
    ("HeadroomQuery", ("nope",), "unknown-host"),
    ("AdmissionQuery", ("nope", 10.0), "unknown-host"),
    ("AdmissionQuery", ("h0", -1.0), "bad-watts"),
    ("AdmissionQuery", ("h0", float("nan")), "bad-watts"),
    ("DemandUpdate", ("h0", float("inf")), "bad-watts"),
    ("DemandUpdate", ("h3", 100.0), "host-off"),
    ("PowerOnRequest", ("h0", 100.0), "already-on"),
    ("PowerOnComplete", ("h0",), "not-pending"),
    ("PowerOff", ("h3",), "host-off"),
    ("NodeLimitChange", (99, 100.0), "unknown-node"),
    ("NodeLimitChange", (1, -10.0), "bad-watts"),
    ("NodeLimitChange", (1, float("nan")), "bad-watts"),
])
def test_malformed_events_raise_structured_codes(name, args, code):
    svc, outs = both(two_row_service, lambda pkg: [ev(pkg, name, *args)])
    assert outs == [(None, [], code)]
    fresh = two_row_service("port")
    np.testing.assert_array_equal(svc.caps, fresh.caps)
    np.testing.assert_array_equal(svc.on, fresh.on)
    assert not svc.pending.any()


def test_unknown_event_type_rejected():
    _, outs = both(two_row_service, lambda pkg: [object()])
    assert outs == [(None, [], "unknown-event")]


@pytest.mark.parametrize("case", ("topology", "invariant"))
def test_bad_construction_rejected(case):
    codes = {}
    for pkg, (tree_cls, mod) in PKGS.items():
        with pytest.raises(mod.BudgetServiceError) as exc:
            if case == "topology":
                tree = tree_cls.two_rows(1000.0, 4, row0_limit=500.0)
                mod.BudgetService(tree, ["h0", "h1"], np.zeros(2),
                                  np.ones(2, bool))
            else:
                tree = tree_cls.two_rows(1000.0, 4, row0_limit=300.0)
                mod.BudgetService(tree, [f"h{i}" for i in range(4)],
                                  np.array([250.0, 250.0, 100.0, 100.0]),
                                  np.ones(4, bool))
        codes[pkg] = exc.value.code
    assert codes == dict.fromkeys(PKGS, {"topology": "bad-topology",
                                         "invariant": "invariant"}[case])


# ------------------------------------------------------ powered-off leaves
def test_powered_off_leaf_consistent_answers():
    svc, outs = both(two_row_service, lambda pkg: [
        ev(pkg, "HeadroomQuery", "h3"), ev(pkg, "AdmissionQuery", "h3", 60.0),
        ev(pkg, "AdmissionQuery", "h3", 200.0),
        ev(pkg, "DemandUpdate", "h3", 100.0)])
    assert outs[0][0] == pytest.approx(80.0)
    assert outs[1][0][0] and outs[1][0][1] == pytest.approx(60.0)
    assert not outs[2][0][0] and outs[2][0][1] == pytest.approx(80.0)
    assert outs[3] == (None, [], "host-off")
    assert svc.admissible("h3", 60.0) == outs[1][0]


def test_double_power_on_rejected_grant_preserved():
    svc, outs = both(two_row_service, lambda pkg: [
        ev(pkg, "PowerOnRequest", "h3", 200.0),
        ev(pkg, "PowerOnRequest", "h3", 50.0)])
    assert outs[0][0] == pytest.approx(80.0)
    assert [d[2] for d in outs[0][1]] == ["power-on-grant"]
    assert outs[1][2] == "already-pending"
    assert svc.caps[3] == pytest.approx(80.0)
    svc.handle(bs.PowerOnComplete("h3"))
    assert svc.on[3] and not svc.pending[3]


# ------------------------------- limit change racing a pending power-on
def test_limit_change_racing_pending_power_on():
    svc, outs = both(two_row_service, lambda pkg: [
        ev(pkg, "PowerOnRequest", "h3", 200.0),
        ev(pkg, "NodeLimitChange", 2, 200.0),
        ev(pkg, "PowerOnComplete", "h3")])
    touched = {h: c for h, c, _ in outs[1][1]}
    assert set(touched) == {"h2", "h3"}
    assert sum(touched.values()) == pytest.approx(200.0)
    assert svc.caps[3] < 80.0
    assert svc.tree.max_overshoot(svc.caps, svc.on) <= 1e-6


def _remapped(pkg, n_events, seed):
    tree_cls, mod = PKGS[pkg]
    feed = mod.synthetic_feed(
        tree_cls.two_rows(1100.0, 4, row0_limit=700.0, row1_limit=400.0),
        n_events=n_events, seed=seed)
    remap = {f"host{i}": f"h{i}" for i in range(4)}
    return [dataclasses.replace(e, host_id=remap[e.host_id])
            if hasattr(e, "host_id") else e for e in feed]


def test_limit_change_never_exposes_violation_midstream():
    svc, report = replay_both(two_row_service,
                              lambda pkg: _remapped(pkg, 500, 3))
    assert report.n_events == len(_remapped("port", 500, 3))
    assert report.n_errors > 0
    assert svc.tree.max_overshoot(svc.caps, svc.on | svc.pending) <= 1e-6
    assert 0.0 < report.p50_us <= report.p99_us


def test_replay_strict_raises_collecting_does_not():
    def events(pkg):
        return [ev(pkg, "HeadroomQuery", "h0"),
                ev(pkg, "DemandUpdate", "nope", 10.0),
                ev(pkg, "HeadroomQuery", "h1")]
    _, report = replay_both(two_row_service, events)
    assert report.n_errors == 1 and report.errors[0][0] == "unknown-host"
    assert report.answers[0] is not None and report.answers[2] is not None
    with pytest.raises(bs.BudgetServiceError):
        two_row_service("port").replay(events("port"), strict=True)


# ------------------------------------------------------- demand semantics
def test_demand_update_clips_raise_to_headroom():
    _, outs = both(two_row_service, lambda pkg: [
        ev(pkg, "DemandUpdate", "h2", 500.0),
        ev(pkg, "DemandUpdate", "h2", 100.0),
        ev(pkg, "DemandUpdate", "h2", 100.0)])
    assert outs[0] == (400.0, [("h2", 400.0, "demand-update")], None)
    assert outs[1][0] == 100.0
    assert outs[2][1] == []


def test_power_off_frees_row_headroom():
    _, outs = both(two_row_service, lambda pkg: [
        ev(pkg, "HeadroomQuery", "h3"), ev(pkg, "PowerOff", "h2"),
        ev(pkg, "HeadroomQuery", "h3")])
    assert outs[0][0] == pytest.approx(80.0)
    assert outs[2][0] == pytest.approx(400.0)


# ----------------------------------------------------- runtime integration
def _snapshot(pkg, tree=True):
    tree_cls = PKGS[pkg][0]
    host_cls, snap_cls, vm_cls, spec = (
        (RefHost, RefSnapshot, RefVM, REF_HOST) if pkg == "ref"
        else (Host, ClusterSnapshot, VirtualMachine, PAPER_HOST))
    if not tree:
        return snap_cls([host_cls("h0", spec, power_cap=200.0)], [],
                        power_budget=300.0)
    hosts = [host_cls(f"h{i}", spec, power_cap=c, powered_on=onf)
             for i, (c, onf) in enumerate(
                 [(250.0, True), (250.0, True), (320.0, True),
                  (0.0, False)])]
    return snap_cls(hosts, [vm_cls(vm_id="vm0", host_id="h0")],
                    power_budget=1100.0,
                    budget_tree=tree_cls.two_rows(1100.0, 4, row0_limit=700.0,
                                                  row1_limit=400.0))


def test_service_from_snapshot_and_router_sync():
    caps = {}
    for pkg, serve in (("ref", ref_serve), ("port", serve_loop)):
        mod = PKGS[pkg][1]
        svc = mod.service_from_snapshot(_snapshot(pkg))
        assert svc.headroom("h3") == pytest.approx(80.0)
        router = serve.CapacityAwareRouter([serve.Replica(f"r{i}", f"h{i}")
                                            for i in range(4)])
        replica_hosts = {f"r{i}": f"h{i}" for i in range(4)}
        seen = []
        mod.sync_router_capacities(svc, router, replica_hosts)
        seen.append(dict(router.capacity))
        svc.handle(mod.PowerOnRequest("h3", 200.0))
        mod.sync_router_capacities(svc, router, replica_hosts)
        seen.append(dict(router.capacity))
        svc.handle(mod.PowerOnComplete("h3"))
        mod.sync_router_capacities(svc, router, replica_hosts)
        seen.append(dict(router.capacity))
        caps[pkg] = seen
    assert caps["port"] == caps["ref"]
    first, pending, done = caps["port"]
    assert first["r0"] == pytest.approx(250.0) and first["r3"] == 0.0
    assert pending["r3"] == 0.0
    assert done["r3"] == pytest.approx(80.0)


def test_service_from_snapshot_without_tree_uses_flat():
    for pkg in PKGS:
        svc = PKGS[pkg][1].service_from_snapshot(_snapshot(pkg, tree=False))
        assert svc.tree.n_nodes == 1
        assert svc.headroom("h0") == pytest.approx(100.0)


# --------------------------------------------- the service's properties
def random_tree(tree_cls, rng, n_hosts, budget):
    """``tests/test_budget_tree.py``'s random feasible hierarchy."""
    n_nodes = 1 + rng.randint(0, 4)
    parent = [-1] + [int(rng.randint(0, m)) for m in range(1, n_nodes)]
    host_node = rng.randint(0, n_nodes, size=n_hosts)
    probe = tree_cls(parent, [budget] * n_nodes, host_node)
    limit = [float(budget)]
    for m in range(1, n_nodes):
        k = max(int(probe.subtree_hosts(m).sum()), 1)
        limit.append(k * float(rng.uniform(185.0, 330.0)))
    return tree_cls(parent, limit, host_node)


def check_tightening_monotone(seed):
    out = {}
    for pkg, (tree_cls, _) in PKGS.items():
        rng = np.random.RandomState(seed)
        n_hosts = int(rng.randint(3, 9))
        budget = 300.0 * n_hosts
        tree = random_tree(tree_cls, rng, n_hosts, budget)
        caps = rng.uniform(0.0, 320.0, n_hosts)
        floors = caps * rng.uniform(0.0, 0.6, n_hosts)
        on = rng.rand(n_hosts) > 0.2
        base = tree.project(caps, on, floors=floors)
        node = int(rng.randint(0, tree.n_nodes))
        lam = float(rng.uniform(0.3, 1.0))
        tight = tree.with_limit(node, float(tree.limit[node]) * lam)
        out[pkg] = (base, tight.project(caps, on, floors=floors))
        assert np.all(base[on] <= caps[on] + 1e-9)
        assert np.all(base[on] >= floors[on] - 1e-9)
        assert np.all(out[pkg][1] <= base + 1e-9)
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)


def _random_service(pkg, seed):
    tree_cls, mod = PKGS[pkg]
    rng = np.random.RandomState(seed)
    n_hosts = int(rng.randint(3, 9))
    budget = 300.0 * n_hosts
    tree = random_tree(tree_cls, rng, n_hosts, budget)
    on = rng.rand(n_hosts) > 0.25
    caps = tree.project(rng.uniform(100.0, 300.0, n_hosts), on)
    return mod.BudgetService(tree, [f"host{i}" for i in range(n_hosts)],
                             caps, on), rng


def check_service_limit_change_monotone(seed):
    def build(pkg):
        return _random_service(pkg, seed)[0]

    def events(pkg):
        svc, rng = _random_service(pkg, seed)
        node = int(rng.randint(0, svc.tree.n_nodes))
        new_limit = float(svc.tree.limit[node]) * float(
            rng.uniform(0.3, 1.0))
        if not np.isfinite(new_limit):
            new_limit = svc.budget * 0.5
        return [ev(pkg, "NodeLimitChange", node, new_limit)]

    before = build("port").caps.copy()
    svc, outs = both(build, events)
    assert np.all(svc.caps[svc.on] <= before[svc.on] + 1e-9)
    for host_id, cap, _ in outs[0][1]:
        assert cap <= before[svc._host(host_id)] + 1e-9


def check_service_headroom_brute_force(seed):
    def build(pkg):
        return _random_service(pkg, seed)[0]

    svc = build("port")
    for h in svc.host_ids:
        assert svc.headroom(h) == pytest.approx(svc.brute_force_headroom(h),
                                                abs=1e-9)
    svc, _ = replay_both(build, lambda pkg: PKGS[pkg][1].synthetic_feed(
        build(pkg).tree, n_events=300, seed=seed))
    ref = build("ref")
    ref.replay(ref_bs.synthetic_feed(ref.tree, n_events=300, seed=seed))
    for h in svc.host_ids:
        assert svc.headroom(h) == ref.headroom(h)
        assert svc.brute_force_headroom(h) == ref.brute_force_headroom(h)
        assert svc.headroom(h) == pytest.approx(svc.brute_force_headroom(h),
                                                abs=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_tightening_never_raises_caps(seed):
    check_tightening_monotone(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_service_limit_change_never_raises_caps(seed):
    check_service_limit_change_monotone(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_service_headroom_matches_brute_force(seed):
    check_service_headroom_brute_force(seed)


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1))
    def test_tightening_monotone_hypothesis(seed):
        check_tightening_monotone(seed)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1))
    def test_service_headroom_hypothesis(seed):
        check_service_headroom_brute_force(seed)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1))
    def test_service_limit_change_monotone_hypothesis(seed):
        check_service_limit_change_monotone(seed)


# ----------------------------------------------- the benchmark's replay
def benchmark_service(pkg, n_hosts=50):
    """``measure_budget_service``'s service (``benchmarks/
    check_regression.py``): the two-row tree, row 0 at 45% of the budget,
    every host on at 250 W projected under the tree."""
    tree_cls, mod = PKGS[pkg]
    budget = 250.0 * n_hosts
    tree = tree_cls.two_rows(budget, n_hosts, row0_limit=0.45 * budget)
    on = np.ones(n_hosts, dtype=bool)
    caps0 = tree.project(np.full(n_hosts, 250.0), on,
                         floors=np.zeros(n_hosts))
    return mod.BudgetService(tree, [f"host{i}" for i in range(n_hosts)],
                             caps0, on)


def test_benchmark_replay_matches_reference():
    svc, report = replay_both(benchmark_service, lambda pkg: PKGS[pkg][
        1].synthetic_feed(benchmark_service(pkg).tree, n_events=4000,
                          seed=0))
    assert report.n_events > 4000 and report.n_decisions > 0
    assert report.n_errors > 0
    ref = benchmark_service("ref")
    ref.replay(ref_bs.synthetic_feed(ref.tree, n_events=4000, seed=0))
    for h in svc.host_ids:
        assert svc.headroom(h) == ref.headroom(h)
        assert abs(svc.headroom(h) - svc.brute_force_headroom(h)) <= 1e-9
