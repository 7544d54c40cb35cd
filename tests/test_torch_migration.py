"""The port's migration layer against the JAX package's, instant regime.

Constraint correction and DRS's hill-climb balancer, from the kernel
functions up: ``correct_constraints_slots``, ``balance_migrations`` and
``plan_evacuation``'s rule admission against the reference's NumPy
backend on seeded random cells (every column, move and launch count
bitwise), the rule encoding (``RulesPack``), the object-plane adapters
(``placement.correct_constraints``, ``balancer.balance`` through
``MigrationCore``), and ``tests/test_migration_parity.py``'s instant-regime
scenarios through the port's vector and batched engines against the
reference's vector engine: exact counts of cap changes, vMotions,
power-ons and power-offs, 1e-9 relative on payload and energy, the same
final placement.  Sorts must be stable and sums ordered (trap T1), so the
tests run under ``torch.use_deterministic_algorithms(True)``.
"""

import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import kernels as rk
from repro.core.manager import CloudPowerCapManager as RefManager
from repro.core.manager import ManagerConfig as RefManagerConfig
from repro.drs import balancer as ref_balancer
from repro.drs import dpm as ref_dpm
from repro.drs import placement as ref_placement
from repro.drs.arrays import RulesPack as RefRulesPack
from repro.drs.rules import AffinityRule as RefAffinity
from repro.drs.rules import AntiAffinityRule as RefAnti
from repro.drs.rules import VMHostRule as RefVMHost
from repro.sim.engine import VectorSimulator as RefVectorSimulator
from repro_torch.convert import from_reference_config, from_reference_snapshot
from repro_torch.core import kernels
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import PAPER_HOST
from repro_torch.drs import balancer, placement
from repro_torch.drs import rules as rules_mod
from repro_torch.drs.arrays import RulesPack
from repro_torch.drs.dpm import DPMConfig
from repro_torch.drs.rules import AffinityRule, AntiAffinityRule, VMHostRule
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim.batch import BatchCell, BatchedSimulator
from repro_torch.sim.engine import VectorSimulator

import test_migration_parity as ref_scenarios

FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
          "mem_demand_mb_s", "energy_j")
COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")
POLICIES = ("cpc", "static")
RTOL = 1e-9
S, H, J = 3, 8, 7


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------- kernel functions
RMETA = rk.RulesMeta(n_groups=2, n_anti=2, n_vmhost=2, max_group_members=3,
                     max_anti_members=4)


def _slot_columns(seed: int, rules: bool = True):
    """Random cells ``(S, H, J)``: paper and small hosts (one off), half
    the slots occupied, reservations and limits on some VMs, a few
    unmigratable, two hot hosts; with ``rules``, two affinity groups of
    three split over hosts, two anti-affinity pairs on one host each and
    two VMs off their allowed hosts (``RMETA``'s shape)."""
    rng = np.random.default_rng(seed)
    small = rng.random((S, H)) < 0.4
    on = np.ones((S, H), dtype=bool)
    on[:, 5] = False
    hosts = dict(
        on=on, idle=np.where(small, 120.0, 160.0),
        peak=np.where(small, 240.0, 320.0),
        cap_peak=np.where(small, 19_200.0, 34_800.0),
        hyp=np.where(rng.random((S, H)) < 0.3, 300.0, 0.0),
        host_mem=np.where(small, 65536.0, 98304.0))
    hosts["caps"] = hosts["idle"] + rng.uniform(0.3, 0.9, (S, H)) * (
        hosts["peak"] - hosts["idle"])
    occ = rng.random((S, H, J)) < 0.5
    occ[:, :, -2:] = False                     # room to move into
    hot = (np.arange(H) < 2)[None, :, None]
    work = dict(
        occ=occ,
        reservation=np.where(occ & (rng.random((S, H, J)) < 0.3),
                             rng.uniform(0.0, 2000.0, (S, H, J)), 0.0),
        limit=np.where(occ & (rng.random((S, H, J)) < 0.1),
                       rng.uniform(2000.0, 4000.0, (S, H, J)), np.inf),
        weights=np.where(occ, rng.choice([1000.0, 2000.0], (S, H, J)),
                         1e-12),
        migratable=~(occ & (rng.random((S, H, J)) < 0.05)),
        cpu=np.where(occ, rng.uniform(300.0, 3000.0, (S, H, J))
                     * np.where(hot, 3.0, 1.0), 0.0),
        mem=np.where(occ, rng.uniform(1024.0, 8192.0, (S, H, J)), 0.0))
    if rules:
        grp = np.full((S, H, J), -1, dtype=np.int64)
        allowed = np.ones((S, H, J, H), dtype=bool)
        anti = np.zeros((S, H, J, 2), dtype=bool)
        for s in range(S):
            slots = [tuple(x) for x in np.argwhere(occ[s] & on[s][:, None])]
            pick = [slots[i] for i in rng.permutation(len(slots))[:12]]
            for g in range(2):
                for h, j in pick[3 * g:3 * g + 3]:
                    grp[s, h, j] = g
            for r in range(2):
                h = int(rng.integers(0, 2))
                free = [j for j in range(J - 2) if occ[s, h, j]
                        and grp[s, h, j] < 0 and not anti[s, h, j].any()]
                for j in free[:2]:
                    anti[s, h, j, r] = True
            for h, j in pick[6:8]:
                allowed[s, h, j] = rng.random(H) < 0.4
                allowed[s, h, j, h] = False
        work.update(aff_group=grp, allowed=allowed, anti=anti)
    return hosts, work


def _hosts(cols, mod):
    args = [cols[k] for k in ("on", "idle", "peak", "cap_peak", "hyp")]
    if mod is rk:
        return rk.HostCols(*args)
    return kernels.HostCols(*(_t(a) for a in args))


def _launch(mod, n):
    zeros = (np.zeros((S, H), dtype=np.int64), np.zeros(S, dtype=np.int64))
    return zeros if mod is rk else tuple(_t(z) for z in zeros)


def _assert_same(got, want):
    """``(work, moves, n_moves, pressure, launch)`` of both packages."""
    gw, gm, gn, gp, (glh, gln) = got
    ww, wm, wn, wp, (wlh, wln) = want
    assert set(gw) == set(ww)
    for k in ww:
        np.testing.assert_array_equal(gw[k].numpy(), ww[k], err_msg=k)
    for g, w in ((gm, wm), (gn, wn), (gp, wp), (glh, wlh), (gln, wln)):
        np.testing.assert_array_equal(g.numpy(), w)


LIMITS = {"ungated": rk.MigrationLimits(),
          "slots": rk.MigrationLimits(slots_per_host=1),
          "bandwidth": rk.MigrationLimits(bandwidth=3)}


@pytest.mark.parametrize("gate", sorted(LIMITS))
@pytest.mark.parametrize("seed", range(3))
def test_correct_constraints_slots_matches_reference(seed, gate):
    cols, work = _slot_columns(seed)
    enabled = np.array([True, True, False])
    bound = RMETA.move_bound
    out = {}
    for mod in (rk, kernels):
        hosts = _hosts(cols, mod)
        if mod is rk:
            capacity = rk.managed_capacity(np, hosts, cols["caps"])
            w = {k: v.copy() for k, v in work.items()}
            args = (ref_backend.NUMPY, hosts, capacity, w, cols["host_mem"],
                    RMETA, enabled, np.full((S, bound, 3), -1, np.int64),
                    np.zeros(S, np.int64))
            limits = LIMITS[gate]
        else:
            capacity = kernels.managed_capacity(hosts, _t(cols["caps"]))
            args = (hosts, capacity, {k: _t(v) for k, v in work.items()},
                    _t(cols["host_mem"]), kernels.RulesMeta(*RMETA),
                    _t(enabled), torch.full((S, bound, 3), -1),
                    torch.zeros(S, dtype=torch.int64))
            limits = kernels.MigrationLimits(*LIMITS[gate])
        out[mod] = mod.correct_constraints_slots(
            *args, limits=limits, launch=_launch(mod, S))
    _assert_same(out[kernels], out[rk])
    assert (out[rk][2] > 0).any()


@pytest.mark.parametrize("gate", sorted(LIMITS))
@pytest.mark.parametrize("seed", range(3))
def test_balance_migrations_matches_reference(seed, gate):
    cols, work = _slot_columns(seed)
    enabled = np.array([True, True, False])
    params = rk.MigrationParams(max_moves=6, contention_threshold=0.5)
    out = {}
    for mod in (rk, kernels):
        hosts = _hosts(cols, mod)
        if mod is rk:
            args = (ref_backend.NUMPY, hosts, cols["caps"],
                    {k: v.copy() for k, v in work.items()}, cols["host_mem"],
                    params, RMETA, enabled,
                    np.full((S, 6, 3), -1, np.int64), np.zeros(S, np.int64))
            limits = LIMITS[gate]
        else:
            args = (hosts, _t(cols["caps"]),
                    {k: _t(v) for k, v in work.items()},
                    _t(cols["host_mem"]), kernels.MigrationParams(*params),
                    kernels.RulesMeta(*RMETA), _t(enabled),
                    torch.full((S, 6, 3), -1),
                    torch.zeros(S, dtype=torch.int64))
            limits = kernels.MigrationLimits(*LIMITS[gate])
        out[mod] = mod.balance_migrations(*args, limits=limits,
                                          launch=_launch(mod, S))
    _assert_same(out[kernels], out[rk])
    assert (out[rk][2] > 0).any()


def test_plan_evacuation_with_rules_matches_reference():
    """``plan_evacuation``'s VM-host and anti-affinity admission (counting
    evacuees placed earlier in the plan) against the reference's."""
    for seed in range(4):
        cols, work = _slot_columns(seed)
        rng = np.random.default_rng(seed)
        victim = rng.integers(0, 2, S)
        eff = np.where(work["occ"], np.clip(work["cpu"], work["reservation"],
                                            work["limit"]) / 4.0, 0.0)
        args = [cols["caps"], victim, work["occ"], eff, work["mem"] / 4.0,
                work["reservation"] / 4.0, work["migratable"],
                cols["host_mem"], 0.6]
        want = rk.plan_evacuation(ref_backend.NUMPY, _hosts(cols, rk), *args,
                                  allowed=work["allowed"], anti=work["anti"])
        got = kernels.plan_evacuation(
            _hosts(cols, kernels), *[_t(a) if isinstance(a, np.ndarray)
                                     else a for a in args],
            allowed=_t(work["allowed"]), anti=_t(work["anti"]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_move_slot_restores_the_rule_pads():
    """A moved VM's rule columns travel with it; its old slot takes the
    reference's pads (no group, allowed everywhere, in no anti rule)."""
    _, work = _slot_columns(0)
    do = np.array([True, True, True])
    src, dst = np.array([0, 1, 2]), np.array([3, 4, 6])
    j = np.argmax(work["occ"][np.arange(S), src], axis=-1)
    want, wmoved = rk.move_slot(np, {k: v.copy() for k, v in work.items()},
                                do, src, j, dst)
    got, gmoved = kernels.move_slot({k: _t(v) for k, v in work.items()},
                                    _t(do), _t(src), _t(j), _t(dst))
    np.testing.assert_array_equal(gmoved.numpy(), wmoved)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, pad in (("aff_group", -1), ("allowed", True), ("anti", False)):
        assert kernels.SLOT_PAD[k] == rk.SLOT_PAD[k] == pad
        assert (got[k][np.arange(S), src, j] == pad).all()


def test_poisoned_padding_changes_no_decision():
    """Trap T3 in the migration layer: huge demands, reservations and
    memory, foreign affinity groups, anti-affinity memberships and empty
    allowed masks in the empty slots (the slots moves land in, and the
    extra correction slots) change no move, no launch and no occupied
    slot."""
    cols, work = _slot_columns(5)
    dirty = dict(work)
    empty = ~work["occ"]
    for k, v in (("cpu", 1e12), ("mem", 1e12), ("reservation", 1e9),
                 ("limit", 0.0), ("aff_group", 0), ("migratable", False)):
        dirty[k] = np.where(empty, v, work[k])
    dirty["anti"] = work["anti"] | empty[..., None]
    dirty["allowed"] = work["allowed"] & ~empty[..., None]
    params = kernels.MigrationParams(max_moves=6, contention_threshold=0.5)
    runs = []
    for w in (work, dirty):
        hosts = _hosts(cols, kernels)
        tw = {k: _t(v) for k, v in w.items()}
        cap = kernels.managed_capacity(hosts, _t(cols["caps"]))
        tw, moves, n, pressure, launch = kernels.correct_constraints_slots(
            hosts, cap, tw, _t(cols["host_mem"]), kernels.RulesMeta(*RMETA),
            torch.ones(S, dtype=torch.bool), torch.full((S, 12, 3), -1),
            torch.zeros(S, dtype=torch.int64),
            limits=kernels.MigrationLimits(slots_per_host=2), launch=None)
        tw, bmoves, bn, bpressure, launch = kernels.balance_migrations(
            hosts, _t(cols["caps"]), tw, _t(cols["host_mem"]), params,
            kernels.RulesMeta(*RMETA), torch.ones(S, dtype=torch.bool),
            torch.full((S, 6, 3), -1), torch.zeros(S, dtype=torch.int64),
            limits=kernels.MigrationLimits(slots_per_host=2), launch=launch)
        occ = tw["occ"]
        runs.append((moves, n, bmoves, bn, pressure | bpressure, *launch,
                     occ, *(torch.where(occ if tw[k].ndim == 3
                                        else occ[..., None], tw[k], 0)
                            for k in sorted(tw) if k != "occ")))
    for g, w in zip(*runs):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert int(runs[0][1].sum() + runs[0][3].sum()) > 0


# --------------------------------------------------------- rule encoding
def test_rules_pack_encoding():
    vm_index = {f"vm{i}": i for i in range(6)}
    host_index = {f"h{i}": i for i in range(3)}
    rules = [("Affinity", ("vm0", "vm1")), ("Affinity", ("vm1", "vm2")),
             ("Anti", ("vm3", "vm4")), ("VMHost", ("vm5", {"h0", "h2"}))]

    def build(aff, anti, vmhost):
        return [aff(a) if k == "Affinity" else anti(a) if k == "Anti"
                else vmhost(a[0], frozenset(a[1])) for k, a in rules]

    want = RefRulesPack.from_rules(build(RefAffinity, RefAnti, RefVMHost),
                                   vm_index, host_index)
    got = RulesPack.from_rules(build(AffinityRule, AntiAffinityRule,
                                     VMHostRule), vm_index, host_index)
    for f in ("n_groups", "n_anti", "n_vmhost", "max_group_members",
              "max_anti_members"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("affinity_group", "anti_member", "allowed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert tuple(got.meta()) == tuple(want.meta())
    assert got.meta().move_bound == want.meta().move_bound == 3 + 1 + 2
    assert got.n_groups == 1 and list(got.allowed[5]) == [True, False, True]


# ------------------------------------------------------- object plane
def _paper_snapshot(rules, n_hosts=4, per_host=6, seed=0):
    """Hosts at 250 W with VMs of random demand (and 500 MHz reservations)
    placed round robin, in both packages."""
    from repro.core.power_model import PAPER_HOST as REF_HOST
    from repro.drs.snapshot import ClusterSnapshot as RefSnapshot
    from repro.drs.snapshot import Host as RefHost
    from repro.drs.snapshot import VirtualMachine as RefVM

    rng = np.random.RandomState(seed)
    demands = rng.uniform(800.0, 3000.0, n_hosts * per_host)
    ref = RefSnapshot(
        [RefHost(f"host{i}", REF_HOST, power_cap=250.0)
         for i in range(n_hosts)],
        [RefVM(vm_id=f"vm{i}", reservation=500.0, demand=float(d),
               mem_demand=2048.0, host_id=f"host{i % n_hosts}")
         for i, d in enumerate(demands)],
        power_budget=250.0 * n_hosts, rules=rules)
    return ref, from_reference_snapshot(ref, {})[0]


def test_correct_constraints_matches_reference():
    """The object adapter's moves and final placement (three rule kinds
    violated at once), at current and at fundable capacity."""
    from repro.core import redivvy as ref_redivvy
    from repro_torch.core import redivvy

    rules = [RefAffinity(("vm0", "vm1")), RefAnti(("vm4", "vm8")),
             RefVMHost("vm2", frozenset({"host0", "host1"}))]
    for fundable in (False, True):
        ref, snap = _paper_snapshot(rules)
        kw, rkw = {}, {}
        if fundable:
            ref = ref_redivvy.get_flexible_power(ref)
            snap = redivvy.get_flexible_power(snap)
            kw = dict(capacity_fn=redivvy.fundable_capacity)
            rkw = dict(capacity_fn=ref_redivvy.fundable_capacity)
        want = ref_placement.correct_constraints(ref, **rkw)
        got = placement.correct_constraints(snap, device="cpu", **kw)
        assert got == want and len(got) >= 3
        assert not rules_mod.all_violations(snap)
        for vm_id, dest in got:
            assert snap.vms[vm_id].host_id == dest


def test_fits_and_place_respect_rules():
    rules = [RefAnti(("vm0", "vm1")),
             RefVMHost("vm2", frozenset({"host0", "host3"}))]
    ref, snap = _paper_snapshot(rules)
    for vm in ("vm0", "vm1", "vm2", "vm3"):
        for h in snap.hosts:
            assert placement.fits(snap, vm, h) == ref_placement.fits(
                ref, vm, h), (vm, h)
        assert placement.place(snap, vm) == ref_placement.place(ref, vm)
    assert not placement.fits(snap, "vm0", "host1")
    assert not placement.fits(snap, "vm2", "host1")


@pytest.mark.parametrize("seed", range(4))
def test_balancer_matches_reference(seed):
    """The hill-climb on a cluster piled onto two hosts: the reference's
    moves, under no gate and under a shared launch budget."""
    from repro.core.migration_core import LaunchBudget as RefBudget
    from repro_torch.core.migration_core import LaunchBudget

    for limits in (None, rk.MigrationLimits(slots_per_host=1)):
        ref, snap = _paper_snapshot([], seed=seed)
        for i, (rv, pv) in enumerate(zip(ref.vms.values(),
                                         snap.vms.values())):
            rv.host_id = pv.host_id = f"host{i % 2}"
        ref.invalidate_host_sums()
        snap.invalidate_host_sums()
        rb = RefBudget(limits, 4) if limits else None
        pb = (LaunchBudget(kernels.MigrationLimits(*limits), 4)
              if limits else None)
        want = ref_balancer.balance(ref, ref_balancer.BalancerConfig(
            max_moves=8), rb)
        got = balancer.balance(snap, balancer.BalancerConfig(max_moves=8),
                               pb, device="cpu")
        assert got == want and len(want) > 0
        if limits:
            np.testing.assert_array_equal(pb.launch_h.numpy(), rb.launch_h)
            assert len(want) <= 2


def test_multiple_affinity_groups_anchoring_same_host():
    """Two groups anchored on the fullest host both gather there (the
    headroom of ``move_bound`` extra slots)."""
    hosts = [Host(f"host{i}", PAPER_HOST, power_cap=320.0) for i in range(4)]
    vms = [VirtualMachine(vm_id=f"{g}{i}", reservation=res if i == 0
                          else 10.0, demand=200.0, mem_demand=256.0,
                          host_id=f"host{i}")
           for g, res in (("a", 100.0), ("b", 90.0)) for i in range(4)]
    snap = ClusterSnapshot(hosts, vms, power_budget=4 * 320.0, rules=[
        AffinityRule(("a0", "a1", "a2", "a3")),
        AffinityRule(("b0", "b1", "b2", "b3"))])
    moves = placement.correct_constraints(snap, device="cpu")
    assert len(moves) == 6
    assert not rules_mod.all_violations(snap)
    assert all(v.host_id == "host0" for v in snap.vms.values())


def test_affinity_retries_other_member_hosts():
    """When the anchor's host cannot admit the group, the group gathers on
    another member's host."""
    hosts = [Host("h0", PAPER_HOST, power_cap=320.0),
             Host("h1", PAPER_HOST, power_cap=320.0)]
    vms = [VirtualMachine(vm_id="big", reservation=10_000.0, demand=10_000.0,
                          host_id="h0", mem_demand=512.0),
           VirtualMachine(vm_id="filler", reservation=23_000.0,
                          demand=23_000.0, host_id="h0", mem_demand=512.0),
           VirtualMachine(vm_id="small", reservation=2_000.0, demand=2_000.0,
                          host_id="h1", mem_demand=512.0)]
    snap = ClusterSnapshot(hosts, vms, power_budget=640.0,
                           rules=[AffinityRule(("big", "small"))])
    assert placement.correct_constraints(snap, device="cpu") == [
        ("big", "h1")]
    assert not rules_mod.all_violations(snap)


def test_fit_check_uses_cached_host_sums(monkeypatch):
    """The fit check reads the snapshot's cached per-host sums, never a
    rescan of the VMs."""
    _, snap = _paper_snapshot([RefAnti(("vm0", "vm1"))])
    snap.mem_demand_on("host0")
    calls = []
    monkeypatch.setattr(ClusterSnapshot, "vms_on",
                        lambda self, h: calls.append(h) or [])
    for _ in range(50):
        placement.fits(snap, "vm0", "host2")
    assert calls == []


def test_host_sum_cache_tracks_moves():
    _, snap = _paper_snapshot([])
    rng = np.random.RandomState(7)
    hosts, vm_ids = list(snap.hosts), list(snap.vms)
    snap.mem_demand_on(hosts[0])
    for _ in range(200):
        snap.move_vm(vm_ids[rng.randint(len(vm_ids))],
                     hosts[rng.randint(len(hosts))])
    for h in hosts:
        np.testing.assert_allclose(
            snap.mem_demand_on(h), sum(v.mem_demand for v in snap.vms_on(h)))
        np.testing.assert_allclose(
            snap.cached_cpu_reserved(h),
            sum(v.reservation for v in snap.vms_on(h)))


# ------------------------------------- scenarios through both engines
def _managers(policy, max_moves=8, dpm_enabled=False):
    rcfg = RefManagerConfig(powercap_enabled=(policy == "cpc"),
                            dpm_enabled=dpm_enabled)
    rcfg.balancer = ref_balancer.BalancerConfig(max_moves=max_moves)
    pcfg = ManagerConfig(powercap_enabled=(policy == "cpc"),
                         dpm_enabled=dpm_enabled,
                         balancer=balancer.BalancerConfig(
                             max_moves=max_moves))
    if dpm_enabled:
        rcfg.dpm = ref_dpm.DPMConfig(stable_window_s=150.0)
        pcfg.dpm = DPMConfig(stable_window_s=150.0)
    return RefManager(rcfg), CloudPowerCapManager(pcfg, device="cpu")


def hold_scenario(build, max_moves=8, dpm_enabled=False, slot_slack=3.0):
    """One of the reference's scenario builders under cpc and static:
    the reference's vector engine against the port's vector and batched
    engines.  Returns ``{policy: (reference result, port vector result,
    port batch accumulators)}`` and the batch result."""
    out, cells = {}, []
    for policy in POLICIES:
        snap, traces, cfg = build()
        rman, pman = _managers(policy, max_moves, dpm_enabled)
        want = RefVectorSimulator(snap, rman, traces, cfg).run()
        psnap, ptraces = from_reference_snapshot(*build()[:2])
        got = VectorSimulator(psnap, pman, ptraces,
                              from_reference_config(cfg), device="cpu").run()
        out[policy] = (want, got)
        psnap, ptraces = from_reference_snapshot(*build()[:2])
        cells.append(BatchCell(
            name=policy, snapshot=psnap, traces=ptraces,
            config=from_reference_config(cfg),
            powercap_enabled=(policy == "cpc"), dpm_enabled=dpm_enabled,
            balancer_enabled=max_moves > 0))
    res = BatchedSimulator(
        cells, balancer=kernels.MigrationParams(max_moves=max_moves),
        slot_slack=slot_slack,
        dpm=(kernels.DPMParams(stable_window_s=150.0) if dpm_enabled
             else None), device="cpu").run()
    for i, policy in enumerate(POLICIES):
        want, got = out[policy]
        acc = res.accumulators(i)
        for f in COUNTS:
            assert getattr(got.acc, f) == getattr(want.acc, f), (policy, f)
            assert getattr(acc, f) == getattr(want.acc, f), (policy, f)
        for f in FLOATS:
            for a in (got.acc, acc):
                np.testing.assert_allclose(getattr(a, f),
                                           getattr(want.acc, f), rtol=RTOL,
                                           err_msg=(policy, f))
        assert ({v.vm_id: v.host_id for v in got.final.vms.values()}
                == {v.vm_id: v.host_id for v in want.final.vms.values()})
        # The batched engine's final occupancy is the vector engine's.
        hosts = list(got.final.hosts)
        per_host = [len(got.final.vms_on(h)) for h in hosts]
        assert list(res.final_occ[i, :len(hosts)].sum(-1)) == per_host
    return out, res


def test_rule_correction_parity():
    out, _ = hold_scenario(ref_scenarios._rules_build)
    for want, got in out.values():
        assert want.acc.vmotions >= 3
        assert not rules_mod.all_violations(got.final)


def test_balancer_parity_under_contention():
    out, _ = hold_scenario(ref_scenarios._contended_build)
    assert 0 < out["cpc"][0].acc.vmotions < out["static"][0].acc.vmotions


def test_fundable_capacity_fit_parity():
    """Fig. 3: the correction fits only under fundable capacity: cpc
    corrects (with the cap changes that fund it), static cannot."""
    out, _ = hold_scenario(ref_scenarios._cap_blocked_build)
    assert out["cpc"][1].acc.vmotions == 1
    assert out["cpc"][1].acc.cap_changes > 0
    assert not rules_mod.all_violations(out["cpc"][1].final)
    assert out["static"][1].acc.vmotions == 0
    assert rules_mod.all_violations(out["static"][1].final)


def test_rule_aware_dpm_evacuation_parity():
    out, res = hold_scenario(ref_scenarios._churn_rules_build, max_moves=0,
                             dpm_enabled=True)
    got = out["cpc"][1]
    assert got.acc.power_offs == 1 and got.acc.vmotions == 10
    assert not rules_mod.all_violations(got.final)
