"""Live headroom and admission service over a hierarchical budget tree.

The engines run the CloudPowerCap protocol in batch; this is the
control-plane face of the same budget state: a service that holds the
cluster's :class:`repro_torch.core.budget_tree.BudgetTree` and the live cap
vector, takes an event feed (demand updates, power-on requests, node limit
changes), answers headroom and admission queries, and streams the cap
decisions each event forces.  A serving or training runtime talks to it
between manager invocations: :func:`sync_router_capacities` pushes its caps
into :class:`repro_torch.runtime.serve_loop.CapacityAwareRouter`.

Every mutation keeps the tree invariant (no node's powered-on or pending
cap sum above its limit).  Malformed input raises
:class:`BudgetServiceError` with a stable ``code`` instead of corrupting
state.  :meth:`BudgetService.replay` clocks each event with
``time.perf_counter`` and reports p50/p99 host latencies.

The service is host-side NumPy over the NumPy budget tree and launches no
kernel: an event is microseconds of work, less than a launch.  The
reference is ``repro.runtime.budget_service``; the same feed gives the same
decisions, caps and headroom, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.budget_tree import BudgetTree

#: Tolerance on the tree invariant, matching the engines' budget asserts.
ATOL = 1e-6


class BudgetServiceError(ValueError):
    """Structured service error: ``code`` is machine-readable, stable."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


# ------------------------------------------------------------------ events
@dataclasses.dataclass(frozen=True)
class DemandUpdate:
    """A host asks for a new cap; the grant is clipped to its headroom."""
    host_id: str
    cap_w: float


@dataclasses.dataclass(frozen=True)
class PowerOnRequest:
    """Admit a standby host with ``cap_w`` if its root path has the room;
    the grant is reserved (counts as allocated) until the boot commits."""
    host_id: str
    cap_w: float


@dataclasses.dataclass(frozen=True)
class PowerOnComplete:
    """The pending boot finished: the host joins with its reserved grant."""
    host_id: str


@dataclasses.dataclass(frozen=True)
class PowerOff:
    host_id: str


@dataclasses.dataclass(frozen=True)
class NodeLimitChange:
    """Re-limit one tree node; binding rows are re-projected immediately
    (pending grants included), streaming the forced cap decreases."""
    node: int
    limit_w: float


@dataclasses.dataclass(frozen=True)
class HeadroomQuery:
    host_id: str


@dataclasses.dataclass(frozen=True)
class AdmissionQuery:
    """Would ``cap_w`` more watts fit under every limit on the host's root
    path right now?  Pure query -- no state change."""
    host_id: str
    cap_w: float


Event = Union[DemandUpdate, PowerOnRequest, PowerOnComplete, PowerOff,
              NodeLimitChange, HeadroomQuery, AdmissionQuery]


@dataclasses.dataclass(frozen=True)
class CapDecision:
    host_id: str
    cap_w: float
    reason: str


@dataclasses.dataclass
class ReplayReport:
    n_events: int
    n_decisions: int
    n_errors: int
    p50_us: float
    p99_us: float
    answers: list
    decisions: list
    errors: list


# ----------------------------------------------------------------- service
class BudgetService:
    """Holds the live (tree, caps, power states) and serves events.

    State mirrors the engines' accounting: a host whose power-on is
    pending holds its grant -- it counts toward every ancestor sum and
    the scalar budget exactly like the simulators' budget invariants
    count it -- but delivers nothing until :class:`PowerOnComplete`.
    """

    def __init__(self, tree: BudgetTree, host_ids: Sequence[str],
                 caps: np.ndarray, powered_on: np.ndarray,
                 budget: Optional[float] = None):
        if len(host_ids) != tree.n_hosts:
            raise BudgetServiceError(
                "bad-topology", f"{len(host_ids)} hosts for a tree with "
                f"{tree.n_hosts} leaves")
        self.tree = tree
        self.host_ids = list(host_ids)
        self._idx = {h: i for i, h in enumerate(self.host_ids)}
        self.caps = np.asarray(caps, dtype=np.float64).copy()
        self.on = np.asarray(powered_on, dtype=bool).copy()
        self.pending = np.zeros(tree.n_hosts, dtype=bool)
        self.budget = (float(budget) if budget is not None
                       else float(tree.limit[0]))
        over = tree.max_overshoot(self.caps, self.on)
        if over > ATOL:
            raise BudgetServiceError(
                "invariant", f"initial caps over a node limit by {over:.6f} W")

    # ------------------------------------------------------------- queries
    def _host(self, host_id) -> int:
        i = self._idx.get(host_id)
        if i is None:
            raise BudgetServiceError("unknown-host",
                                     f"no host {host_id!r}")
        return i

    def _alloc_mask(self) -> np.ndarray:
        return self.on | self.pending

    def headroom(self, host_id: str) -> float:
        """Watts the host could gain before some ancestor limit (or the
        scalar budget) binds, with pending grants counted as allocated."""
        i = self._host(host_id)
        mask = self._alloc_mask()
        slack = float(self.tree.host_slack(self.caps, mask)[i])
        budget_room = self.budget - float(self.caps[mask].sum())
        return max(min(slack, budget_room), 0.0)

    def admissible(self, host_id: str, cap_w: float) -> tuple[bool, float]:
        """(fits fully, watts grantable now) for ``cap_w`` *more* watts."""
        if not np.isfinite(cap_w) or cap_w < 0.0:
            raise BudgetServiceError("bad-watts",
                                     f"non-finite or negative {cap_w!r}")
        room = self.headroom(host_id)
        return cap_w <= room + ATOL, min(cap_w, room)

    # ----------------------------------------------------------- mutations
    def handle(self, event: Event):
        """Apply one event; returns (answer, [CapDecision, ...])."""
        decisions: list[CapDecision] = []
        answer = None
        if isinstance(event, HeadroomQuery):
            answer = self.headroom(event.host_id)
        elif isinstance(event, AdmissionQuery):
            answer = self.admissible(event.host_id, event.cap_w)
        elif isinstance(event, DemandUpdate):
            answer = self._demand_update(event, decisions)
        elif isinstance(event, PowerOnRequest):
            answer = self._power_on_request(event, decisions)
        elif isinstance(event, PowerOnComplete):
            self._power_on_complete(event)
        elif isinstance(event, PowerOff):
            self._power_off(event)
        elif isinstance(event, NodeLimitChange):
            self._node_limit_change(event, decisions)
        else:
            raise BudgetServiceError(
                "unknown-event", f"unhandled event type {type(event)!r}")
        self._check_invariant()
        return answer, decisions

    def _demand_update(self, ev: DemandUpdate, decisions: list) -> float:
        i = self._host(ev.host_id)
        if not np.isfinite(ev.cap_w) or ev.cap_w < 0.0:
            raise BudgetServiceError("bad-watts",
                                     f"non-finite or negative {ev.cap_w!r}")
        if not self.on[i] and not self.pending[i]:
            raise BudgetServiceError(
                "host-off", f"{ev.host_id!r} is powered off; use a "
                "PowerOnRequest to admit it")
        cur = float(self.caps[i])
        grant = (cur + self.headroom(ev.host_id) if ev.cap_w > cur
                 else ev.cap_w)
        new = min(ev.cap_w, grant)
        if new != cur:
            self.caps[i] = new
            decisions.append(CapDecision(ev.host_id, new, "demand-update"))
        return new

    def _power_on_request(self, ev: PowerOnRequest, decisions: list):
        i = self._host(ev.host_id)
        if not np.isfinite(ev.cap_w) or ev.cap_w < 0.0:
            raise BudgetServiceError("bad-watts",
                                     f"non-finite or negative {ev.cap_w!r}")
        if self.on[i]:
            raise BudgetServiceError("already-on",
                                     f"{ev.host_id!r} is already powered on")
        if self.pending[i]:
            raise BudgetServiceError(
                "already-pending",
                f"{ev.host_id!r} already has a power-on in flight")
        # The off host's stale cap does not count toward any sum, so the
        # grant is bounded by plain headroom.
        granted = min(ev.cap_w, self.headroom(ev.host_id))
        self.caps[i] = granted
        self.pending[i] = True
        decisions.append(CapDecision(ev.host_id, granted, "power-on-grant"))
        return granted

    def _power_on_complete(self, ev: PowerOnComplete) -> None:
        i = self._host(ev.host_id)
        if not self.pending[i]:
            raise BudgetServiceError(
                "not-pending", f"{ev.host_id!r} has no power-on in flight")
        self.pending[i] = False
        self.on[i] = True

    def _power_off(self, ev: PowerOff) -> None:
        i = self._host(ev.host_id)
        if not self.on[i] and not self.pending[i]:
            raise BudgetServiceError("host-off",
                                     f"{ev.host_id!r} is already off")
        self.on[i] = False
        self.pending[i] = False

    def _node_limit_change(self, ev: NodeLimitChange,
                           decisions: list) -> None:
        node = int(ev.node)
        if not 0 <= node < self.tree.n_nodes:
            raise BudgetServiceError("unknown-node",
                                     f"no tree node {node}")
        if not np.isfinite(ev.limit_w) and ev.limit_w != np.inf:
            raise BudgetServiceError("bad-watts",
                                     f"non-finite limit {ev.limit_w!r}")
        if ev.limit_w < 0.0:
            raise BudgetServiceError("bad-watts",
                                     f"negative limit {ev.limit_w!r}")
        self.tree = self.tree.with_limit(node, ev.limit_w)
        # Tightening may strand allocated watts (pending grants included):
        # re-project immediately so no node sits over its limit, and
        # stream the forced decreases.
        mask = self._alloc_mask()
        new = self.tree.project(self.caps, mask,
                                floors=np.zeros(self.tree.n_hosts))
        changed = mask & (new != self.caps)
        for i in np.nonzero(changed)[0]:
            decisions.append(CapDecision(self.host_ids[i], float(new[i]),
                                         "limit-change"))
        self.caps = np.where(mask, new, self.caps)

    def _check_invariant(self) -> None:
        mask = self._alloc_mask()
        over = self.tree.max_overshoot(self.caps, mask)
        assert over <= ATOL, (
            f"budget tree violated mid-transition: worst node over by "
            f"{over:.6f} W")
        total = float(self.caps[mask].sum())
        assert total <= self.budget + ATOL, (
            f"scalar budget violated: {total:.1f} W > {self.budget:.1f} W")

    # ------------------------------------------------------------- replay
    def replay(self, events: Sequence[Event],
               strict: bool = False) -> ReplayReport:
        """Feed an event stream; clock each event end to end.

        Malformed events are collected (code, event) unless ``strict``;
        state is never left mid-transition either way."""
        lat = np.empty(len(events))
        answers, all_decisions, errors = [], [], []
        for k, ev in enumerate(events):
            t0 = time.perf_counter()
            try:
                answer, decisions = self.handle(ev)
            except BudgetServiceError as e:
                if strict:
                    raise
                errors.append((e.code, ev))
                answer, decisions = None, []
            lat[k] = time.perf_counter() - t0
            answers.append(answer)
            all_decisions.extend(decisions)
        p50, p99 = (np.percentile(lat, (50, 99)) * 1e6
                    if len(events) else (0.0, 0.0))
        return ReplayReport(
            n_events=len(events), n_decisions=len(all_decisions),
            n_errors=len(errors), p50_us=float(p50), p99_us=float(p99),
            answers=answers, decisions=all_decisions, errors=errors)

    # --------------------------------------------------- runtime bridges
    def brute_force_headroom(self, host_id: str) -> float:
        """Headroom recomputed from first principles (per-node Python sums
        over ``subtree_hosts``): the tests hold :meth:`headroom` to it."""
        i = self._host(host_id)
        mask = self._alloc_mask()
        room = self.budget - sum(float(self.caps[j])
                                 for j in range(self.tree.n_hosts)
                                 if mask[j])
        node = int(self.tree.host_node[i])
        while node >= 0:
            members = np.nonzero(self.tree.subtree_hosts(node))[0]
            used = sum(float(self.caps[j]) for j in members if mask[j])
            room = min(room, float(self.tree.limit[node]) - used)
            node = int(self.tree.parent[node])
        return max(room, 0.0)


def sync_router_capacities(service: BudgetService, router,
                           replica_hosts: dict[str, str],
                           capacity_per_watt: float = 1.0) -> None:
    """Push the service's live caps into a
    :class:`repro_torch.runtime.serve_loop.CapacityAwareRouter`: replicas on
    powered-off (or still-pending) hosts weight zero, so dispatch follows
    cap redistribution within one control period."""
    for rid, host_id in replica_hosts.items():
        i = service._host(host_id)
        cap = float(service.caps[i]) if service.on[i] else 0.0
        router.capacity[rid] = max(cap * capacity_per_watt, 0.0)


def service_from_snapshot(snapshot) -> BudgetService:
    """Build a service from a :class:`ClusterSnapshot` carrying a
    ``budget_tree`` (falls back to a flat one-node tree without it)."""
    host_ids = list(snapshot.hosts)
    caps = np.array([snapshot.hosts[h].power_cap for h in host_ids])
    on = np.array([snapshot.hosts[h].powered_on for h in host_ids])
    tree = snapshot.budget_tree or BudgetTree.flat(snapshot.power_budget,
                                                   len(host_ids))
    return BudgetService(tree, host_ids, caps, on,
                         budget=snapshot.power_budget)


def synthetic_feed(tree: BudgetTree, n_events: int = 2000,
                   seed: int = 0) -> list[Event]:
    """A mixed replayable event stream: about 60% queries, 30% demand
    updates, power churn and a few limit changes, over the given tree's
    hosts; the same seed gives the reference's feed."""
    rng = np.random.RandomState(seed)
    hosts = [f"host{i}" for i in range(tree.n_hosts)]
    events: list[Event] = []
    for _ in range(n_events):
        r = rng.rand()
        h = hosts[rng.randint(len(hosts))]
        if r < 0.35:
            events.append(HeadroomQuery(h))
        elif r < 0.6:
            events.append(AdmissionQuery(h, float(rng.uniform(0, 400))))
        elif r < 0.9:
            events.append(DemandUpdate(h, float(rng.uniform(0, 400))))
        elif r < 0.94:
            events.append(PowerOff(h))
        elif r < 0.98:
            events.append(PowerOnRequest(h, float(rng.uniform(0, 300))))
            events.append(PowerOnComplete(h))
        else:
            node = int(rng.randint(tree.n_nodes))
            scale = float(rng.uniform(0.6, 1.2))
            base = (float(tree.limit[node]) if np.isfinite(tree.limit[node])
                    else float(tree.limit[0]))
            events.append(NodeLimitChange(node, base * scale))
    return events
