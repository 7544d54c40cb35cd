"""Power-cap <-> training-plane integration (the reference's
``repro.runtime.power_integration``).

``PowerAwareBatchScheduler`` converts the per-host power caps CloudPowerCap
maintains into per-pod batch shares: a pod capped at 80% throughput gets
80% of the examples, expressed as a weight mask over the fixed-shape global
batch, so nothing changes shape when caps move.  The plan is host NumPy, as
in the reference.

``StragglerMitigator`` answers a pod that persistently lags with a cap
redistribution toward it first: BalancePowerCap (kernel K2 on the GPU,
through :func:`repro_torch.core.balance.balance_power_cap`) over demands
scaled by each host's step-time excess.  Only if caps cannot help does the
caller shrink the straggler's batch share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.balance import BalanceConfig, balance_power_cap
from repro_torch.drs.snapshot import ClusterSnapshot


@dataclasses.dataclass
class BatchPlan:
    examples_per_pod: np.ndarray     # (n_pods,) ints, sum <= global_batch
    weights: np.ndarray              # (global_batch,) {0,1} mask
    shares: np.ndarray               # (n_pods,) capacity fractions

    @property
    def active_examples(self) -> int:
        return int(self.examples_per_pod.sum())


class PowerAwareBatchScheduler:
    """Maps host power caps to per-pod example counts.

    The global batch is laid out pod-major (examples [i*B/P:(i+1)*B/P)
    belong to pod i), so masking the tail of each pod's slice implements
    the uneven split without data movement.
    """

    def __init__(self, global_batch: int, pod_hosts: list[list[str]],
                 hysteresis: float = 0.05):
        self.global_batch = global_batch
        self.pod_hosts = pod_hosts
        self.n_pods = len(pod_hosts)
        assert global_batch % self.n_pods == 0
        self.per_pod = global_batch // self.n_pods
        self.hysteresis = hysteresis
        self._last_shares: Optional[np.ndarray] = None

    def pod_capacities(self, snapshot: ClusterSnapshot) -> np.ndarray:
        return np.asarray([sum(snapshot.hosts[h].managed_capacity
                               for h in hosts) for hosts in self.pod_hosts],
                          dtype=np.float64)

    def plan(self, snapshot: ClusterSnapshot) -> BatchPlan:
        cap = self.pod_capacities(snapshot)
        total = cap.sum()
        shares = (cap / total if total > 0
                  else np.full(self.n_pods, 1.0 / self.n_pods))
        if (self._last_shares is not None and
                np.abs(shares - self._last_shares).max() < self.hysteresis):
            shares = self._last_shares        # hysteresis: keep the old plan
        self._last_shares = shares

        # Step time is set by the slowest pod: pod i processes n_i examples
        # in time n_i / cap_i, so the lockstep split is n_i ~ cap_i with
        # n_i <= per-pod slot count.
        raw = shares * self.global_batch
        n = np.minimum(np.floor(raw), self.per_pod).astype(int)
        # Hand leftover slots back only where they do not raise the
        # lockstep step time.
        step_time = float(np.max(n / np.maximum(cap, 1e-9)))
        leftover = self.global_batch - int(n.sum())
        for _ in range(leftover):
            times = (n + 1) / np.maximum(cap, 1e-9)
            candidates = np.where((times <= step_time * (1 + 1e-9))
                                  & (n < self.per_pod))[0]
            if candidates.size == 0:
                break
            n[candidates[0]] += 1
        weights = np.zeros(self.global_batch, dtype=np.float32)
        for i, ni in enumerate(n):
            weights[i * self.per_pod: i * self.per_pod + ni] = 1.0
        return BatchPlan(examples_per_pod=n, weights=weights, shares=shares)

    def apply(self, batch: dict, plan: BatchPlan) -> dict:
        """Overlay the plan's mask onto a batch dict (weights: (B, S))."""
        w = batch["weights"]
        out = dict(batch)
        out["weights"] = w * torch.as_tensor(plan.weights,
                                             device=w.device)[:, None]
        return out


@dataclasses.dataclass
class StragglerReport:
    step_times: dict[str, float]        # host -> recent mean step seconds


class StragglerMitigator:
    """Cap-first straggler mitigation.

    detect(): a host is a straggler when its step time exceeds the cluster
    median by ``threshold`` for ``patience`` consecutive reports.
    mitigate(): rebalance power caps toward stragglers by treating the
    measured throughput deficit as demand (BalancePowerCap on ``device``,
    ``None``: the GPU); returns the rebalanced snapshot, or None if Watts
    cannot help.
    """

    def __init__(self, threshold: float = 0.15, patience: int = 3,
                 device=None):
        self.threshold = threshold
        self.patience = patience
        self.device = resolve_device(device)
        self._strikes: dict[str, int] = {}

    def detect(self, report: StragglerReport) -> list[str]:
        times = report.step_times
        med = float(np.median(list(times.values())))
        out = []
        for host, t in times.items():
            if t > med * (1 + self.threshold):
                self._strikes[host] = self._strikes.get(host, 0) + 1
                if self._strikes[host] >= self.patience:
                    out.append(host)
            else:
                self._strikes[host] = 0
        return out

    def mitigate(self, snapshot: ClusterSnapshot, report: StragglerReport
                 ) -> Optional[ClusterSnapshot]:
        # Demand proportional to step-time excess, then let powercap
        # balancing move Watts toward the hot hosts.
        med = float(np.median(list(report.step_times.values())))
        for host_id, t in report.step_times.items():
            scale = t / max(med, 1e-9)
            for vm in snapshot.vms_on(host_id):
                vm.demand = vm.demand * scale
        balanced, did = balance_power_cap(snapshot, BalanceConfig(),
                                          self.device)
        return balanced if did else None
