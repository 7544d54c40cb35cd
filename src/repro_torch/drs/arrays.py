"""Struct-of-arrays views of a snapshot: the dense slot layout,
:class:`RulesPack` (placement rules as arrays), and :class:`ArrayView`,
flat host and VM columns built in one pass.

The columns are host-side NumPy, as in the reference; the power-model maps
over them run as the kernel layer's tensor functions on the CPU, and the
waterfills behind the entitlement sums run on the view's ``device`` (kernel
K3 on the GPU).  A view does not track later object mutations: build it,
compute, drop it, or carry the ``power_cap`` column and write it back with
:meth:`ArrayView.write_caps`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import kernels


@dataclasses.dataclass
class RulesPack:
    """Placement rules as dense arrays, the kernels' rule encoding.

    * ``affinity_group``: each VM's affinity group (``-1``: none).  VMs in
      several :class:`~repro_torch.drs.rules.AffinityRule` s merge into one
      group (union), numbered in first-rule order.
    * ``anti_member``: ``(R, V)`` membership masks, one a rule; no two
      members of a rule may share a host.
    * ``allowed``: ``(V, H)`` allowed-host masks, the AND of every
      :class:`~repro_torch.drs.rules.VMHostRule` naming the VM (all True
      without one).

    The engines scatter them into the dense slot layout, so admission reads
    rules as array lookups.
    """

    n_groups: int
    n_anti: int
    n_vmhost: int
    max_group_members: int          # the correction loops' bound
    max_anti_members: int           # total anti-rule members
    affinity_group: np.ndarray      # (V,) int64
    anti_member: np.ndarray         # (R, V) bool
    allowed: np.ndarray             # (V, H) bool

    def meta(self) -> kernels.RulesMeta:
        """The kernels' static view of this pack: every engine's loop and
        slack bounds."""
        return kernels.RulesMeta(
            n_groups=self.n_groups, n_anti=self.n_anti,
            n_vmhost=self.n_vmhost,
            max_group_members=self.max_group_members,
            max_anti_members=self.max_anti_members)

    @classmethod
    def from_rules(cls, rules, vm_index: dict, host_index: dict
                   ) -> "RulesPack":
        from repro_torch.drs import rules as rules_mod
        n_vms, n_hosts = len(vm_index), len(host_index)
        group = np.full(n_vms, -1, dtype=np.int64)
        anti_rows: list[np.ndarray] = []
        allowed = np.ones((n_vms, n_hosts), dtype=bool)
        n_vmhost = 0
        # Affinity: union-find over the rules' members, ids in rule order.
        parent: dict[int, int] = {}

        def find(x: int) -> int:
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        aff_rules = [r for r in rules
                     if isinstance(r, rules_mod.AffinityRule)]
        for rule in aff_rules:
            rows = [vm_index[v] for v in rule.vm_ids if v in vm_index]
            for a, b in zip(rows, rows[1:]):
                parent[find(a)] = find(b)
        roots: dict[int, int] = {}
        for rule in aff_rules:
            for v in rule.vm_ids:
                if v not in vm_index:
                    continue
                root = find(vm_index[v])
                if root not in roots:
                    roots[root] = len(roots)
                group[vm_index[v]] = roots[root]
        for rule in rules:
            if isinstance(rule, rules_mod.AntiAffinityRule):
                row = np.zeros(n_vms, dtype=bool)
                for v in rule.vm_ids:
                    if v in vm_index:
                        row[vm_index[v]] = True
                anti_rows.append(row)
            elif isinstance(rule, rules_mod.VMHostRule):
                if rule.vm_id in vm_index:
                    n_vmhost += 1
                    mask = np.zeros(n_hosts, dtype=bool)
                    for h in rule.allowed_hosts:
                        if h in host_index:
                            mask[host_index[h]] = True
                    allowed[vm_index[rule.vm_id]] &= mask
        anti = (np.stack(anti_rows) if anti_rows
                else np.zeros((0, n_vms), dtype=bool))
        n_groups = len(roots)
        sizes = np.bincount(group[group >= 0], minlength=max(n_groups, 1))
        return cls(
            n_groups=n_groups, n_anti=len(anti_rows), n_vmhost=n_vmhost,
            max_group_members=int(sizes.max()) if n_groups else 0,
            max_anti_members=int(anti.sum()),
            affinity_group=group, anti_member=anti, allowed=allowed)


def dense_slot_assignment(snapshot, n_hosts: int):
    """Group placed, powered-on VMs under their resident host.

    Returns ``(vms, order, hj, slot, counts)``: ``vms`` is the snapshot's VM
    list, ``order`` the indices of active VMs sorted stably by host, ``hj``
    and ``slot`` each active VM's (host, slot) coordinate in the dense
    ``(H, J)`` layout, and ``counts`` the per-host occupancy.  The same
    coordinates as the reference's packer, so both engines agree on every
    slot-ordered sum.
    """
    vms = list(snapshot.vms.values())
    host_idx = {hid: j for j, hid in enumerate(snapshot.hosts)}
    host_j = np.array([host_idx.get(v.host_id, -1) for v in vms],
                      dtype=np.int64)
    act = np.array([v.powered_on for v in vms], dtype=bool)
    act &= host_j >= 0
    order = np.nonzero(act)[0]
    hj = host_j[order]
    srt = np.argsort(hj, kind="stable")
    order, hj = order[srt], hj[srt]
    counts = np.bincount(hj, minlength=n_hosts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(hj.size) - np.repeat(starts, counts)
    return vms, order, hj, slot, counts


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass
class ArrayView:
    """Flat arrays over all hosts (index ``h``) and all VMs (index ``v``).

    ``device`` is where :meth:`entitlement_sums` (and what reads it) runs
    its waterfill; ``None`` means the GPU, resolved only when one runs.
    """

    # Host columns.
    host_ids: list
    host_index: dict                    # host_id -> h
    power_cap: np.ndarray               # (H,) Watts
    host_on: np.ndarray                 # (H,) bool
    power_idle: np.ndarray              # (H,)
    power_peak: np.ndarray              # (H,)
    capacity_peak: np.ndarray           # (H,)
    hyp_overhead: np.ndarray            # (H,) Eq. 4's C_H
    host_memory_mb: np.ndarray          # (H,) spec memory, on or off
    # VM columns.
    vm_ids: list
    vm_index: dict                      # vm_id -> v
    vm_host: np.ndarray                 # (V,) host index; -1 when unplaced
    vm_on: np.ndarray                   # (V,) bool
    demand: np.ndarray                  # (V,) MHz
    mem_demand: np.ndarray              # (V,) MB
    reservation: np.ndarray             # (V,) MHz
    limit: np.ndarray                   # (V,) MHz (inf = unlimited)
    shares: np.ndarray                  # (V,)
    vm_memory_mb: np.ndarray            # (V,) configured memory
    mem_reservation: np.ndarray         # (V,) MB
    device: object = None

    # ------------------------------------------------------------- build
    @classmethod
    def from_snapshot(cls, snapshot, device=None) -> "ArrayView":
        hosts = list(snapshot.hosts.values())
        vms = list(snapshot.vms.values())
        host_ids = [h.host_id for h in hosts]
        host_index = {hid: i for i, hid in enumerate(host_ids)}
        vm_ids = [v.vm_id for v in vms]
        f64 = np.float64

        def col(values, dtype=f64):
            return np.array(values, dtype=dtype)

        return cls(
            host_ids=host_ids,
            host_index=host_index,
            power_cap=col([h.power_cap for h in hosts]),
            host_on=col([h.powered_on for h in hosts], bool),
            power_idle=col([h.spec.power_idle for h in hosts]),
            power_peak=col([h.spec.power_peak for h in hosts]),
            capacity_peak=col([h.spec.capacity_peak for h in hosts]),
            hyp_overhead=col([h.spec.hypervisor_overhead for h in hosts]),
            host_memory_mb=col([h.spec.memory_mb for h in hosts]),
            vm_ids=vm_ids,
            vm_index={vid: i for i, vid in enumerate(vm_ids)},
            vm_host=col([host_index.get(v.host_id, -1) for v in vms],
                        np.int64),
            vm_on=col([v.powered_on for v in vms], bool),
            demand=col([v.demand for v in vms]),
            mem_demand=col([v.mem_demand for v in vms]),
            reservation=col([v.reservation for v in vms]),
            limit=col([v.limit for v in vms]),
            shares=col([v.shares for v in vms]),
            vm_memory_mb=col([v.memory_mb for v in vms]),
            mem_reservation=col([v.mem_reservation for v in vms]),
            device=device,
        )

    # ------------------------------------------------------ power model
    @property
    def n_hosts(self) -> int:
        return len(self.host_ids)

    @property
    def n_vms(self) -> int:
        return len(self.vm_ids)

    def host_cols(self, device="cpu") -> kernels.HostCols:
        """The static host columns as the kernel layer's ``(1, H)`` tensor
        bundle, on ``device``."""
        return kernels.HostCols(*(
            torch.as_tensor(c[None], device=device) for c in (
                self.host_on, self.power_idle, self.power_peak,
                self.capacity_peak, self.hyp_overhead)))

    def _host_map(self, fn, col: np.ndarray) -> np.ndarray:
        return fn(self.host_cols(), _t(col)[None])[0].numpy()

    def waterfill_cols(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """Masked per-VM entitlement columns ``(floors, ceils, weights, seg)``.

        Inactive VMs carry zero floor/ceiling (so they allocate nothing)
        with their segment pinned to host 0, the kernel layer's padding
        convention.
        """
        active = self.active_vms()
        floors = np.where(active,
                          np.minimum(self.reservation, self.limit), 0.0)
        ceils = np.where(active, self.effective_demand(), 0.0)
        weights = np.maximum(self.shares, 1e-12)
        seg = np.where(active, self.vm_host, 0)
        return floors, ceils, weights, seg

    def capped_capacity(self, caps: np.ndarray | None = None) -> np.ndarray:
        """Eq. 3 per host; 0 for powered-off hosts."""
        caps = self.power_cap if caps is None else caps
        return self._host_map(kernels.capped_capacity, caps)

    def managed_capacity(self, caps: np.ndarray | None = None) -> np.ndarray:
        """Eq. 4 per host; 0 for powered-off hosts."""
        caps = self.power_cap if caps is None else caps
        return self._host_map(kernels.managed_capacity, caps)

    def peak_managed_capacity(self) -> np.ndarray:
        return kernels.peak_managed_capacity(self.host_cols())[0].numpy()

    def cap_for_managed_capacity(self, capacities: np.ndarray) -> np.ndarray:
        """Inverse of Eq. 4."""
        return self._host_map(kernels.cap_for_managed_capacity, capacities)

    # -------------------------------------------------------- VM rollups
    def active_vms(self) -> np.ndarray:
        """Mask of VMs that are powered on and placed on a powered-on host."""
        placed = self.vm_host >= 0
        on_host = np.zeros(self.n_vms, dtype=bool)
        on_host[placed] = self.host_on[self.vm_host[placed]]
        return self.vm_on & placed & on_host

    def _host_sum(self, values: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return np.bincount(self.vm_host[mask], weights=values[mask],
                           minlength=self.n_hosts)

    def effective_demand(self) -> np.ndarray:
        return np.clip(self.demand, self.reservation, self.limit)

    def cpu_reserved(self) -> np.ndarray:
        return self._host_sum(self.reservation, self.active_vms())

    def mem_reserved(self) -> np.ndarray:
        return self._host_sum(self.mem_reservation, self.active_vms())

    def mem_demand_sum(self) -> np.ndarray:
        return self._host_sum(self.mem_demand, self.active_vms())

    def reserved_power_cap(self) -> np.ndarray:
        """Per-host minimum cap honoring resident reservations (0 when off)."""
        caps = self.cap_for_managed_capacity(self.cpu_reserved())
        return np.where(self.host_on, caps, 0.0)

    def host_demand(self) -> np.ndarray:
        """Per-host sum of resident VMs' effective demand."""
        return self._host_sum(self.effective_demand(), self.active_vms())

    # ----------------------------------------------------- entitlements
    def host_cpu_utilization(self, caps: np.ndarray | None = None
                             ) -> np.ndarray:
        cap = self.managed_capacity(caps)
        return np.where(cap > 0.0,
                        self.host_demand() / np.maximum(cap, 1e-300), 0.0)

    def host_mem_utilization(self) -> np.ndarray:
        ok = self.host_on & (self.host_memory_mb > 0.0)
        return np.where(ok, self.mem_demand_sum()
                        / np.maximum(self.host_memory_mb, 1e-300), 0.0)

    def entitlement_sums(self, caps: np.ndarray | None = None) -> np.ndarray:
        """Per-host sum of VM entitlements: one segmented waterfill over
        every host, on :attr:`device`.

        Only the active VMs go in.  The inactive ones that
        :meth:`waterfill_cols` pins to host 0 with zero floor and ceiling
        would add exact zeros to every sum (and nothing to the bracket), and
        leaving them out keeps host 0's row within K3's width.
        """
        caps = self.power_cap if caps is None else caps
        if self.n_vms == 0:
            return np.zeros(self.n_hosts)
        dev = resolve_device(self.device)
        active = self.active_vms()
        floors, ceils, weights, seg = (c[active]
                                       for c in self.waterfill_cols())
        sums = kernels.entitlement_sums(
            self.host_cols(dev), torch.as_tensor(caps[None], device=dev),
            *(torch.as_tensor(c[None], device=dev)
              for c in (floors, ceils, weights)), seg[None])
        return sums[0].cpu().numpy()

    def normalized_entitlements(self, caps: np.ndarray | None = None
                                ) -> np.ndarray:
        """N_h per host (0 where capacity is 0 or the host is off)."""
        cap = self.managed_capacity(caps)
        ent = self.entitlement_sums(caps)
        return np.where(cap > 0.0, ent / np.maximum(cap, 1e-300), 0.0)

    def imbalance(self, caps: np.ndarray | None = None) -> float:
        """DRS imbalance metric over powered-on hosts."""
        on = self.host_on
        if int(on.sum()) <= 1:
            return 0.0
        return float(self.normalized_entitlements(caps)[on].std())

    # -------------------------------------------------------- writeback
    def write_caps(self, snapshot, caps: np.ndarray) -> None:
        """Write a power-cap column back into the per-object snapshot."""
        for i, hid in enumerate(self.host_ids):
            snapshot.hosts[hid].power_cap = float(caps[i])
