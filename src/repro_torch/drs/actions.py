"""Recommendation/action model.

A DRS invocation emits zero or more actions; CloudPowerCap's cap changes
are woven into the same list with explicit prerequisite edges, so that
execution order keeps the safety invariants (cap decreases precede the
increases they fund; a host's power-on waits for its funding cap changes).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_counter = itertools.count()


@dataclasses.dataclass
class Action:
    # set_power_cap | migrate | power_on | power_off
    kind: str
    target: str                     # host_id or vm_id
    value: Optional[float] = None   # Watts for set_power_cap
    dest: Optional[str] = None      # target host for migrate
    prereqs: tuple = ()             # action ids that must complete first
    action_id: int = dataclasses.field(default_factory=lambda: next(_counter))
    reason: str = ""

    def __repr__(self) -> str:  # compact, for logs
        extra = f"->{self.dest}" if self.dest else (
            f"={self.value:.1f}W" if self.value is not None else "")
        dep = f" after{list(self.prereqs)}" if self.prereqs else ""
        return f"<{self.action_id}:{self.kind} {self.target}{extra}{dep}>"


def set_power_cap(host_id: str, watts: float, prereqs=(), reason="") -> Action:
    return Action("set_power_cap", host_id, value=watts,
                  prereqs=tuple(prereqs), reason=reason)


def migrate(vm_id: str, dest_host: str, prereqs=(), reason="") -> Action:
    return Action("migrate", vm_id, dest=dest_host, prereqs=tuple(prereqs),
                  reason=reason)


def power_on(host_id: str, prereqs=(), reason="") -> Action:
    return Action("power_on", host_id, prereqs=tuple(prereqs), reason=reason)


def power_off(host_id: str, prereqs=(), reason="") -> Action:
    return Action("power_off", host_id, prereqs=tuple(prereqs), reason=reason)


def order_cap_changes(snapshot, new_caps: dict[str, float], reason: str = ""
                      ) -> list[Action]:
    """Emit SetPowerCap actions, decreases first, increases depending on
    them, so the sum of caps stays within the budget at every point of the
    execution (paper Sec. III-B / IV-B).  A change within 1e-9 W of the
    current cap emits nothing."""
    decreases, increases = [], []
    for host_id, watts in new_caps.items():
        cur = snapshot.hosts[host_id].power_cap
        if watts < cur - 1e-9:
            decreases.append(set_power_cap(host_id, watts, reason=reason))
        elif watts > cur + 1e-9:
            increases.append((host_id, watts))
    dec_ids = tuple(a.action_id for a in decreases)
    inc_actions = [set_power_cap(h, w, prereqs=dec_ids, reason=reason)
                   for h, w in increases]
    return decreases + inc_actions
