"""Payload / power / migration accounting (paper Tables III-V)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Accumulators:
    cpu_payload_mhz_s: float = 0.0     # useful cycles delivered to VMs
    cpu_demand_mhz_s: float = 0.0      # cycles VMs wanted
    mem_payload_mb_s: float = 0.0
    mem_demand_mb_s: float = 0.0
    energy_j: float = 0.0              # integral of Eq. 1 power
    vmotions: int = 0
    cap_changes: int = 0
    power_ons: int = 0
    power_offs: int = 0
    # Per-VM-tag payload (e.g. "trading" vs "hadoop" in Table V).
    tag_payload: dict = dataclasses.field(default_factory=dict)
    tag_demand: dict = dataclasses.field(default_factory=dict)

    def cpu_satisfaction(self) -> float:
        return (self.cpu_payload_mhz_s / self.cpu_demand_mhz_s
                if self.cpu_demand_mhz_s else 1.0)

    def tag_satisfaction(self, tag: str) -> float:
        d = self.tag_demand.get(tag, 0.0)
        return self.tag_payload.get(tag, 0.0) / d if d else 1.0


def fold_timeseries(timeseries: dict, tick_s: float) -> dict:
    """Reduce per-tick series to run summaries exactly as the engine's tick
    loop does.

    ``timeseries`` maps field name to a ``(T, ...)`` array of per-tick
    rates (floats) or per-tick event counts (ints).  Float fields fold
    left to right as ``acc = acc + ts[t] * tick_s`` -- a multiply and an
    add per tick, the tick loop's own operations, so the result is bitwise
    the reduced path's.  Integer counters sum exactly in any order.
    """
    out = {}
    for k, ts in timeseries.items():
        ts = np.asarray(ts)
        if np.issubdtype(ts.dtype, np.integer):
            out[k] = ts.sum(axis=0)
            continue
        series = torch.from_numpy(ts)
        acc = torch.zeros(series.shape[1:], dtype=series.dtype)
        for t in range(series.shape[0]):
            acc = acc + series[t] * tick_s
        out[k] = acc.numpy()
    return out


def ratio_table(results: dict[str, "Accumulators"], baseline: str
                ) -> dict[str, dict[str, float]]:
    """Each policy's metrics normalized to ``baseline``'s (the paper's
    convention: StaticHigh = 1.00)."""
    base = results[baseline]
    out = {}
    for name, acc in results.items():
        out[name] = {
            "cpu_payload_ratio": (acc.cpu_payload_mhz_s /
                                  base.cpu_payload_mhz_s
                                  if base.cpu_payload_mhz_s else 0.0),
            "mem_payload_ratio": (acc.mem_payload_mb_s /
                                  base.mem_payload_mb_s
                                  if base.mem_payload_mb_s else 0.0),
            "power_ratio": (acc.energy_j / base.energy_j
                            if base.energy_j else 0.0),
            "vmotions": acc.vmotions,
            "cpu_satisfaction": acc.cpu_satisfaction(),
        }
    return out
