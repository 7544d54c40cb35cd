"""Declarative demand traces and their packed step-function layout.

A trace is a ``t -> (cpu, mem)`` callable carrying a :class:`TraceSpec`, a
(possibly periodic) step function.  :class:`TraceBank` compiles a cluster's
specs into padded arrays, the layout the batched engine evaluates on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

DemandTrace = Callable[[float], tuple[float, float]]  # t -> (cpu MHz, mem MB)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A (periodic) step function: value of the last segment with t0 <= t.

    ``period`` is ``None`` for aperiodic traces; otherwise the segments are
    defined on ``t mod period``.
    """

    segments: tuple                     # ((t0, cpu_mhz, mem_mb), ...) sorted
    period: Optional[float] = None


def spec_trace(spec: TraceSpec) -> DemandTrace:
    """The canonical callable for a declarative spec (the semantics
    :class:`TraceBank` compiles)."""
    segments, period = spec.segments, spec.period

    def trace(t: float) -> tuple[float, float]:
        if period is not None:
            t = t % period
        cpu, mem = segments[0][1], segments[0][2]
        for t0, c, m in segments:
            if t >= t0:
                cpu, mem = c, m
            else:
                break
        return cpu, mem
    trace.spec = spec
    return trace


def traces_from_table(names: Sequence[str], segs: np.ndarray,
                      counts: Optional[np.ndarray] = None,
                      periods: Optional[np.ndarray] = None
                      ) -> dict[str, DemandTrace]:
    """Bulk trace factory.

    ``segs`` is ``(n, k, 3)`` rows of ``(t0, cpu_mhz, mem_mb)`` segments,
    ``counts`` the per-row number of valid segments (default ``k``),
    ``periods`` the per-row period with non-finite meaning aperiodic.
    """
    segs = np.asarray(segs, dtype=np.float64)
    n, k = segs.shape[0], segs.shape[1]
    seg_rows = segs.tolist()
    cnt = ([k] * n if counts is None
           else np.asarray(counts, dtype=np.int64).tolist())
    if periods is None:
        per = [None] * n
    else:
        pa = np.asarray(periods, dtype=np.float64)
        per = [p if f else None
               for p, f in zip(pa.tolist(), np.isfinite(pa).tolist())]
    out: dict[str, DemandTrace] = {}
    for name, row, c, p in zip(names, seg_rows, cnt, per):
        if c != k:
            row = row[:c]
        out[name] = spec_trace(TraceSpec(
            segments=tuple(tuple(s) for s in row), period=p))
    return out


class TraceBank:
    """Array-compiled demand traces for a whole cluster.

    Rows follow the ``vm_order`` given at construction.  Traces without a
    ``spec`` attribute land in ``fallback``; the batched engine refuses
    them.
    """

    def __init__(self, vm_order: Sequence[str]):
        self.vm_order = list(vm_order)
        self.rows = np.zeros(0, dtype=np.int64)
        self.period = np.zeros(0)
        self.bps = np.zeros((0, 1))
        self.cpu_vals = np.zeros((0, 1))
        self.mem_vals = np.zeros((0, 1))
        self.fallback: list[tuple[int, DemandTrace]] = []

    @classmethod
    def from_traces(cls, traces: dict[str, DemandTrace],
                    vm_order: Sequence[str]) -> "TraceBank":
        bank = cls(vm_order)
        row_of = {vid: i for i, vid in enumerate(vm_order)}
        rows, specs = [], []
        for vm_id, trace in traces.items():
            if vm_id not in row_of:
                continue
            spec = getattr(trace, "spec", None)
            if spec is None:
                bank.fallback.append((row_of[vm_id], trace))
            else:
                rows.append(row_of[vm_id])
                specs.append(spec)
        if rows:
            # One flattened scatter over every (vm, segment) pair.
            n = len(rows)
            counts = np.fromiter((len(s.segments) for s in specs),
                                 dtype=np.int64, count=n)
            max_segs = int(counts.max())
            flat = np.asarray([seg for s in specs for seg in s.segments],
                              dtype=np.float64)         # (sum(counts), 3)
            r_idx = np.repeat(np.arange(n), counts)
            c_idx = (np.arange(flat.shape[0])
                     - np.repeat(np.cumsum(counts) - counts, counts))
            bps = np.full((n, max_segs), np.inf)
            cpu = np.zeros((n, max_segs))
            mem = np.zeros((n, max_segs))
            bps[r_idx, c_idx] = flat[:, 0]
            cpu[r_idx, c_idx] = flat[:, 1]
            mem[r_idx, c_idx] = flat[:, 2]
            # Padding repeats the last value so idx overshoot is benign.
            pad_src = np.minimum(np.arange(max_segs)[None, :],
                                 counts[:, None] - 1)
            take = np.arange(n)[:, None]
            bank.rows = np.asarray(rows, dtype=np.int64)
            bank.period = np.fromiter(
                ((np.inf if s.period is None else s.period) for s in specs),
                dtype=np.float64, count=n)
            bank.bps = bps
            bank.cpu_vals = cpu[take, pad_src]
            bank.mem_vals = mem[take, pad_src]
        return bank
