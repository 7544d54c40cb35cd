"""Declarative demand traces and their packed step-function layout.

A trace is a ``t -> (cpu, mem)`` callable carrying a :class:`TraceSpec`, a
(possibly periodic) step function; the generators for the paper's three
experiments build them.  :class:`TraceBank` compiles a cluster's specs into
padded arrays: the batched engine packs them, and the vector engine
evaluates every VM's demand at time ``t`` on the device with
:meth:`TraceBank.eval`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import resolve_device

DemandTrace = Callable[[float], tuple[float, float]]  # t -> (cpu MHz, mem MB)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A (periodic) step function: value of the last segment with t0 <= t.

    ``period`` is ``None`` for aperiodic traces; otherwise the segments are
    defined on ``t mod period``.
    """

    segments: tuple                     # ((t0, cpu_mhz, mem_mb), ...) sorted
    period: Optional[float] = None


def _with_spec(fn: DemandTrace, spec: TraceSpec) -> DemandTrace:
    fn.spec = spec
    return fn


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
    return _with_spec(trace, spec)


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


def constant(cpu_mhz: float, mem_mb: float) -> DemandTrace:
    return _with_spec(lambda t: (cpu_mhz, mem_mb),
                      TraceSpec(segments=((0.0, cpu_mhz, mem_mb),)))


def step_trace(segments: list[tuple[float, float, float]]) -> DemandTrace:
    """``segments``: [(t_start, cpu_mhz, mem_mb), ...] sorted by t_start."""
    def trace(t: float) -> tuple[float, float]:
        cpu, mem = segments[0][1], segments[0][2]
        for t0, c, m in segments:
            if t >= t0:
                cpu, mem = c, m
            else:
                break
        return cpu, mem
    return _with_spec(trace, TraceSpec(segments=tuple(
        (float(t0), float(c), float(m)) for t0, c, m in segments)))


def burst(base_cpu: float, burst_cpu: float, mem_mb: float,
          t_start: float, t_end: float) -> DemandTrace:
    """Paper Sec. V-B: flat, spike in [t_start, t_end), flat again."""
    return step_trace([(0.0, base_cpu, mem_mb),
                       (t_start, burst_cpu, mem_mb),
                       (t_end, base_cpu, mem_mb)])


def prime_time(off_cpu: float, prime_cpu: float, off_mem: float,
               prime_mem: float, period_s: float = 86400.0,
               prime_start_frac: float = 0.0,
               prime_frac: float = 0.5) -> DemandTrace:
    """Paper Sec. V-D: trading VMs idle half the day, heavy the other half."""
    def trace(t: float) -> tuple[float, float]:
        phase = (t % period_s) / period_s
        in_prime = (prime_start_frac <= phase <
                    prime_start_frac + prime_frac)
        return ((prime_cpu, prime_mem) if in_prime else (off_cpu, off_mem))

    # Periodic step form on t mod period.
    t_on = prime_start_frac * period_s
    t_off = (prime_start_frac + prime_frac) * period_s
    prime_vals = (prime_cpu, prime_mem)
    off_vals = (off_cpu, off_mem)
    if prime_start_frac + prime_frac >= 1.0:
        # The phase lives in [0, 1), so a window crossing 1.0 runs to the
        # period's end (the callable above never wraps it around).
        if prime_start_frac <= 0.0:
            segs = [(0.0, *prime_vals)]
        else:
            segs = [(0.0, *off_vals), (t_on, *prime_vals)]
    elif prime_start_frac <= 0.0:
        segs = [(0.0, *prime_vals), (t_off, *off_vals)]
    else:
        segs = [(0.0, *off_vals), (t_on, *prime_vals), (t_off, *off_vals)]
    return _with_spec(trace, TraceSpec(segments=tuple(segs), period=period_s))


class TraceBank:
    """Array-compiled demand traces for a whole cluster.

    Rows follow the ``vm_order`` given at construction.  Traces without a
    ``spec`` attribute land in ``fallback``: :meth:`eval` calls them on the
    host, and the batched engine refuses them.
    """

    def __init__(self, vm_order: Sequence[str]):
        self.vm_order = list(vm_order)
        self.rows = np.zeros(0, dtype=np.int64)
        self.period = np.zeros(0)
        self.bps = np.zeros((0, 1))
        self.cpu_vals = np.zeros((0, 1))
        self.mem_vals = np.zeros((0, 1))
        self.fallback: list[tuple[int, DemandTrace]] = []
        self._on_device: dict = {}

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

    def eval(self, t: float, device=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(rows, cpu, mem)`` tensors on ``device`` (``None``: the GPU)
        for every traced VM at time ``t``: the array rows first, then the
        spec-less traces, evaluated on the host."""
        dev = resolve_device(device)
        if dev not in self._on_device:
            self._on_device[dev] = tuple(
                torch.as_tensor(a, device=dev) for a in (
                    self.rows, self.period, np.isfinite(self.period),
                    self.bps, self.cpu_vals, self.mem_vals))
        rows, period, finite, bps, cpu_vals, mem_vals = self._on_device[dev]
        if rows.numel():
            # np.mod(t, inf) is t, but torch.remainder(t, inf) is NaN:
            # aperiodic rows take t as it is.
            phase = torch.where(finite, torch.remainder(t, period), t)
            idx = torch.clamp_min((bps <= phase[:, None]).sum(1) - 1, 0)
            cpu = torch.gather(cpu_vals, 1, idx[:, None])[:, 0]
            mem = torch.gather(mem_vals, 1, idx[:, None])[:, 0]
        else:
            cpu = mem = torch.zeros(0, dtype=torch.float64, device=dev)
        if self.fallback:
            fb = [fn(t) for _, fn in self.fallback]
            rows = torch.cat([rows, torch.as_tensor(
                [r for r, _ in self.fallback], dtype=torch.int64,
                device=dev)])
            cpu = torch.cat([cpu, torch.as_tensor(
                [c for c, _ in fb], dtype=torch.float64, device=dev)])
            mem = torch.cat([mem, torch.as_tensor(
                [m for _, m in fb], dtype=torch.float64, device=dev)])
        return rows, cpu, mem
