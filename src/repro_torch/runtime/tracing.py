"""Spans and counters at the port's layer boundaries, on exactly while a
``torch.profiler`` session records.

A span (:func:`span`) marks one step of a layer: ``generate``
(``repro_torch.serve.generate``), its prefill and each decode step
(``.serve.prefill``, ``.serve.decode_step``), the MoE layer's routing,
dispatch, expert FFN and combine (``repro_torch.moe.*``), the power
event with its manager invocation and router sync
(``repro_torch.power.*``).  With no profiler recording, :func:`span`
returns one shared no-op context.  With one, a span is also the user
annotation ``torch.profiler.record_function`` makes, entered through its C
entry point (a third of its cost under the profiler), so any profile of
the port shows it, and the tracer keeps its own record: an id, its parent (the
innermost open span), its name and attributes, its host start and end on
``time.time_ns()`` (the clock Kineto stamps its events on), and, once the
process has initialized CUDA, a pair of timing events on the stream that
was current when the session began (the port serves on one; looking it up
a span would triple a span's cost under the profiler).  A counter (:func:`count`) adds a host int or a device tensor,
kept by reference and reduced only in :func:`collect`.  Neither launches a
kernel nor waits for the device.

:func:`collect`, called once the profiler has stopped, returns the latest
session's spans and counters.  A span entered with no profiler recording,
or a call of :func:`collect`, closes a session; the next span entered
under a profiler starts a new one.  Spans are parented within one thread
of calls: the port's serving loop runs on one.

    from torch.profiler import profile
    with profile():
        generate(cfg, params, prompt, steps, max_len)
    for s in tracing.collect().spans:
        print(s.name, s.parent, s.ms, s.host_ms)
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Union

import torch

_enabled = torch._C._autograd._profiler_enabled
_annotate = torch._C._autograd._record_function_with_args_enter
_close = torch._C._autograd._record_function_with_args_exit
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    id: int
    parent: Optional[int]           # the enclosing span's id
    name: str
    attrs: dict
    start_ns: int = 0               # host, time.time_ns()
    end_ns: int = 0
    ms: float = 0.0                 # between its CUDA events (else host_ms)
    host_ms: float = 0.0            # from entry to exit, on the host


@dataclasses.dataclass
class Trace:
    """One profiler session's spans, in the order they were entered, and
    counters, each reduced to an int."""

    spans: list
    counters: dict


Value = Union[int, torch.Tensor, Callable[[], Union[int, torch.Tensor]]]


def _reduce(value: Value) -> int:
    if callable(value):
        value = value()
    return int(value.sum()) if isinstance(value, torch.Tensor) else value


class _Open:
    """An entered span: the annotation and the events around its body."""

    __slots__ = ("tracer", "rec", "handle", "events")

    def __init__(self, tracer: "Tracer", rec: Span):
        self.tracer, self.rec, self.events = tracer, rec, None

    def __enter__(self):
        tr = self.tracer
        self.rec.start_ns = time.time_ns()
        self.handle = _annotate(self.rec.name)
        if tr.cuda:
            self.events = tr.event(), tr.event()
            self.events[0].record(tr.stream)
        tr.stack.append(self.rec.id)
        tr.spans.append((self.rec, self.events))
        return self.rec

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.tracer.stream)
        _close(self.handle)
        self.rec.end_ns = time.time_ns()
        stack = self.tracer.stack
        if stack and stack[-1] == self.rec.id:  # else a later session's
            stack.pop()
        return False


class Tracer:
    """The spans and counters of the session being recorded."""

    def __init__(self):
        self.live = False
        self.cuda = False
        self.stream = None
        self.spans: list = []           # (Span, (start, end) events or None)
        self.counters: dict = {}
        self.stack: list = []
        self.pool: list = []            # CUDA timing events, reused
        self.collected: Optional[Trace] = None

    def begin(self) -> None:
        """A new session: the last one's events go back to the pool."""
        for _, events in self.spans:
            if events is not None:
                self.pool.extend(events)
        self.spans, self.counters, self.stack = [], {}, []
        self.collected = None
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.stream = torch.cuda.current_stream() if self.cuda else None
        self.live = True

    def event(self) -> "torch.cuda.Event":
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))

    def open(self, name: str, attrs: dict) -> _Open:
        if not self.live:
            self.begin()
        return _Open(self, Span(len(self.spans),
                                self.stack[-1] if self.stack else None,
                                name, attrs))

    def add(self, name: str, value: Value) -> None:
        if not self.live:
            self.begin()
        self.counters.setdefault(name, []).append(value)

    def collect(self) -> Trace:
        self.live = False
        if self.collected is None:
            if self.cuda:
                torch.cuda.synchronize()
            out = []
            for rec, events in self.spans:
                if not rec.end_ns:
                    continue                    # still open
                rec.host_ms = (rec.end_ns - rec.start_ns) * 1e-6
                rec.ms = (rec.host_ms if events is None
                          else events[0].elapsed_time(events[1]))
                out.append(rec)
            self.collected = Trace(out, {
                k: sum(_reduce(v) for v in vs)
                for k, vs in self.counters.items()})
        return self.collected


_TRACER = Tracer()


def span(name: str, **attrs):
    """A context around one step of a layer; see the module's docstring.
    Entering it gives the :class:`Span` (``None`` with tracing off)."""
    if not _enabled():
        _TRACER.live = False
        return _OFF
    return _TRACER.open(name, attrs)


def count(name: str, value: Value) -> None:
    """Add ``value`` to counter ``name`` while a profiler records:
    an int, a tensor (its sum), or a function of no arguments giving
    either, called in :func:`collect`."""
    if _enabled():
        _TRACER.add(name, value)


def collect() -> Trace:
    """The latest session's spans and counters (empty where no span or
    counter has been recorded); waits for the device once."""
    return _TRACER.collect()
