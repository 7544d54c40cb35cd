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

A decode step captured as a CUDA graph (:mod:`repro_torch.runtime
.decode_graph`) runs no Python when it is replayed.  Captured under a
profiler (:func:`captured`), its spans and counters make a
:class:`Template` in place of records: each span a pair of timing events
recorded as the graph's own external event nodes, its counters reduced
into one device tensor by the graph.  After each replay, outside the
replay's decode-step span, :func:`replayed` waits for the card and adds
one span a template entry (same name and attrs, ``captured`` set, ``ms``
from that replay's events, host stamps both at the decode step's exit)
parented to the decode step, and that replay's counters.  With no
profiler recording a capture holds no tracer work.
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
    captured: bool = False          # a replayed graph's: no host time


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


class Template:
    """The spans and counters entered while a CUDA graph is captured under
    a profiler: ``spans`` ``(name, attrs, parent index or None, (start,
    end) external events or None)``; ``fixed`` the counters given as host
    ints, ``names`` those given as tensors, whose values the graph writes
    into ``values`` (one int64 each) at each replay."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: list = []
        self.stack: list = []
        self.counters: list = []
        self.fixed: list = []
        self.names: list = []
        self.values: Optional[torch.Tensor] = None

    def reduce(self) -> None:
        """Reduce the counters, still capturing: a tensor's sum joins
        ``values``, on the device."""
        parts = []
        for name, value in self.counters:
            if callable(value):
                value = value()
            if isinstance(value, torch.Tensor):
                self.names.append(name)
                parts.append(value.sum().to(torch.int64))
            else:
                self.fixed.append((name, value))
        self.counters = []
        if parts:
            self.values = torch.stack(parts)


class _Captured:
    """A span entered while a graph is captured: an entry of its
    template, its events recorded on the capturing stream."""

    __slots__ = ("template", "index")

    def __init__(self, template: Template, name: str, attrs: dict):
        t = template
        self.template, self.index = t, len(t.spans)
        events = (tuple(torch.cuda.Event(enable_timing=True, external=True)
                        for _ in range(2)) if t.cuda else None)
        t.spans.append((name, attrs, t.stack[-1] if t.stack else None,
                        events))

    def __enter__(self):
        t = self.template
        events = t.spans[self.index][3]
        if events is not None:
            events[0].record()
        t.stack.append(self.index)
        return None

    def __exit__(self, *exc):
        t = self.template
        events = t.spans[self.index][3]
        if events is not None:
            events[1].record()
        if t.stack and t.stack[-1] == self.index:
            t.stack.pop()
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
        self.template: Optional[Template] = None    # while capturing

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

    def open(self, name: str, attrs: dict):
        if self.template is not None:
            return _Captured(self.template, name, attrs)
        if not self.live:
            self.begin()
        return _Open(self, Span(len(self.spans),
                                self.stack[-1] if self.stack else None,
                                name, attrs))

    def add(self, name: str, value: Value) -> None:
        if self.template is not None:
            self.template.counters.append((name, value))
            return
        if not self.live:
            self.begin()
        self.counters.setdefault(name, []).append(value)

    def replayed(self, template: Template, parent: Span) -> None:
        """One replay's spans and counters (the module's docstring)."""
        if template.cuda:
            torch.cuda.synchronize()
        ids = []
        for name, attrs, up, events in template.spans:
            rec = Span(len(self.spans), parent.id if up is None else ids[up],
                       name, dict(attrs), parent.end_ns, parent.end_ns,
                       captured=True)
            if events is not None:
                rec.ms = events[0].elapsed_time(events[1])
            ids.append(rec.id)
            self.spans.append((rec, None))
        for name, value in template.fixed:
            self.add(name, value)
        if template.values is not None:
            for name, value in zip(template.names,
                                   template.values.tolist()):
                self.add(name, value)

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
                if events is not None:
                    rec.ms = events[0].elapsed_time(events[1])
                elif not rec.captured:
                    rec.ms = rec.host_ms
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


@contextlib.contextmanager
def captured():
    """Around a CUDA graph's capture: while a profiler records, the spans
    and counters entered go to a :class:`Template`, which this yields and
    reduces before the capture ends; else it yields ``None`` and the
    capture holds no tracer work."""
    if not _enabled():
        _TRACER.live = False
        yield None
        return
    tr = _TRACER
    if not tr.live:
        tr.begin()
    template = Template(tr.cuda)
    tr.template = template
    try:
        yield template
    finally:
        tr.template = None
    template.reduce()


def replayed(template: Optional[Template], parent) -> None:
    """After one replay of a graph captured with ``template``, outside
    the decode-step span ``parent`` (the :class:`Span` it entered as),
    while a profiler records: that replay's spans and counters; waits
    for the card.  Nothing where either is ``None`` or no profiler
    records."""
    if template is not None and parent is not None and _enabled():
        _TRACER.replayed(template, parent)
