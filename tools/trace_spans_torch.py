#!/usr/bin/env python3
"""One traced window of a benchmark cell, read through the port's own
spans (``repro_torch.runtime.tracing``), on one GPU.

    python3 tools/trace_spans_torch.py WORKLOAD [SEED]

Runs the cell's set-up and a window of ``cpcbench``'s harness whose cap
event falls in its first round, traces that round and the next as the
benchmark's ``--trace 1`` run does, and prints one JSON line: the card;
the spans a batch; the distances between a span's host start and end
on the tracer's clock and its ``torch.profiler`` event's (Kineto's);
for each traced batch its synced wall, its prefill's and decode steps'
stream ms and their share of the wall, the share of their host intervals
in which a kernel ran (``cpcbench.trace``'s kernels), and the MoE layer's
four phases summed over the batch's forwards; the counters (the decode
steps a graph replay served among them).
"""

from __future__ import annotations

import bisect
import json
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("route", "dispatch", "experts", "combine")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def clock_us(prof, spans) -> dict:
    """The distances, in µs, between each span's host start and end and
    its profiler event's, matched by name in order of entry: the largest,
    the median, and how many spans exceed 50 µs.  A replayed graph's spans
    (``captured``) have neither host stamps of their own nor events."""
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch.") and \
                e.device_type() == torch.autograd.DeviceType.CPU:
            events[e.name()].append(e)
    mine = defaultdict(list)
    for s in spans:
        if not s.captured:
            mine[s.name].append(s)
    gaps = []
    for name, ss in mine.items():
        es = sorted(events[name], key=lambda e: e.start_ns())
        if len(es) != len(ss):
            raise RuntimeError(f"{name}: {len(ss)} spans, {len(es)} events")
        gaps += [(max(abs(e.start_ns() - s.start_ns),
                      abs(s.end_ns - e.end_ns())) * 1e-3, name, s.start_ns)
                 for s, e in zip(ss, es)]
    gaps.sort()
    t0 = min(g[2] for g in gaps)
    return dict(max_us=gaps[-1][0], median_us=gaps[len(gaps) // 2][0],
                over_50us=sum(g[0] > 50 for g in gaps), spans=len(gaps),
                worst=[(round(us, 1), name, round((t - t0) * 1e-9, 3))
                       for us, name, t in gaps[-5:]])


def busy_share(kernels, spans) -> float:
    """The share of ``spans``' host intervals in which a kernel ran;
    ``kernels`` are ``(start_ns, end_ns)`` on the same clock, sorted."""
    from cpcbench.trace import busy_ns

    starts = [a for a, _ in kernels]
    inside = []
    for s in spans:
        j = max(bisect.bisect_left(starts, s.start_ns) - 1, 0)
        for a, b in kernels[j:bisect.bisect_left(starts, s.end_ns)]:
            if b > s.start_ns:
                inside.append((max(a, s.start_ns), min(b, s.end_ns)))
    return busy_ns(inside) / sum(s.end_ns - s.start_ns for s in spans)


def report(cell, seed: int, device) -> dict:
    """The JSON line's object for ``cell`` (a :class:`cpcbench.spec.Cell`)
    run on ``device``."""
    from cpcbench import harness
    from cpcbench.trace import summarize
    from repro_torch.runtime import tracing

    port = harness.Port(cell.config)
    params = harness.setup(port, cell, seed, device, True)
    win = harness.run_window(port, cell, params, seed, 0.0, device, True)
    trace = tracing.collect()
    kernels = sorted((a, a + d)
                     for _, a, d in summarize(win.profile).kernels)
    by_id = {s.id: s for s in trace.spans}
    roots = [s for s in trace.spans if s.name == "repro_torch.serve.generate"]
    traced = [b for b in win.batches if b.round >= win.event_round]
    batches = []
    for b, root in zip(traced, roots):
        kids = [s for s in trace.spans if s.parent == root.id]
        pre = [s for s in kids if s.name.endswith(".prefill")]
        dec = [s for s in kids if s.name.endswith(".decode_step")]
        moe = defaultdict(float)
        for s in trace.spans:
            if s.name.startswith("repro_torch.moe.") and \
                    by_id[s.parent].parent == root.id:
                moe[s.name.rsplit(".", 1)[1]] += s.ms
        pre_ms = sum(s.ms for s in pre)
        dec_ms = sum(s.ms for s in dec)
        batches.append(dict(
            n=b.n, prompt_len=b.length, wall_ms=b.wall_s * 1e3,
            prefill_ms=pre_ms, decode_ms=dec_ms, decode_steps=len(dec),
            spans_share=(pre_ms + dec_ms) / (b.wall_s * 1e3),
            decode_share=dec_ms / (b.wall_s * 1e3),
            prefill_busy=busy_share(kernels, pre),
            decode_busy=busy_share(kernels, dec),
            moe_ms={p: moe[p] for p in PHASES if p in moe}))
    names = Counter(s.name for s in trace.spans)
    return dict(
        workload=cell.name, seed=seed, torch=torch.__version__,
        spans_a_batch=(sum(names.values()) - names["repro_torch.power.event"]
                       - names["repro_torch.power.invocation"]
                       - names["repro_torch.power.route"]) / len(roots),
        spans=dict(names), counters=trace.counters,
        clock=clock_us(win.profile, trace.spans),
        batches=batches)


def main(argv) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cpcbench import spec

    if not torch.cuda.is_available():
        print("trace_spans_torch: no CUDA card", file=sys.stderr)
        return 2
    seed = int(argv[1]) if len(argv) > 1 else 2**31 + 11
    out = report(spec.find_cell(argv[0]), seed, torch.device("cuda", 0))
    print(json.dumps(dict(out, card=card())), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"trace_spans_torch: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
