"""A ``torch.profiler`` trace of the traced rounds, reduced in memory: no
trace file is written.

The window is the span of the harness's ``cpcbench.traced`` annotation.
The device is busy where a kernel, a copy or a memset runs: the union of
their intervals (the arithmetic of the repository's
``tools/profile_sweep_torch.py:busy_us``).  A launch is a host-side launch
call (the CUDA runtime's ``cudaLaunchKernel*`` or the driver's
``cuLaunchKernel*``).  An idle gap is named by the innermost host op of the
harness's thread that was running at its middle.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from torch.autograd import DeviceType

WINDOW = "cpcbench.traced"
SPANS = "cpcbench."
BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def busy_ns(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0][:60]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    launch_calls: int
    kernels: list            # (name, start_ns, duration_ns) in the window
    device_ops: list         # [[name, seconds], ...], the most device time
    idle_gaps: list          # [[host op, seconds], ...], the most idle time

    def kernel_time(self, *patterns: str) -> tuple:
        """``(launches, device seconds)`` of kernels whose name holds any
        of ``patterns``."""
        hits = [d for name, _, d in self.kernels
                if any(p in name for p in patterns)]
        return len(hits), sum(hits) * 1e-9


def _gap_names(gaps: list, ops: list) -> dict:
    """Idle seconds by the innermost op running at each gap's middle; ops
    are ``(start, end, name)`` nested as one thread's calls are."""
    totals: dict = defaultdict(float)
    ops = sorted(ops)
    stack: list = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "(no host op)"] += (b - a) * 1e-9
    return totals


def kind(e) -> str:
    """The event's kineto activity type, worked out from its device and
    name: the events of torch 2.11 do not state it."""
    name = e.name()
    user = name.startswith(SPANS) or (hasattr(e, "is_user_annotation")
                                      and e.is_user_annotation())
    if e.device_type() != DeviceType.CPU:
        if user:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if user:
        return "user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("cu") and name[2:3].isupper():
        return "cuda_driver"
    return "cpu_op"


def summarize(prof) -> Summary:
    """The summary of a stopped ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and kind(e) == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    busy, kernels, ops, launches = [], [], [], 0
    by_name: dict = defaultdict(float)
    for e in events:
        k = kind(e)
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= w0 or a >= w1:
            continue
        if k in BUSY:
            busy.append((max(a, w0), min(b, w1)))
            name = e.name() if k == "kernel" else k
            by_name[short_name(name)] += e.duration_ns() * 1e-9
            if k == "kernel":
                kernels.append((e.name(), a, e.duration_ns()))
        elif k in ("cuda_runtime", "cuda_driver"):
            launches += "LaunchKernel" in e.name()
        elif k in ("cpu_op", "user_annotation") \
                and e.start_thread_id() == thread:
            ops.append((a, b, e.name()))
    idle, end = [], w0
    for a, b in sorted(busy):
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    if end < w1:
        idle.append((end, w1))
    gaps = _gap_names(idle, ops)
    return Summary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns(busy) * 1e-9,
        launch_calls=launches, kernels=kernels,
        device_ops=[[k, v] for k, v in sorted(by_name.items(),
                                              key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(),
                                             key=lambda kv: -kv[1])[:TOP]])
