"""One run of a cell: set-up, the measured window (traced: two of its
rounds under ``torch.profiler``), then the correctness check.

The window is a closed loop of rounds driving the entry users call.  Each
round the fleet's router (``launch.serve.make_fleet``'s
``CapacityAwareRouter``) routes ``replicas x requests_per_replica``
requests, and each replica's batch, of one prompt length
(:mod:`cpcbench.gen`), is served by ``serve_loop.generate``, one replica
after the other on the one card.  At the first round boundary after half
of ``--seconds`` one ``launch.serve.power_event`` halves host ``h0``'s cap,
runs a manager invocation on the card and re-syncs the router (the mix's
``cap_event``); its routing serves that round, and the rounds after it
route alike.  The window closes at the end of the first round that ends
after ``--seconds`` (and after the traced rounds), so every routed request
is served in it.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cpcbench import check, gen
from cpcbench import trace as tr
from cpcbench.weights import make_weights

TRACED_ROUNDS = 2


class Port:
    """The program under test: ``repro_torch``'s serving entry points, its
    fleet and its kernel wrappers' launch counters, for the model that a
    configuration file names (``arch``; ``variant`` ``"smoke"`` for the
    port's CPU-sized twin), with the file's ``set`` block put into the
    port's configuration (``dataclasses.replace``).  Raises
    ``ValueError`` where the configuration then differs from the file's
    ``run_as``."""

    def __init__(self, config: dict):
        from repro_torch import configs
        from repro_torch.core.power_model import HostPowerSpec
        from repro_torch.kernels.decode_attention.ops import decode_attention
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.moe_gmm.ops import grouped_matmul
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tfm
        from repro_torch.runtime.serve_loop import generate

        arch = config["arch"]
        cfg = (configs.get_smoke(arch) if config.get("variant") == "smoke"
               else configs.get(arch))
        cfg = dataclasses.replace(cfg, **config.get("set", {}))
        wrong = {k: (v, getattr(cfg, k)) for k, v in config["run_as"].items()
                 if getattr(cfg, k) != v}
        if wrong:
            raise ValueError(f"{arch}: the port runs {wrong} (file, port)")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.param_dtype)
        self.specs = tfm.param_specs(cfg)
        self.generate = generate
        self.serve = serve
        self._host_spec = HostPowerSpec
        self.wrappers = {"k4": flash_attention, "k6": decode_attention,
                         "k7": grouped_matmul}

    def launches(self) -> dict:
        return {k: w.launches for k, w in self.wrappers.items()}

    def fleet(self, mix: dict):
        """``(snapshot, router)`` of the mix's fleet."""
        h = mix["host"]
        spec = self._host_spec(
            capacity_peak=h["capacity_peak"], power_idle=h["power_idle_w"],
            power_peak=h["power_peak_w"], power_nameplate=h["power_peak_w"],
            memory_mb=h["memory_mb"])
        return self.serve.make_fleet(spec, mix["replicas"])


@dataclasses.dataclass
class Batch:
    round: int
    replica: int
    n: int
    length: int
    wall_s: float
    tokens: torch.Tensor            # (n, steps), on the host
    bad: int                        # malformed rows
    rows: Optional[list] = None     # the rows kept for the check, and their
    logits: Optional[torch.Tensor] = None   # (rows, steps, V) float32


@dataclasses.dataclass
class Window:
    batches: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)  # counts, caps
    wall_s: float = 0.0
    caps_start: list = dataclasses.field(default_factory=list)
    caps_after: list = dataclasses.field(default_factory=list)
    event_round: Optional[int] = None
    cap_event_ms: float = 0.0
    traced: Optional["TracedRun"] = None
    profile: Optional[profile] = None     # stopped; read after the window
    sample: Optional[check.Sample] = None


@dataclasses.dataclass
class TracedRun:
    """What a per-layer metric's reader reads: the traced rounds."""

    model: dict           # the configuration file's run_as block
    batches: list         # (n, S, steps) of each batch served in them
    wall_s: float         # host clock, synced, over the traced rounds
    launches: dict        # the kernel wrappers' counts in them
    cap_event_ms: float
    summary: Optional[tr.Summary] = None

    @property
    def tokens(self) -> int:
        return sum(n * steps for n, _, steps in self.batches)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _activities(device) -> list:
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _malformed(tokens, logits, n: int, steps: int, vocab: int) -> int:
    """Requests whose tokens or logits are not what ``generate`` promises."""
    if tokens.shape != (n, steps) or logits.shape != (n, steps, vocab):
        return n
    bad = ~torch.isfinite(logits).flatten(1).all(1)
    bad |= ((tokens < 0) | (tokens >= vocab)).any(1)
    return int(bad.sum())


def setup(port: Port, cell, seed: int, device, trace: bool) -> dict:
    """The weights, then one cap event on a fleet of its own and one batch
    of the most requests a replica takes after it at the mix's longest
    prompt, so that every kernel library is loaded (and built, in a
    checkout's first run) and the window's largest batch has been served
    before the window."""
    mix = cell.mix
    params = make_weights(port.specs, seed, port.dtype, device)
    snap, router = port.fleet(mix)
    routing, _, _ = port.serve.power_event(
        snap, router, cell.cell["requests_per_replica"] * mix["replicas"],
        device)
    n = max(routing.values())
    s, steps = max(mix["prompt_lengths"]), mix["output_tokens"]
    port.generate(port.cfg, params,
                  gen.prompts(seed, -1, 0, n, s, port.cfg.vocab_size,
                              device), steps, s + steps)
    if trace:
        with profile(activities=_activities(device)):
            torch.ones(1, device=device).add_(1)
            sync(device)
    sync(device)
    return params


def run_window(port: Port, cell, params: dict, seed: int, seconds: float,
               device, trace: bool = False, min_rounds: int = 0) -> Window:
    """The measured window; see the module's docstring."""
    mix, steps = cell.mix, cell.mix["output_tokens"]
    vocab = port.cfg.vocab_size
    n_round = cell.cell["requests_per_replica"] * mix["replicas"]
    snap, router = port.fleet(mix)
    reps = list(router.replicas)
    caps = [h.power_cap for h in snap.hosts.values()]
    win = Window(caps_start=list(caps), sample=check.Sample(cell, seed))
    event = mix["cap_event"]
    if (event["host"], event["cap_factor"]) != ("h0", 0.5):
        raise ValueError(f"launch.serve.power_event halves h0's cap: {event}")
    prof = span = None
    traced = TRACED_ROUNDS if trace else 1
    gc.collect()
    gc.disable()
    sync(device)
    t0 = time.perf_counter()
    r = 0
    while True:
        if win.event_round is None and \
                time.perf_counter() - t0 >= seconds * event["at_fraction"]:
            if trace:
                prof = profile(activities=_activities(device))
                prof.start()
                span = record_function(tr.WINDOW)
                span.__enter__()
                at = dict(launches=port.launches(), t=time.perf_counter())
            e0 = time.perf_counter()
            with record_function("cpcbench.power_event"):
                routing, _, result = port.serve.power_event(
                    snap, router, n_round, device)
                sync(device)
            win.cap_event_ms = (time.perf_counter() - e0) * 1e3
            caps = [h.power_cap for h in result.snapshot.hosts.values()]
            win.caps_after, win.event_round = list(caps), r
            counts = [routing.get(rid, 0) for rid in reps]
        else:
            assigned = router.route(n_round)
            counts = [assigned.count(rid) for rid in reps]
        lengths = gen.round_lengths(mix, seed, r)
        for i, rid in enumerate(reps):
            n, s = counts[i], lengths[i]
            if n == 0:
                continue
            prompt = gen.prompts(seed, r, i, n, s, vocab, device)
            sync(device)
            b0 = time.perf_counter()
            with record_function("cpcbench.generate"):
                tokens, logits = port.generate(port.cfg, params, prompt,
                                               steps, s + steps)
                sync(device)
            wall = time.perf_counter() - b0
            b = Batch(r, i, n, s, wall, tokens.cpu(),
                      _malformed(tokens, logits, n, steps, vocab))
            b.rows = win.sample.offer(b)
            if b.rows is not None:
                b.logits = logits[b.rows].cpu()
            win.batches.append(b)
            del tokens, logits
            for _ in range(n):
                router.complete(rid)
        win.rounds.append({"counts": counts, "caps": list(caps)})
        r += 1
        if prof is not None and r == win.event_round + TRACED_ROUNDS:
            sync(device)
            wall = time.perf_counter() - at["t"]
            span.__exit__(None, None, None)
            prof.stop()
            done = port.launches()
            win.profile = prof
            win.traced = TracedRun(
                model=cell.config["run_as"], wall_s=wall,
                cap_event_ms=win.cap_event_ms,
                batches=[(b.n, b.length, steps) for b in win.batches
                         if b.round >= win.event_round],
                launches={k: done[k] - at["launches"][k] for k in done})
        if (time.perf_counter() - t0 >= seconds and r >= min_rounds
                and win.event_round is not None
                and r >= win.event_round + traced):
            break
    sync(device)
    win.wall_s = time.perf_counter() - t0
    gc.enable()
    return win


def release() -> None:
    """Return the memory of dropped tensors to the card: the reference runs
    after the program's state is freed."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def p95(values: list) -> float:
    """Nearest-rank 95th percentile."""
    xs = sorted(values)
    return xs[max(0, -(-95 * len(xs) // 100) - 1)]


def end_to_end(win: Window, setup_s: float) -> dict:
    tokens = sum(b.tokens.numel() for b in win.batches)
    latency = [b.wall_s for b in win.batches for _ in range(b.n)]
    return {"tokens_per_s": tokens / win.wall_s,
            "request_p95_s": p95(latency), "setup_s": setup_s}


def _device(device, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def _lost(traced: TracedRun, say) -> None:
    """Sets the trace's K4, K6 and K7 kernels against the wrappers'
    counts, and says where events were lost."""
    kernels = {"k4": ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
               "k6": ("decode_partials_kernel",),
               "k7": ("gmm_wide_kernel", "gmm_narrow_kernel", "gmm_kernel")}
    for key, patterns in kernels.items():
        seen, _ = traced.summary.kernel_time(*patterns)
        say(f"trace {key}: {seen} kernels seen, {traced.launches[key]} "
            f"launched" + ("" if seen == traced.launches[key]
                           else " (events lost)"))


def run(cell, seed: int, seconds: float, trace: bool, device,
        clock0: float, say=print) -> dict:
    """One run of ``cell``; ``clock0`` is ``time.perf_counter()`` at the
    process's start.  Returns the result line's object, ``checks`` last."""
    port = Port(cell.config)
    params = setup(port, cell, seed, device, trace)
    setup_s = time.perf_counter() - clock0
    say(f"set-up {setup_s:.2f} s")
    win = run_window(port, cell, params, seed, seconds, device, trace)
    say(f"window {win.wall_s:.2f} s: {len(win.rounds)} rounds, "
        f"{len(win.batches)} batches, the cap event in round "
        f"{win.event_round} ({win.cap_event_ms:.1f} ms), routing "
        f"{[r['counts'] for r in win.rounds]}, batch walls "
        f"{[(b.length, b.n, round(b.wall_s, 3)) for b in win.batches]}")
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev = _device(device, peak)
    out = {}
    if trace:
        traced = win.traced
        traced.summary = tr.summarize(win.profile)
        win.profile = None
        _lost(traced, say)
        say(f"trace: {traced.summary.launch_calls} launch calls, "
            f"{len(traced.summary.kernels)} kernels, {traced.tokens} tokens")
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=traced.summary.busy_s,
                   window_s=traced.summary.window_s)
        out["breakdown"] = {"device_ops": traced.summary.device_ops,
                            "idle_gaps": traced.summary.idle_gaps}
    else:
        values = end_to_end(win, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    del params
    release()
    c0 = time.perf_counter()
    numbers = check.model_numbers(port, cell, win, seed, device)
    say(f"reference {time.perf_counter() - c0:.2f} s")
    numbers.update(check.fleet_numbers(cell, win))
    numbers["failed_requests"] = sum(b.bad for b in win.batches)
    correct, checks = check.judge(numbers, check.limits(cell))
    attempted = sum(b.n for b in win.batches)
    return {"correct": correct, "attempted": attempted,
            "failed": numbers["failed_requests"], "metrics": metrics,
            "device": dev, **out, "checks": checks}
