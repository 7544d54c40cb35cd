"""The port's own spans and counters of the traced rounds
(``repro_torch.runtime.tracing``), for the readers under ``metrics/``.

A span's ``ms`` is the stream time between the CUDA events the port
records around it; its ``host_ms`` the host's time from its entry to its
exit.  The readers use nothing else of the tracer: its spans' ``name``,
``ms`` and ``host_ms`` and its counters."""

from __future__ import annotations

from collections import Counter

PREFILL = "repro_torch.serve.prefill"
DECODE = "repro_torch.serve.decode_step"
MOE_PHASES = tuple(f"repro_torch.moe.{p}"
                   for p in ("route", "dispatch", "experts", "combine"))
INVOCATION = "repro_torch.power.invocation"


def expected(run) -> dict:
    """How many of each span the traced rounds hold: a ``generate`` and a
    prefill a batch, ``steps - 1`` decode steps a batch, each MoE phase
    once a layer a forward of an MoE model, one power event with its
    invocation and routing."""
    batches = len(run.batches)
    steps = sum(s - 1 for _, _, s in run.batches)
    m = run.model
    moe = m["n_layers"] * (batches + steps) if m["family"] == "moe" else 0
    return {"repro_torch.serve.generate": batches, PREFILL: batches,
            DECODE: steps, **{p: moe for p in MOE_PHASES},
            "repro_torch.power.event": 1, INVOCATION: 1,
            "repro_torch.power.route": 1}


def trace(run):
    """The tracer's record of the traced rounds, or None where the program
    has no tracer or its spans do not number what :func:`expected` says."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    out = tracing.collect()
    seen = Counter(s.name for s in out.spans)
    if any(seen[name] != n for name, n in expected(run).items()):
        return None
    return out


def named(run, *names) -> list:
    """The spans of ``names`` in a whole trace of the traced rounds
    (empty where :func:`trace` finds none)."""
    out = trace(run)
    return [] if out is None else [s for s in out.spans if s.name in names]


def host_pct(run, name):
    """100 x the host's time over the stream's, summed over the spans
    ``name``: near 100 where the host paces them or a full launch queue
    holds the host to the card's pace."""
    found = named(run, name)
    device = sum(s.ms for s in found)
    return 100.0 * sum(s.host_ms for s in found) / device if device else None
