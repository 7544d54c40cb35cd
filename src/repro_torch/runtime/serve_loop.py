"""Serving: prefill + decode steps and a capacity-aware request router.

The router is the serving-plane face of CloudPowerCap: replica throughput
is proportional to power-capped capacity, so dispatch weights follow the
caps the manager sets.

Prefill runs kernel K4 in every attention layer and each decode step
kernel K6 (:mod:`repro_torch.models.layers`); an MoE model's expert FFN
runs kernel K7 three times a layer a forward (:mod:`repro_torch.models.
moe`); an SSM layer's prefill runs kernel K8 once and its decode step the
plain recurrence (:mod:`repro_torch.models.ssd`).  The decode state
(KV caches, SSM and conv states) is updated in place.  The cache cursor
is a host ``int``, advanced once a forward, so the kernels' ``q_offset``
and ``kv_len`` need no device sync; the
token positions stay a ``(B,)`` device tensor for RoPE, and the greedy
tokens stay on the device from one step to the next.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.backend import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def _no_extras(cfg: ModelConfig, extras: Optional[dict]) -> None:
    tfm._ported(cfg)
    if extras:
        raise NotImplementedError(
            f"serving extras {sorted(extras)} belong to families not "
            f"ported yet")


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill(params, tokens, extras: Optional[dict] = None):
        """tokens: (B, S) prompt -> (last-position logits (B, V) float32,
        decode state)."""
        _no_extras(cfg, extras)
        b, s = tokens.shape
        cache = tfm.init_decode_state(cfg, b, max_len, tokens.device)
        res = tfm.forward(params, cfg, tokens=tokens, cache=cache)
        w_out = tfm.unembed_weight(params, cfg)
        logits = (res.hidden[:, -1] @ w_out).float()
        state = {"cache": res.cache,
                 "pos": torch.full((b,), s, dtype=torch.int32,
                                   device=tokens.device)}
        return logits, state
    return prefill


def make_decode_step(cfg: ModelConfig, sample: str = "greedy"):
    def decode(params, state, tokens):
        """tokens: (B,) last emitted tokens -> (next_logits, new state)."""
        pos = state["pos"]
        res = tfm.forward(params, cfg, tokens=tokens[:, None],
                          cache=state["cache"], positions=pos[:, None])
        w_out = tfm.unembed_weight(params, cfg)
        logits = (res.hidden[:, -1] @ w_out).float()
        new_state = dict(state)
        new_state["cache"] = res.cache
        new_state["pos"] = pos + 1
        return logits, new_state
    return decode


def generate(cfg: ModelConfig, params, prompt: torch.Tensor, steps: int,
             max_len: int, forced: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill + ``steps - 1`` decode steps; returns ``(tokens (B, steps),
    logits (B, steps, V) float32)``, the logits each token was read from.

    Greedy: each step feeds back the argmax of the last logits.  With
    ``forced`` ((B, steps) tokens), step ``i + 1`` is fed ``forced[:, i]``
    instead (teacher forcing), so two runs can be compared logit by logit.
    """
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    logits, state = prefill(params, prompt)
    out, seen = [torch.argmax(logits, -1)], [logits]
    for i in range(steps - 1):
        fed = out[-1] if forced is None else forced[:, i]
        logits, state = decode(params, state, fed)
        out.append(torch.argmax(logits, -1))
        seen.append(logits)
    return torch.stack(out, dim=1), torch.stack(seen, dim=1)


def greedy_generate(cfg: ModelConfig, params, prompt, steps: int,
                    max_len: int, extras: Optional[dict] = None,
                    device=None) -> torch.Tensor:
    """Prefill + N greedy decode steps on ``device`` (``None``: the GPU);
    returns the (B, steps) tokens."""
    _no_extras(cfg, extras)
    prompt = torch.as_tensor(prompt, device=resolve_device(device))
    return generate(cfg, params, prompt, steps, max_len)[0]


# ------------------------------------------------------------------ router
@dataclasses.dataclass
class Replica:
    replica_id: str
    host_id: str                  # host in the CPC cluster snapshot
    queue: int = 0                # outstanding requests


class CapacityAwareRouter:
    """Weighted least-loaded dispatch, weights = power-capped capacity.

    ``sync_capacities`` reads the capacities straight from the CloudPowerCap
    snapshot, so a cap redistribution (e.g. after a DPM power-off) shifts
    traffic within one control-loop period with no further coordination.
    """

    def __init__(self, replicas: list[Replica]):
        self.replicas = {r.replica_id: r for r in replicas}
        self.capacity: dict[str, float] = {r: 1.0 for r in self.replicas}

    def sync_capacities(self, snapshot) -> None:
        for rid, rep in self.replicas.items():
            host = snapshot.hosts[rep.host_id]
            self.capacity[rid] = max(host.managed_capacity, 0.0)

    def route(self, n_requests: int = 1) -> list[str]:
        """Assign requests to replicas; returns replica ids (one per req)."""
        out = []
        for _ in range(n_requests):
            live = [(rid, rep) for rid, rep in self.replicas.items()
                    if self.capacity.get(rid, 0.0) > 0.0]
            if not live:
                raise RuntimeError("no replica has capacity")
            rid, rep = min(
                live,
                key=lambda kv: (kv[1].queue + 1) / self.capacity[kv[0]])
            rep.queue += 1
            out.append(rid)
        return out

    def complete(self, replica_id: str) -> None:
        self.replicas[replica_id].queue -= 1
