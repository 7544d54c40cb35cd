"""Gradient compression for cross-pod data parallelism: int8 quantization
with a per-tensor scale, plus error feedback (each round's residual is
added back the next round).

``compressed_cross_pod_mean`` is the cross-pod building block: quantize
the local (per-pod) partial gradient, all-gather the int8 payload and the
scales over the mesh's ``pod`` dimension, dequantize and average locally
(the reference's ``shard_map`` body, on a ``DeviceMesh``)."""

from __future__ import annotations

import torch

from repro_torch.runtime.sharding import all_gather
from repro_torch.tree import map_tree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class ErrorFeedbackCompressor:
    """Stateful wrapper: compress(grads) with residual carry."""

    def init(self, params: dict) -> dict:
        return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def compress(self, grads: dict, residual: dict) -> tuple[dict, dict]:
        deq, res = {}, {}
        for name, g in grads.items():
            if isinstance(g, dict):
                deq[name], res[name] = self.compress(g, residual[name])
                continue
            g = g.float() + residual[name]
            q, s = quantize_int8(g)
            deq[name] = dequantize_int8(q, s)
            res[name] = g - deq[name]
        return deq, res


def compressed_cross_pod_mean(g: torch.Tensor, mesh,
                              axis_name: str = "pod") -> torch.Tensor:
    """The mean over ``mesh``'s ``axis_name`` ranks of their ``g``, each
    sent as int8 with its scale: a quarter of a float32 all-reduce's
    bytes, at one quantization error a step (bounded by error feedback
    at the caller).  Every rank ends with the same bits."""
    q, scale = quantize_int8(g)
    qs = all_gather(q, mesh, axis_name)                  # (pods, ...)
    scales = all_gather(scale, mesh, axis_name)          # (pods,)
    deq = qs.to(torch.float32) * scales.reshape((-1,) + (1,) * g.ndim)
    return deq.mean(0)
