"""Gradient compression for cross-pod data parallelism: int8 quantization
with a per-tensor scale, plus error feedback (each round's residual is
added back the next round).  ``compressed_cross_pod_mean`` is a collective
over pods and is not ported yet."""

from __future__ import annotations

import torch

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


def compressed_cross_pod_mean(g: torch.Tensor, axis_name: str = "pod"):
    raise NotImplementedError(
        "the int8 all-gather over pods is a collective across cards: it "
        "comes with the mesh (ROADMAP queue 1, item 9)")
