"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395), in float32 tensors as the reference's jnp computes them,
so a schedule of the optimizer's device-side step count stays on the
device."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0,
                               1.0)
        cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay: plateau at peak, then fast decay."""
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay_start = warmup_steps + stable_steps
        progress = torch.clamp((step - decay_start) / max(decay_steps, 1),
                               0.0, 1.0)
        decayed = peak_lr * (final_frac ** progress)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < decay_start,
                                       torch.full_like(step, peak_lr),
                                       decayed))
    return lr
