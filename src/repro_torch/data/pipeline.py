"""Deterministic, checkpointable synthetic token pipeline (the reference's
``repro.data.pipeline``).

Batches are a pure function of ``(seed, step)``, drawn by the same NumPy
generator as the reference's, so the tokens are the reference's bit for
bit; they are handed out as tensors on ``device`` (``None``: the GPU).
The stream is a Zipf-ish unigram mix with a shifted-copy structure so the
model has learnable signal.  Tokens and labels are int64, PyTorch's index
type (the reference's are int32, of the same values).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend import resolve_device


@dataclasses.dataclass
class Batch:
    tokens: torch.Tensor          # (B, S) int64 inputs
    labels: torch.Tensor          # (B, S) int64 targets (shifted)
    weights: torch.Tensor         # (B, S) float32 loss weights (0 = padding)
    extras: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0                 # checkpointable cursor
    copy_offset: int = 16         # learnable structure: token repeats
    device: object = None         # where batches go (None: the GPU)

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.seed, self.step = int(d["seed"]), int(d["step"])

    def _tokens_for(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s = self.global_batch, self.seq_len
        # Zipf-ish unigrams in a smallish active vocab band.
        active = min(self.vocab_size, 4096)
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(ranks, active - 1).astype(np.int32)
        # Structured copies: second half repeats the first half shifted.
        half = (s + 1) // 2
        toks[:, half:half + half - self.copy_offset] = \
            toks[:, self.copy_offset:half]
        return toks

    def next_batch(self) -> Batch:
        dev = resolve_device(self.device)
        toks = torch.from_numpy(self._tokens_for(self.step)).long()
        self.step += 1
        return Batch(
            tokens=toks[:, :-1].to(dev),
            labels=toks[:, 1:].to(dev),
            weights=torch.ones((self.global_batch, self.seq_len),
                               dtype=torch.float32, device=dev),
        )
