"""Shape-and-dtype stand-ins for the model inputs of every step (the
reference's ``repro.launch.inputs``), and real inputs drawn from them.

A stand-in is a tensor on PyTorch's ``meta`` device: it has a shape and a
dtype and allocates nothing, as the reference's ``jax.ShapeDtypeStruct``.
The modality frontends are stubs: a VLM batch carries precomputed patch
embeddings ``(B, n_prefix_embeds, d_model)`` and an encoder-decoder batch
precomputed frame embeddings ``(B, enc_seq, d_model)``, both float32.  A
VLM's text is ``seq_len - n_prefix_embeds`` tokens long, so that the
prefix and the text fill the shape's sequence.  :func:`draw` turns a
stand-in into a tensor on a device.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _text_len(cfg: ModelConfig, s: int) -> int:
    return s - cfg.n_prefix_embeds if cfg.family == "vlm" else s


def _frontend(cfg: ModelConfig, b: int) -> dict:
    """The frontend's embeddings of a batch of ``b``, by family."""
    if cfg.family == "vlm":
        return {"vision_embeds": _spec((b, cfg.n_prefix_embeds,
                                        cfg.d_model), torch.float32)}
    if cfg.family == "encdec":
        return {"frames": _spec((b, cfg.enc_seq, cfg.d_model),
                                torch.float32)}
    return {}


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A training batch: int32 ``tokens`` and ``labels``, float32
    ``weights``, and the frontend's embeddings."""
    b, s = shape.global_batch, _text_len(cfg, shape.seq_len)
    specs = {"tokens": _spec((b, s), torch.int32),
             "labels": _spec((b, s), torch.int32),
             "weights": _spec((b, s), torch.float32)}
    specs.update(_frontend(cfg, b))
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> tuple[torch.Tensor, dict]:
    """A prefill's ``(tokens, extras)``, as ``make_prefill_step`` takes
    them."""
    b, s = shape.global_batch, _text_len(cfg, shape.seq_len)
    return _spec((b, s), torch.int32), _frontend(cfg, b)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _spec(tree.shape, tree.dtype)
    return tree


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A serving state with caches of ``shape.seq_len`` positions:
    ``{"cache", "pos"}``, and ``"enc_frames"`` for an encoder-decoder.
    The cache is :func:`~repro_torch.models.transformer.init_decode_state`'s
    tree, built under a fake-tensor mode so that nothing is allocated; its
    cursor stays the host ``int`` the port keeps."""
    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = tfm.init_decode_state(cfg, b, s, "cpu")
    state = {"cache": _to_meta(cache), "pos": _spec((b,), torch.int32)}
    if cfg.family == "encdec":
        state["enc_frames"] = _spec((b, cfg.enc_seq, cfg.d_model),
                                    torch.float32)
    return state


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    """A decode step's last tokens, (B,) int32."""
    return _spec((shape.global_batch,), torch.int32)


def draw(spec: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A float tensor of ``spec``'s shape and dtype on ``generator``'s
    device: a standard normal times 0.1, as the reference's tests scale
    their patch and frame embeddings."""
    out = torch.randn(tuple(spec.shape), generator=generator,
                      dtype=torch.float32, device=generator.device)
    return (out * 0.1).to(spec.dtype)
