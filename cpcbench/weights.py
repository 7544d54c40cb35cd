"""Weights made from the seed on the device: one draw a leaf, in the type
they are served in, in the layout the port's forward takes.

The layout is the port's ``param_specs`` (``{name: (shape, axes)}``
nested), read without making a tensor.  Each matrix is normal with
standard deviation ``1 / sqrt(fan_in)`` (``fan_in`` its second-to-last
dim; the embedding table's its width, so that a head tied to it reads
logits of the scale an untied head does), each norm scale ``1 + 0.05`` of
a normal.
The same seed on the same device gives the same values, so the
correctness check draws them again after the port's are freed.
"""

from __future__ import annotations

import math

import torch


def _leaves(specs: dict, prefix=()):
    for name, spec in specs.items():
        if isinstance(spec, dict):
            yield from _leaves(spec, prefix + (name,))
        else:
            yield prefix + (name,), tuple(spec[0]), tuple(spec[1])


def make_weights(specs: dict, seed: int, dtype: torch.dtype,
                 device) -> dict:
    """A nested dict of tensors with the shapes of ``specs``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    out: dict = {}
    for path, shape, axes in _leaves(specs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = torch.randn(shape, generator=g, dtype=dtype, device=device)
        if sum(a != "layer" for a in axes) == 1:
            t.mul_(0.05).add_(1.0)
        else:
            fan_in = shape[-1] if path[0] == "embed" else shape[-2]
            t.mul_(1.0 / math.sqrt(fan_in))
        node[path[-1]] = t
    return out
