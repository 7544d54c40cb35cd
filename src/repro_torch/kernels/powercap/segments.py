"""The CSR layout of items grouped by segment (host), as K3 reads it.

Built on the host with a stable NumPy sort, once per grouping, and copied
to the device; a caller that waterfills the same grouping every tick (the
vector engine between topology changes) keeps the layout and passes it to
:func:`repro_torch.kernels.powercap.ops.waterfill_segmented`.  The dense
rows it scatters to are also how per-segment sums are taken: trailing-axis
sums over ``(n_segs, JB)`` rows, with no atomics, so they come out the same
on every run and every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SegmentLayout(NamedTuple):
    """Items stably sorted by segment: CSR position ``p`` holds item
    ``order[p]``, in row ``seg[p]`` at slot ``slot[p]``; segment ``s`` owns
    positions ``[starts[s], starts[s] + counts[s])``.  ``jb`` is the row
    width, the next power of two of at least 4 that covers the longest row
    (the reference's ``_jb_for``).  Index tensors are ``int64``."""

    order: torch.Tensor
    seg: torch.Tensor
    slot: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    jb: int

    @property
    def n_segs(self) -> int:
        return self.starts.numel()

    @property
    def device(self) -> torch.device:
        return self.order.device


def row_width(max_count: int) -> int:
    jb = 4
    while jb < max_count:
        jb *= 2
    return jb


def segment_layout(seg_ids, n_segs: int, device) -> SegmentLayout:
    """The layout of items whose segments are ``seg_ids`` (``(n,)`` ints in
    ``[0, n_segs)``), on ``device``."""
    if isinstance(seg_ids, torch.Tensor):
        seg_ids = seg_ids.cpu().numpy()
    seg_ids = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    if seg_ids.size and (seg_ids.min() < 0 or seg_ids.max() >= n_segs):
        raise ValueError(f"segment ids must lie in [0, {n_segs})")
    order = np.argsort(seg_ids, kind="stable")
    seg = seg_ids[order]
    counts = np.bincount(seg, minlength=n_segs).astype(np.int64)
    starts = np.cumsum(counts) - counts
    slot = np.arange(seg.size, dtype=np.int64) - starts[seg]
    jb = row_width(int(counts.max()) if counts.size else 0)
    t = [torch.as_tensor(a, dtype=torch.int64, device=device)
         for a in (order, seg, slot, starts, counts)]
    return SegmentLayout(*t, jb=jb)


def to_rows(layout: SegmentLayout, values, fill: float = 0.0):
    """Item columns ``(..., n)`` scattered into dense ``(..., n_segs, JB)``
    rows; slots past a row's count hold ``fill``."""
    out = torch.full((*values.shape[:-1], layout.n_segs, layout.jb), fill,
                     dtype=values.dtype, device=values.device)
    out[..., layout.seg, layout.slot] = values[..., layout.order]
    return out


def row_sums(layout: SegmentLayout, values):
    """Per-segment sums ``(..., n_segs)`` of item columns ``(..., n)``."""
    return to_rows(layout, values).sum(-1)
