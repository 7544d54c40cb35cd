"""Mamba2 / SSD (state-space duality) mixer, chunked-scan formulation
(``repro.models.ssd``).

Prefill runs the SSD chunked algorithm (arXiv:2405.21060): quadratic
attention-like work within chunks of Q tokens and a linear state carry
between them.  The reference's model runs that scan in plain JAX; the port
runs it through :func:`repro_torch.kernels.ssd_scan.ssd_scan`, whose
intra-chunk step is kernel K8 on the card, so :func:`ssd_chunked` is that
scan followed by the cast to ``x.dtype``.  Decode is the O(1) recurrent
update on a (B, H, P, N) state, plain PyTorch as in the reference.

Shapes: x (B,L,H,P), dt (B,L,H), B/C (B,L,G,N) with G groups broadcast over
heads (G=1 for the assigned configs): the port broadcasts them as views
with a head stride of 0, which K8 reads as they are.

Split over heads (the ``heads`` axis over the ``model`` dims), a rank
holds its block of ``h / n`` heads: ``h_l P`` contiguous columns of
``in_z``, ``in_x``, ``conv_x_*`` and ``norm_scale``, its ``h_l`` entries
of ``in_dt``, ``a_log``, ``d_skip`` and ``dt_bias``, and those rows of
``out_proj``; ``in_b``, ``in_c`` and ``conv_b_*``, ``conv_c_*`` stay
whole, computed alike on every rank from the whole input; B and C enter
the rank's heads through :class:`_SharedHeads` (their gradient summed
over every rank's heads in float32, rounded once), so those leaves'
gradients are whole on every rank.  The input of the heads' own
projections enters through Megatron's ``f``, the output leaves through
``g`` (the ranks' partial ``out_proj`` products summed in float32), and
the gated RMSNorm over ``d_inner`` sums its squares over the ranks
(:func:`repro_torch.models.layers.split_rms_norm`).  K8 and K8b, the
decode recurrence and the conv states run on the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers
from repro_torch.runtime.sharding import (copy_to, gather_dims, split_over,
                                          sum_in_rank_order, sum_over)


# --------------------------------------------------------------- SSD core
def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk: int, init_state=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); a_log: (H,) with
    A = -exp(a_log); b_mat/c_mat: (B, L, H, N) (already head-expanded).
    Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) float32).
    """
    y, state = ssd_scan(x, dt, a_log, b_mat, c_mat, chunk=chunk,
                        init_state=init_state)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, a_log, b_mat, c_mat):
    """One-token recurrent update.

    state: (B,H,P,N); x: (B,1,H,P); dt: (B,1,H); b/c: (B,1,H,N).
    Returns (y (B,1,H,P), new state).
    """
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt[:, 0].float() * a)                  # (B, H)
    contrib = torch.einsum("bhn,bhp->bhpn",
                           b_mat[:, 0].float() * dt[:, 0, :, None].float(),
                           x[:, 0].float())
    new_state = state * decay[:, :, None, None] + contrib
    y = torch.einsum("bhn,bhpn->bhp", c_mat[:, 0].float(), new_state)
    return y[:, None].to(x.dtype), new_state


# ----------------------------------------------------------- Mamba2 block
def ssd_param_specs(cfg) -> dict:
    """Separate projections per component (z, x, B, C, dt), as the
    reference keeps them."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    w = cfg.ssm_conv_width
    return {
        "in_z": ((d, di), ("embed_p", "heads")),
        "in_x": ((d, di), ("embed_p", "heads")),
        "in_b": ((d, n), ("embed_p", None)),
        "in_c": ((d, n), ("embed_p", None)),
        "in_dt": ((d, h), ("embed_p", "heads")),
        "conv_x_w": ((w, di), (None, "heads")),
        "conv_x_b": ((di,), ("heads",)),
        "conv_b_w": ((w, n), (None, None)),
        "conv_b_b": ((n,), (None,)),
        "conv_c_w": ((w, n), (None, None)),
        "conv_c_b": ((n,), (None,)),
        "a_log": ((h,), ("heads",)),
        "d_skip": ((h,), ("heads",)),
        "dt_bias": ((h,), ("heads",)),
        "norm_scale": ((di,), ("heads",)),
        "out_proj": ((di, d), ("heads", "embed_p")),
    }


class _SharedHeads(torch.autograd.Function):
    """B or C (B, L, N), whole on every rank, as ``h`` heads of this rank's
    block (a view with a head stride of 0).  Backward, the heads' gradients
    summed in float32 over this rank's heads and then over the ranks of
    mesh ``dims`` in rank order, rounded once: every rank gets the whole
    gradient, as one rank's head sum gives it."""

    @staticmethod
    def forward(ctx, t, h, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t[:, :, None, :].expand(t.shape[0], t.shape[1], h,
                                       t.shape[2])

    @staticmethod
    def backward(ctx, g):
        whole = sum_in_rank_order(g.float().sum(2), ctx.mesh, ctx.dims)
        return whole.to(g.dtype), None, None, None


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, width W.  x: (B, L, C); w: (W, C).

    ``state``: (B, W-1, C) trailing context for decode (any float dtype;
    it is read in x's).  Returns (silu(y), new state in x.dtype)."""
    width = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(ctx[:, i:i + x.shape[1]] * w[i] for i in range(width)) + b
    new_state = ctx[:, -(width - 1):] if width > 1 else None
    return F.silu(y), new_state


def ssd_block(params, x, cfg, *, state=None):
    """Full Mamba2 mixer.  x: (B, L, D).

    ``state``: None (prefill from zeros) or dict(ssm, conv) (a zero state
    at prefill, the carried one at decode).  Returns (out (B,L,D),
    new_state_dict), the new conv states in x.dtype.  ``params`` may be a
    rank's block of the heads (the module's docstring): the SSM state is
    then the rank's heads, and the x conv state its columns or, where
    the layout keeps it whole, all of them.
    """
    bsz, l, _ = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    h = params["in_dt"].shape[1]                             # this rank's
    di = h * p
    tp = split_over("heads", h, cfg.n_ssm_heads)
    xh_in = x
    if tp is not None:
        if params["in_x"].shape[1] != di:
            raise ValueError(f"in_x: a block of {params['in_x'].shape[1]} "
                             f"columns, {h} heads of {p}")
        xh_in = copy_to(x, tp[0], tp[1])
    z = xh_in @ params["in_z"]                               # (B, L, di)
    xs = xh_in @ params["in_x"]
    b_raw = x @ params["in_b"]                               # (B, L, N)
    c_raw = x @ params["in_c"]
    dt_raw = xh_in @ params["in_dt"]                         # (B, L, H)

    cs = (None, None, None) if state is None else state["conv"]
    cx = cs[0]
    if tp is not None and cx is not None and cx.shape[-1] != di:
        # A conv state stored whole (d_inner too narrow to split): this
        # rank's columns in, every rank's new columns gathered back.
        cx = cx[..., tp[2] * di:(tp[2] + 1) * di]
    xs, new_cx = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"],
                              cx)
    if tp is not None and cs[0] is not None and cs[0].shape[-1] != di:
        new_cx = gather_dims(new_cx.contiguous(), tp[0], tp[1], -1)
    b_raw, new_cb = _causal_conv(b_raw, params["conv_b_w"],
                                 params["conv_b_b"], cs[1])
    c_raw, new_cc = _causal_conv(c_raw, params["conv_c_w"],
                                 params["conv_c_b"], cs[2])
    new_conv = (new_cx, new_cb, new_cc)

    xh = xs.reshape(bsz, l, h, p)
    dt = F.softplus(dt_raw + params["dt_bias"])              # (B, L, H)
    if tp is None:
        bh = b_raw[:, :, None, :].expand(bsz, l, h, n)
        ch = c_raw[:, :, None, :].expand(bsz, l, h, n)
    else:
        bh = _SharedHeads.apply(b_raw, h, tp[0], tuple(tp[1]))
        ch = _SharedHeads.apply(c_raw, h, tp[0], tuple(tp[1]))

    if state is None or l > 1:
        init = None if state is None else state["ssm"]
        y, new_ssm = ssd_chunked(xh, dt, params["a_log"], bh, ch,
                                 cfg.ssm_chunk, init_state=init)
    else:
        y, new_ssm = ssd_decode_step(state["ssm"], xh, dt, params["a_log"],
                                     bh, ch)
    y = y + xh * params["d_skip"][:, None].to(y.dtype)
    y = y.reshape(bsz, l, di) * F.silu(z)
    if tp is None:
        y = layers.rms_norm(y, params["norm_scale"], cfg.norm_eps)
    else:
        y = layers.split_rms_norm(y, params["norm_scale"], cfg.norm_eps,
                                  tp[0], tp[1], cfg.d_inner)
    if tp is None:
        out = y @ params["out_proj"]
    else:
        # The ranks' partial products summed in float32 and rounded once:
        # each rounded to bf16 before the sum, Mamba2-2.7B's bf16 logits
        # moved 3.2e-2 from one rank's (an H100, 700 W: path SM).
        out = sum_over(y.float() @ params["out_proj"].float(), tp[0],
                       tp[1]).to(y.dtype)
    return out, {"ssm": new_ssm, "conv": new_conv}


def ssd_init_state(cfg, batch: int, device=None) -> dict:
    """Zero SSM and conv states of one layer, float32 (the conv states
    come back from :func:`ssd_block` in the activations' dtype)."""
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    w = cfg.ssm_conv_width - 1
    zeros = dict(dtype=torch.float32, device=device)
    return {
        "ssm": torch.zeros((batch, h, p, n), **zeros),
        "conv": (torch.zeros((batch, w, cfg.d_inner), **zeros),
                 torch.zeros((batch, w, n), **zeros),
                 torch.zeros((batch, w, n), **zeros)),
    }
