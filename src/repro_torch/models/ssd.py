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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers


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
    new_state_dict), the new conv states in x.dtype.
    """
    bsz, l, _ = x.shape
    di, n, h, p = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                   cfg.ssm_head_dim)
    z = x @ params["in_z"]                                   # (B, L, di)
    xs = x @ params["in_x"]
    b_raw = x @ params["in_b"]                               # (B, L, N)
    c_raw = x @ params["in_c"]
    dt_raw = x @ params["in_dt"]                             # (B, L, H)

    cs = (None, None, None) if state is None else state["conv"]
    xs, new_cx = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"],
                              cs[0])
    b_raw, new_cb = _causal_conv(b_raw, params["conv_b_w"],
                                 params["conv_b_b"], cs[1])
    c_raw, new_cc = _causal_conv(c_raw, params["conv_c_w"],
                                 params["conv_c_b"], cs[2])
    new_conv = (new_cx, new_cb, new_cc)

    xh = xs.reshape(bsz, l, h, p)
    dt = F.softplus(dt_raw + params["dt_bias"])              # (B, L, H)
    bh = b_raw[:, :, None, :].expand(bsz, l, h, n)
    ch = c_raw[:, :, None, :].expand(bsz, l, h, n)

    if state is None or l > 1:
        init = None if state is None else state["ssm"]
        y, new_ssm = ssd_chunked(xh, dt, params["a_log"], bh, ch,
                                 cfg.ssm_chunk, init_state=init)
    else:
        y, new_ssm = ssd_decode_step(state["ssm"], xh, dt, params["a_log"],
                                     bh, ch)
    y = y + xh * params["d_skip"][:, None].to(y.dtype)
    y = y.reshape(bsz, l, di)
    y = layers.rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
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
