"""Plain PyTorch versions of kernel K8, the SSD intra-chunk step.

:func:`ssd_chunk_ref` is the math of the reference's Pallas body
(``repro/kernels/ssd_scan/kernel.py:_ssd_kernel``): for every (batch,
chunk of Q tokens, head), with ``cum`` the in-chunk cumulative sum of the
log decay,

  y_intra[t]   = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
  contrib[p,n] = sum_s exp(cum_Q - cum_s) dt_s B_s[n] x_s[p]
  total        = cum_Q

all in float32.  The decay is taken as ``exp(cum_t - cum_s)`` for
``s <= t`` only, never as a product of ``exp(cum_t)`` and ``exp(-cum_s)``,
which overflows float32 within one chunk.  ``cum`` is summed in the
kernel's order (:func:`chunk_cumsum`), so the two agree on it to the bit:
it reaches about -3e3 within a chunk of 256, where two summation orders
would move the decays by about 1e-3 relative.  :func:`ssd_ref` is the
reference's sequential oracle (``repro/kernels/ssd_scan/ref.py``): the
O(L) state recurrence, independent of the chunked algorithm.
:func:`ssd_chunk_tc_ref` repeats the arithmetic of K8's tensor-core regime
(its state product's scaled inputs split into bf16 parts), so the split's
error can be held against the tolerance.  :func:`ssd_chunk_bwd_ref` is
the gradient of :func:`ssd_chunk_ref`, written out as the einsums that
kernel K8b sums (``csrc/ssd_bwd.cu``).  All four run on any device; the
wrappers take :func:`ssd_chunk_ref` and :func:`ssd_chunk_bwd_ref` for CPU
tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Positions a segment of the in-chunk cumulative sum (K8's order).
SEGMENT = 32


def chunk_cumsum(ld: torch.Tensor) -> torch.Tensor:
    """The in-chunk cumulative sum of ``ld`` (B, NC, Q, H) over Q, in K8's
    order: each segment of :data:`SEGMENT` positions summed in order from
    zero, then each segment's offset (the segment totals before it,
    summed in order) added.  Written as elementwise float32 adds, which
    round the same way on any device (``torch.cumsum`` accumulates in
    double on the CPU and in float32 on CUDA)."""
    b, nc, q, h = ld.shape
    nseg = -(-q // SEGMENT)
    seg = F.pad(ld, (0, 0, 0, nseg * SEGMENT - q)).reshape(
        b, nc, nseg, SEGMENT, h)
    local = torch.empty_like(seg)
    acc = torch.zeros_like(seg[:, :, :, 0])
    for i in range(SEGMENT):
        acc = acc + seg[:, :, :, i]
        local[:, :, :, i] = acc
    offsets = torch.empty_like(acc)
    run = torch.zeros_like(acc[:, :, 0])
    for k in range(nseg):
        offsets[:, :, k] = run
        run = run + local[:, :, k, -1]
    cum = local + offsets[:, :, :, None]
    return cum.reshape(b, nc, nseg * SEGMENT, h)[:, :, :q]


def _check(x, log_decay, dt, b_mat, c_mat, chunk: int) -> None:
    if x.dim() != 4 or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(f"expected x (B,L,H,P) and b, c (B,L,H,N); got "
                         f"{tuple(x.shape)}, {tuple(b_mat.shape)}, "
                         f"{tuple(c_mat.shape)}")
    bsz, l, h, _ = x.shape
    if tuple(b_mat.shape[:3]) != (bsz, l, h):
        raise ValueError(f"b {tuple(b_mat.shape)} does not match x "
                         f"{tuple(x.shape)} in batch, length or heads")
    for name, t in (("log_decay", log_decay), ("dt", dt)):
        if tuple(t.shape) != (bsz, l, h):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{(bsz, l, h)}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}")


def ssd_chunk_ref(x, log_decay, dt, b_mat, c_mat, chunk: int):
    """x: (B,L,H,P); log_decay, dt: (B,L,H); b, c: (B,L,H,N); L % chunk
    == 0.  Returns float32 ``(y_intra (B,L,H,P), contrib (B,NC,H,P,N),
    total (B,NC,H))``."""
    _check(x, log_decay, dt, b_mat, c_mat, chunk)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc, q = l // chunk, chunk
    xc = x.float().reshape(bsz, nc, q, h, p)
    ld = log_decay.float().reshape(bsz, nc, q, h)
    dtc = dt.float().reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, h, n)
    cc = c_mat.float().reshape(bsz, nc, q, h, n)
    cum = chunk_cumsum(ld)                                    # (B,NC,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,NC,t,s,H)
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], dec,
                                 float("-inf")))
    scores = torch.einsum("bcthn,bcshn->bctsh", cc, bc)
    w = scores * lmat * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", w, xc)
    total = cum[:, :, -1, :]                                   # (B,NC,H)
    rem = torch.exp(total[:, :, None, :] - cum)                # (B,NC,Q,H)
    bw = bc * (rem * dtc)[..., None]
    contrib = torch.einsum("bcshn,bcshp->bchpn", bw, xc)
    return y.reshape(bsz, l, h, p), contrib, total


def ssd_chunk_bwd_ref(x, log_decay, dt, b_mat, c_mat, chunk: int, dy,
                      dcontrib, dtotal):
    """The gradient of :func:`ssd_chunk_ref` for the cotangents ``dy``
    (B,L,H,P) of y_intra, ``dcontrib`` (B,NC,H,P,N) and ``dtotal``
    (B,NC,H).  Returns float32 ``(dx (B,L,H,P), dlog_decay (B,L,H), ddt
    (B,L,H), db (B,L,H,N), dc (B,L,H,N))``, db and dc a head each (their
    sum over heads that share one row is the shared row's gradient).

    With ``L_ts = exp(cum_t - cum_s)`` (s <= t), ``S_ts = C_t.B_s``,
    ``G_ts = dy_t.x_s``, ``A_ts = G_ts S_ts L_ts`` and ``r_s = exp(cum_Q -
    cum_s) dt_s``: ``dx_s = sum_t S_ts L_ts dt_s dy_t + r_s dcontrib
    B_s``, ``dC_t = sum_s G_ts L_ts dt_s B_s``, ``dB_s = sum_t G_ts L_ts
    dt_s C_t + r_s dcontrib^T x_s``, ``ddt_s = sum_t A_ts + exp(cum_Q -
    cum_s) u_s`` with ``u_s = x_s^T dcontrib B_s``; ``dcum_t = sum_s
    A_ts dt_s - dt_t sum_t' A_t't - r_t u_t``, plus ``sum_s r_s u_s`` and
    ``dtotal`` at the chunk's last position; ``dlog_decay`` is the suffix
    sum of ``dcum`` within the chunk (``cum`` is its prefix sum)."""
    _check(x, log_decay, dt, b_mat, c_mat, chunk)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc, q = l // chunk, chunk
    xc = x.float().reshape(bsz, nc, q, h, p)
    dtc = dt.float().reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, h, n)
    cc = c_mat.float().reshape(bsz, nc, q, h, n)
    dyc = dy.float().reshape(bsz, nc, q, h, p)
    dcon = dcontrib.float()
    cum = chunk_cumsum(log_decay.float().reshape(bsz, nc, q, h))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,NC,t,s,H)
    lmat = torch.exp(torch.where(tri[None, None, :, :, None], dec,
                                 float("-inf")))
    scores = torch.einsum("bcthn,bcshn->bctsh", cc, bc)
    g = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    ldt = lmat * dtc[:, :, None, :, :]
    ds = g * ldt
    a = g * scores * lmat
    dx = torch.einsum("bctsh,bcthp->bcshp", scores * ldt, dyc)
    dc = torch.einsum("bctsh,bcshn->bcthn", ds, bc)
    db = torch.einsum("bctsh,bcthn->bcshn", ds, cc)
    cola = a.sum(2)                                           # (B,NC,s,H)
    dcum = (a * dtc[:, :, None, :, :]).sum(3) - dtc * cola
    rem = torch.exp(cum[:, :, -1:, :] - cum)                  # (B,NC,Q,H)
    r = rem * dtc
    v = torch.einsum("bchpn,bcshn->bcshp", dcon, bc)
    dx = dx + r[..., None] * v
    db = db + r[..., None] * torch.einsum("bchpn,bcshp->bcshn", dcon, xc)
    u = (xc * v).sum(-1)
    ddt = cola + rem * u
    dcum = dcum - r * u
    dcum[:, :, -1] += (r * u).sum(2) + dtotal.float()
    dld = dcum.flip(2).cumsum(2).flip(2)
    return (dx.reshape(bsz, l, h, p), dld.reshape(bsz, l, h),
            ddt.reshape(bsz, l, h), db.reshape(bsz, l, h, n),
            dc.reshape(bsz, l, h, n))


def bf16_parts(w: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """``w`` (float32) as ``parts`` bf16 values (held as float32) whose sum
    approximates it: each the bf16 rounding of what the ones before it
    left, so ``parts`` of them keep about ``2^(-8 parts)`` of ``w``."""
    out, rest = [], w.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def ssd_chunk_tc_ref(x, log_decay, dt, b_mat, c_mat, chunk: int):
    """The arithmetic of K8's tensor-core regime in plain PyTorch: y_intra
    and total as :func:`ssd_chunk_ref` computes them (the regime keeps
    their order), contrib from the scaled inputs
    ``x_s exp(cum_Q - cum_s) dt_s`` in three bf16 parts
    (:func:`bf16_parts`), each part's product with bf16 B summed in
    float32.  Returns what :func:`ssd_chunk_ref` returns."""
    y, _, total = ssd_chunk_ref(x, log_decay, dt, b_mat, c_mat, chunk)
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc, q = l // chunk, chunk
    xc = x.float().reshape(bsz, nc, q, h, p)
    dtc = dt.float().reshape(bsz, nc, q, h)
    bc = b_mat.float().reshape(bsz, nc, q, h, n)
    cum = chunk_cumsum(log_decay.float().reshape(bsz, nc, q, h))
    xw = xc * (torch.exp(total[:, :, None, :] - cum) * dtc)[..., None]
    contrib = sum(torch.einsum("bcshp,bcshn->bchpn", part, bc)
                  for part in bf16_parts(xw, 3))
    return y, contrib, total


def ssd_ref(x, dt, a_log, b_mat, c_mat, init_state=None):
    """x: (B,L,H,P); dt: (B,L,H); a_log: (H,); b, c: (B,L,H,N).

    ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t (x) x_t`` and ``y_t = C_t.S_t``
    with ``A = -exp(a_log)``.  Returns float32 ``(y (B,L,H,P), final state
    (B,H,P,N))``."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    a = -torch.exp(a_log.float())
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * a)
        contrib = torch.einsum("bhn,bhp->bhpn",
                               b_mat[:, t].float() * dtt[..., None],
                               x[:, t].float())
        state = state * decay[..., None, None] + contrib
        ys.append(torch.einsum("bhn,bhpn->bhp", c_mat[:, t].float(), state))
    return torch.stack(ys, dim=1), state
