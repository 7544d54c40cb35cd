"""The chunked SSD scan around kernel K8: checks, launch counter, dispatch
by device (``repro/kernels/ssd_scan/ops.py``).

:func:`ssd_scan` pads the sequence to a multiple of the chunk, takes the
log decay ``dt * A`` with ``A = -exp(a_log)``, runs the intra-chunk step
(:func:`_intra_chunk`), then the inter-chunk state recurrence and the
``y_inter`` term as PyTorch ops, as the reference runs them in plain JAX
outside its Pallas kernel.  A CUDA tensor launches the hand-written
kernel in the regime that :func:`kernel.plan` chooses (or raises); a CPU
tensor runs its plain version (:func:`ref.ssd_chunk_ref`).
``ssd_scan.launches`` counts the kernel launches, one a call (each launch
runs K8's two kernels).  Under autograd the intra-chunk step is
:class:`SSDChunk`, whose backward is kernel K8b on the card, in the regime
:func:`kernel.plan_bwd` chooses (``csrc/ssd_bwd_tc.cu`` for bf16 on the
tensor cores, ``csrc/ssd_bwd.cu``), and :func:`ref.ssd_chunk_bwd_ref` on
the CPU;
``ssd_chunk_bwd.launches`` counts K8b's launches.  The recurrence and
``y_inter`` stay PyTorch ops, which autograd differentiates.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.backend import PLAIN_DEVICES
from repro_torch.kernels.ssd_scan import kernel, ref


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(x, b_mat, c_mat, what: str) -> None:
    """What K8 and K8b take on the card: float32 or bf16 x, B and C of one
    dtype, a head dim up to 128, x packed, B's and C's features packed."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, not {x.dtype}")
    if not (b_mat.dtype == c_mat.dtype == x.dtype):
        raise TypeError(f"x, b, c differ in dtype: {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if x.shape[3] > kernel.MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head_dim up to "
                         f"{kernel.MAX_HEAD_DIM}, not {x.shape[3]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in (("b", b_mat), ("c", c_mat)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the feature axis must be packed "
                             f"(strides {t.stride()})")


def _intra_chunk(x, log_decay, dt, b_mat, c_mat, chunk: int):
    """K8 on the tensors' device: ``(y_intra, contrib, total)``, float32.
    On CUDA, b and c may be views with any batch, position and head
    strides (a head stride of 0 shares one row across the heads) as long
    as their feature axis is packed."""
    ref._check(x, log_decay, dt, b_mat, c_mat, chunk)
    if x.device.type in PLAIN_DEVICES:
        return ref.ssd_chunk_ref(x, log_decay, dt, b_mat, c_mat, chunk)
    _check_cuda(x, b_mat, c_mat, "K8")
    bsz, l, h, p = x.shape
    n, nc = b_mat.shape[-1], l // chunk
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, b_mat, c_mat))
    plan = kernel.plan(bsz, l, h, p, n, chunk, x.dtype,
                       (b_mat.stride()[:3], c_mat.stride()[:3]), aligned,
                       _sms(x.device.index))
    log_decay = log_decay.float().contiguous()
    dt = dt.float().contiguous()
    y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=x.device)
    contrib = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                          device=x.device)
    total = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    kernel.ssd_chunk(x, log_decay, dt, b_mat, c_mat, y, contrib, total,
                     plan, chunk=chunk)
    ssd_scan.launches += 1
    return y, contrib, total


def ssd_chunk_bwd(x, log_decay, dt, b_mat, c_mat, chunk: int, dy, dcontrib,
                  dtotal):
    """K8b on the tensors' device: the gradient of :func:`_intra_chunk`'s
    outputs, ``(dx, dlog_decay, ddt, db, dc)`` in float32 (db and dc a
    head each), for the cotangents ``dy`` (B,L,H,P), ``dcontrib``
    (B,NC,H,P,N) and ``dtotal`` (B,NC,H).  On CUDA it takes the operands
    that :func:`_intra_chunk` takes."""
    ref._check(x, log_decay, dt, b_mat, c_mat, chunk)
    if x.device.type in PLAIN_DEVICES:
        return ref.ssd_chunk_bwd_ref(x, log_decay, dt, b_mat, c_mat, chunk,
                                     dy, dcontrib, dtotal)
    _check_cuda(x, b_mat, c_mat, "K8b")
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, b_mat, c_mat))
    plan = kernel.plan_bwd(bsz, l, h, p, n, chunk, x.dtype,
                           (b_mat.stride()[:3], c_mat.stride()[:3]),
                           aligned)           # raises on what K8b refuses
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((bsz, l, h, p), **f32)
    dld = torch.empty((bsz, l, h), **f32)
    ddt = torch.empty((bsz, l, h), **f32)
    db = torch.empty((bsz, l, h, n), **f32)
    dc = torch.empty((bsz, l, h, n), **f32)
    kernel.ssd_chunk_bwd(
        x, log_decay.float().contiguous(), dt.float().contiguous(), b_mat,
        c_mat, dy.float().contiguous(), dcontrib.float().contiguous(),
        dtotal.float().contiguous(), dx, dld, ddt, db, dc, plan,
        chunk=chunk)
    ssd_chunk_bwd.launches += 1
    return dx, dld, ddt, db, dc


class SSDChunk(torch.autograd.Function):
    """The intra-chunk step under autograd: K8 forward, K8b backward (the
    plain versions on the CPU).  Saves its inputs; the cotangents of all
    three outputs go to K8b (zeros where an output is unused)."""

    @staticmethod
    def forward(ctx, x, log_decay, dt, b_mat, c_mat, chunk: int):
        ctx.save_for_backward(x, log_decay, dt, b_mat, c_mat)
        ctx.chunk = chunk
        return _intra_chunk(x, log_decay, dt, b_mat, c_mat, chunk)

    @staticmethod
    def backward(ctx, dy, dcontrib, dtotal):
        x, log_decay, dt, b_mat, c_mat = ctx.saved_tensors
        dx, dld, ddt, db, dc = ssd_chunk_bwd(
            x, log_decay, dt, b_mat, c_mat, ctx.chunk, dy, dcontrib, dtotal)
        return (dx.to(x.dtype), dld.to(log_decay.dtype), ddt.to(dt.dtype),
                db.to(b_mat.dtype), dc.to(c_mat.dtype), None)


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, chunk: int = 256,
             init_state=None):
    """x: (B,L,H,P); dt: (B,L,H) (after softplus); a_log: (H,); b, c:
    (B,L,H,N).  Returns float32 ``(y (B,L,H,P), final state (B,H,P,N))``,
    the contract of :func:`ref.ssd_ref`; differentiable in every input."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    a = -torch.exp(a_log.float())
    dt = dt.float()              # once, for the log decay and for K8
    log_decay = dt * a

    operands = (x, log_decay, dt, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        y_intra, contrib, total = SSDChunk.apply(*operands, q)
    else:
        y_intra, contrib, total = _intra_chunk(*operands, q)

    # Inter-chunk recurrence: S_c = exp(total_c) S_{c-1} + contrib_c (the
    # chunks unbound once: their gradient is one stack).
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for decay_c, contrib_c in zip(torch.exp(total).unbind(1),
                                  contrib.unbind(1)):
        prev.append(state)
        state = state * decay_c[:, :, None, None] + contrib_c
    prev_states = torch.stack(prev, dim=1)                   # (B,NC,H,P,N)

    # y_inter[t] = C_t . (exp(cum_t) S_prev-of-chunk)
    cum = torch.cumsum(log_decay.reshape(bsz, nc, q, h), dim=2)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           c_mat.reshape(bsz, nc, q, h, n).float(),
                           prev_states) * torch.exp(cum)[..., None]
    y = y_intra.reshape(bsz, nc, q, h, p) + y_inter
    return y.reshape(bsz, nc * q, h, p)[:, :l], state


ssd_scan.launches = 0
ssd_chunk_bwd.launches = 0
