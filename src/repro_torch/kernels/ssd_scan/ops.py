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
runs K8's two kernels).  K8 has no
backward: with grad mode on and an input that requires grad, the wrapper
raises rather than return a result that autograd cannot differentiate.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import kernel, ref


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _intra_chunk(x, log_decay, dt, b_mat, c_mat, chunk: int):
    """K8 on the tensors' device: ``(y_intra, contrib, total)``, float32.
    On CUDA, b and c may be views with any batch, position and head
    strides (a head stride of 0 shares one row across the heads) as long
    as their feature axis is packed."""
    ref._check(x, log_decay, dt, b_mat, c_mat, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunk_ref(x, log_decay, dt, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"K8 takes float32 or bfloat16, not {x.dtype}")
    if not (b_mat.dtype == c_mat.dtype == x.dtype):
        raise TypeError(f"x, b, c differ in dtype: {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if x.shape[3] > kernel.MAX_HEAD_DIM:
        raise ValueError(f"K8 takes head_dim up to {kernel.MAX_HEAD_DIM}, "
                         f"not {x.shape[3]}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in (("b", b_mat), ("c", c_mat)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the feature axis must be packed "
                             f"(strides {t.stride()})")
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


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, chunk: int = 256,
             init_state=None):
    """x: (B,L,H,P); dt: (B,L,H) (after softplus); a_log: (H,); b, c:
    (B,L,H,N).  Returns float32 ``(y (B,L,H,P), final state (B,H,P,N))``,
    the contract of :func:`ref.ssd_ref`."""
    tensors = (x, dt, a_log, b_mat, c_mat) + (
        () if init_state is None else (init_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_scan has no backward: SSM and hybrid training comes with "
            "its autograd Function (ROADMAP queue 1, item 14)")
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

    y_intra, contrib, total = _intra_chunk(x, log_decay, dt, b_mat, c_mat, q)

    # Inter-chunk recurrence: S_c = exp(total_c) S_{c-1} + contrib_c.
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    decay = torch.exp(total)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * decay[:, c, :, None, None] + contrib[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,NC,H,P,N)

    # y_inter[t] = C_t . (exp(cum_t) S_prev-of-chunk)
    cum = torch.cumsum(log_decay.reshape(bsz, nc, q, h), dim=2)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           c_mat.reshape(bsz, nc, q, h, n).float(),
                           prev_states) * torch.exp(cum)[..., None]
    y = y_intra.reshape(bsz, nc, q, h, p) + y_inter
    return y.reshape(bsz, nc * q, h, p)[:, :l], state


ssd_scan.launches = 0
