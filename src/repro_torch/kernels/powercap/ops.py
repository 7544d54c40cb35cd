"""Wrappers of the powercap kernels: checks, launch counters, dispatch.

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor runs the
plain PyTorch version from ``ref.py``.  Inputs that are not tensors are
placed on ``device`` (default: the GPU).  ``<wrapper>.launches`` counts
the kernel launches, so a run can show that it went through the kernels.

  * :func:`waterfill_dense` -- kernel K1, the dense waterfill (tick
    delivery).
  * :func:`balance_caps` -- kernel K2, the whole BalancePowerCap loop with
    its candidate-cap waterfills, one launch per manager invocation.
"""

from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.core.kernels import DenseCols, HostCols
from repro_torch.kernels.powercap import kernel, ref

_F64, _BOOL = torch.float64, torch.bool


def _device(first, device) -> torch.device:
    if device is None and isinstance(first, torch.Tensor):
        return first.device
    return resolve_device(device)


def _col(x, dtype, dev: torch.device, name: str, shape=None):
    """``x`` as a contiguous tensor of ``dtype`` (and ``shape``, when
    given) on ``dev``; array-likes are converted, tensors must match."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device.type != dev.type:
        raise ValueError(f"{name}: on {x.device}, expected {dev.type}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return x


def waterfill_dense(capacity, floors, ceilings, weights, iters: int = 200,
                    active=None, device=None):
    """Dense weighted max-min waterfill: ``capacity (..., H)`` against slot
    columns ``(..., H, J)``; returns the ``(..., H, J)`` allocation."""
    dev = _device(floors, device)
    fl = _col(floors, _F64, dev, "floors")
    shape = tuple(fl.shape)
    cap = _col(capacity, _F64, dev, "capacity", shape[:-1])
    ce = _col(ceilings, _F64, dev, "ceilings", shape)
    w = _col(weights, _F64, dev, "weights", shape)
    act = (torch.ones(shape, dtype=_BOOL, device=dev) if active is None
           else _col(active, _BOOL, dev, "active", shape))
    if fl.numel() == 0:
        return torch.zeros(shape, dtype=_F64, device=dev)
    if dev.type == "cpu":
        return ref.waterfill_dense_ref(cap, fl, ce, w, iters, act)
    out = torch.empty(shape, dtype=_F64, device=dev)
    kernel.waterfill(cap, fl, ce, w, act, out, int(iters))
    waterfill_dense.launches += 1
    return out


waterfill_dense.launches = 0


def balance_caps(hosts: HostCols, caps, dense: DenseCols, cpu_reserved,
                 budget, enabled, params, device=None):
    """The BalancePowerCap loop for every cell: host columns ``(S, H)``,
    slot columns ``(S, H, J)``, ``budget``/``enabled`` ``(S,)``.

    Returns ``(caps, did, rounds)``: the balanced caps, whether each cell
    committed a round, and how many rounds each cell entered (``int32``).
    """
    dev = _device(caps, device)
    cp = _col(caps, _F64, dev, "caps")
    s, h = cp.shape
    fl = _col(dense.floors, _F64, dev, "floors")
    ss = (s, h, fl.shape[-1])
    hosts = HostCols(_col(hosts.on, _BOOL, dev, "on", (s, h)),
                     *(_col(c, _F64, dev, n, (s, h)) for c, n in zip(
                         hosts[1:], HostCols._fields[1:])))
    dense = DenseCols(_col(fl, _F64, dev, "floors", ss),
                      _col(dense.ceils, _F64, dev, "ceils", ss),
                      _col(dense.weights, _F64, dev, "weights", ss),
                      _col(dense.active, _BOOL, dev, "active", ss),
                      int(dense.iters))
    cres = _col(cpu_reserved, _F64, dev, "cpu_reserved", (s, h))
    bud = _col(budget, _F64, dev, "budget", (s,))
    en = _col(enabled, _BOOL, dev, "enabled", (s,))
    if s == 0 or h == 0:
        return (cp, torch.zeros(s, dtype=_BOOL, device=dev),
                torch.zeros(s, dtype=torch.int32, device=dev))
    if ss[2] == 0:
        # No slots: one inactive slot keeps the waterfill well formed (the
        # masked slot allocates nothing).
        dense = DenseCols(*(torch.zeros((s, h, 1), dtype=c.dtype, device=dev)
                            for c in dense[:4]), dense.iters)
    if dev.type == "cpu":
        return ref.balance_caps_ref(hosts, cp, dense, cres, bud, en, params)
    if kernel.balance_smem_bytes(h) > kernel.MAX_SMEM_BYTES:
        raise ValueError(f"balance_caps kernel: {h} hosts per cell do not "
                         f"fit one block's shared memory")
    caps_out = torch.empty((s, h), dtype=_F64, device=dev)
    did = torch.empty(s, dtype=_BOOL, device=dev)
    rounds = torch.empty(s, dtype=torch.int32, device=dev)
    kernel.balance_caps((*hosts, *dense[:4], cres, bud, en, cp), caps_out,
                        did, rounds, iters=dense.iters, params=params)
    balance_caps.launches += 1
    return caps_out, did, rounds


balance_caps.launches = 0
