"""Entitlement waterfill: reservation/limit/shares divvy.

A VM's allocation is at least its floor, at most its ceiling, with the
slack divided in proportion to shares (weighted max-min fairness).  The
batched engine's host scheduler (tick delivery) uses the dense-slot form,
:func:`waterfill_dense`, which is kernel K1 on the GPU and its plain
version on the CPU (:mod:`repro_torch.kernels.powercap.ops`).
"""

from repro_torch.kernels.powercap.ops import waterfill_dense

__all__ = ["waterfill_dense"]
