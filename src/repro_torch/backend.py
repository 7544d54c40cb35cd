"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the GPU.  Where there
is none it raises rather than quietly running the plain versions on the
CPU: a caller that wants the CPU says ``device="cpu"``.
"""

from __future__ import annotations

import torch

#: The devices on which a kernel's wrapper runs its plain version: the CPU,
#: and ``meta`` (stand-ins without data, which compute nothing: the dry
#: run counts a step on them, :mod:`repro_torch.launch.costing`).
PLAIN_DEVICES = ("cpu", "meta")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent
    (``meta`` passes: stand-ins that are counted, never run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda",) + PLAIN_DEVICES:
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
