"""Kernel K8, the SSD intra-chunk step (CUDA, sm_90a), beside its plain
PyTorch version (``ref.py``) and the chunked scan around it (``ops.py``)."""

from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["ssd_scan"]
