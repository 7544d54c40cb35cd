"""Kernel K7, the grouped expert GEMM (CUDA, sm_90a), beside its plain
PyTorch version (``ref.py``)."""

from repro_torch.kernels.moe_gmm.ops import grouped_matmul

__all__ = ["grouped_matmul"]
