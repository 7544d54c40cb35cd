"""Kernel K4, causal GQA flash attention forward (CUDA, sm_90a), beside
its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
