"""Kernel K6, split-K flash decoding over a ragged KV cache (CUDA,
sm_90a), beside its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.decode_attention.ops import (combine_over_ranks,
                                                     decode_attention,
                                                     decode_attention_lse)

__all__ = ["combine_over_ranks", "decode_attention", "decode_attention_lse"]
