"""Zamba2-7B: Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64.  The shared transformer block (attn+MLP) is one
parameter set applied at 13 sites (81//6), Zamba2-style.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    microbatches=4,   # tp fallback; dp path uses 1
    parallelism="dp",
)
