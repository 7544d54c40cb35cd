"""Granite-8B (code): llama-arch GQA.

[arXiv:2405.04324; hf]  36L d_model=4096 32H (kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    microbatches=4,   # used by the tp fallback (multi-pod); dp path uses 1
    parallelism="dp",
)
