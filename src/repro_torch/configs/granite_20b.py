"""Granite-20B (code): MQA (single KV head).

[arXiv:2405.04324; hf]  52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",  # GPT-BigCode-style MLP (2 matrices), matches 20B,
    microbatches=4,
    shard_activation_seq=True,  # tp fallback (multi-pod)
    parallelism="dp",
)
