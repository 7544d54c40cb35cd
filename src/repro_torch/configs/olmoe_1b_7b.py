"""OLMoE-1B-7B: 64-expert top-8 MoE, 1B active / 7B total.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (kv=16) d_ff=1024/expert
vocab=50304.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    moe_top_k=8,
    microbatches=2,
)
