"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf]  28L d_model=2048 16H (kv=16) d_ff=1408/expert
vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    microbatches=2,
)
