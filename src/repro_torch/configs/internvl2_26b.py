"""InternVL2-26B: InternViT frontend (stub) + InternLM2-20B-class backbone.

[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The vision frontend supplies precomputed patch embeddings
(256 patches) via input_specs(); the backbone treats them as a prefix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    activation="swiglu",
    rope_theta=1e6,
    frontend="vision",
    n_prefix_embeds=256,
    microbatches=4,
    shard_activation_seq=True,  # tp fallback (multi-pod)
    parallelism="dp",
)
