"""MiniCPM-2B: llama-like; trained with the WSD schedule (repro.optim).

[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    xent_chunk=4096,  # seq is model-sharded (odd heads): no xent seq-scan
    parallelism="dp",  # batch 256 == single-pod mesh: pure DP beats TP (SPerf)
)
