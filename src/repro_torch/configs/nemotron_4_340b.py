"""Nemotron-4-340B: dense GQA, squared-ReLU MLP.

[arXiv:2402.16819; unverified]  96L d_model=18432 96H (kv=8) d_ff=73728
vocab=256000.  Optimizer states in bf16 (state-memory trick recorded in
EXPERIMENTS.md) so train_4k fits v5e HBM on both dry-run meshes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    optimizer_state_dtype="bfloat16",
    microbatches=8,
    shard_activation_seq=True,
    xent_chunk=4096,  # seq-sharded activations: single-chunk xent
)
