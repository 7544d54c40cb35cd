"""Whisper-tiny: encoder-decoder ASR backbone; conv frontend stubbed.

[arXiv:2212.04356; unverified]  4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  input_specs() supplies 1500 precomputed frame embeddings;
the decoder runs the assigned LM shapes.  RoPE replaces Whisper's learned
positions (TPU adaptation, noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    frontend="audio",
    enc_layers=4,
    enc_seq=1500,
    xent_chunk=4096,  # seq is model-sharded (odd heads): no xent seq-scan
    parallelism="dp",
)
