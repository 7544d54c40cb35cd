"""Model configuration: one dataclass covering all assigned families.

Families: dense / moe / ssm / hybrid / encdec (audio) / vlm.  Every assigned
architecture is expressed as a ``ModelConfig``; reduced smoke variants are
derived with ``smoke()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    activation: str = "swiglu"     # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Zamba2-style shared attention) -----------------------------
    attn_every: int = 0            # apply the shared attn block every N blocks

    # --- frontends (stubs: precomputed embeddings as inputs) ----------------
    frontend: str = "none"         # none | vision | audio
    n_prefix_embeds: int = 0       # vision patches prepended to the sequence
    enc_layers: int = 0            # encoder depth (encdec)
    enc_seq: int = 0               # encoder sequence length (audio frames)

    # --- numerics / memory ---------------------------------------------------
    param_dtype: str = "bfloat16"
    optimizer_state_dtype: str = "float32"
    remat: str = "full"            # full | dots | none
    xent_chunk: int = 2048         # sequence chunk for streamed cross-entropy
    microbatches: int = 1          # gradient-accumulation steps per batch
    shard_activation_seq: bool = False  # Megatron-SP-style between-block seq
    # Parallelism policy for train shapes: "tp" = tensor parallel over the
    # model axis (default); "dp" = pure data parallel + ZeRO-3 when the
    # global batch divides the mesh (falls back to tp otherwise).
    parallelism: str = "tp"

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------ dims
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_layers(self) -> int:
        """Number of attention applications in one forward pass."""
        if self.family in ("dense", "moe", "vlm"):
            return self.n_layers
        if self.family == "encdec":
            return self.enc_layers + 2 * self.n_layers  # self + cross
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers // self.attn_every
        return 0

    @property
    def ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid":
            return self.n_layers
        return 0

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + \
            (self.n_heads * hd) * d if self.n_heads else 0

        def ffn_params(dff: int) -> int:
            mult = 3 if self.activation == "swiglu" else 2
            return mult * d * dff

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn + ffn_params(self.d_ff)
            total += self.n_layers * per_layer
        elif self.family == "moe":
            experts = (self.n_experts + self.n_shared_experts) * \
                ffn_params(self.d_ff)
            router = d * self.n_experts
            total += self.n_layers * (attn + experts + router)
        elif self.family == "ssm":
            total += self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            total += self.n_layers * self._ssm_block_params()
            total += attn + ffn_params(self.d_ff)  # one shared attn+MLP block
        elif self.family == "encdec":
            total += self.enc_layers * (attn + ffn_params(self.d_ff))
            total += self.n_layers * (2 * attn + ffn_params(self.d_ff))
        return total

    def _ssm_block_params(self) -> int:
        d, di, s = self.d_model, self.d_inner, self.ssm_state
        # in_proj (x, z, B, C, dt) + conv + out_proj (Mamba2 structure).
        in_proj = d * (2 * di + 2 * s + self.n_ssm_heads)
        conv = self.ssm_conv_width * (di + 2 * s)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * self.n_ssm_heads

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mult = 3 if self.activation == "swiglu" else 2
        dense = self.param_count() - self.n_layers * (
            self.n_experts * mult * d * self.d_ff)
        active = self.n_layers * (self.moe_top_k * mult * d * self.d_ff)
        return dense + active

    def flops_per_token(self, seq_len: int = 0) -> float:
        """~6*N_active per trained token (+ attention quadratic term)."""
        base = 6.0 * self.active_param_count()
        if seq_len and self.attn_layers:
            # 12 * L_attn * d_head * n_heads * seq  (fwd+bwd QK^T and AV)
            base += 12.0 * self.attn_layers * self.n_heads * self.head_dim \
                * seq_len
        return base

    # ------------------------------------------------------------- variants
    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(self.n_layers, 2) if self.attn_every == 0
                         else 2 * self.attn_every),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=8 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            param_dtype="float32",
            remat="none",
            xent_chunk=64,
            microbatches=1,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def sub_quadratic(config: ModelConfig) -> bool:
    """long_500k eligibility: SSM/hybrid state keeps decode state bounded."""
    return config.family in ("ssm", "hybrid")


def shapes_for(config: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if sub_quadratic(config):
        out.append("long_500k")
    return out
