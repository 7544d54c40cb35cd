"""Operations, bytes and model FLOPs worked out from shapes, whatever
implements them, and the published peaks they are set against.

``model`` is a configuration file's ``run_as`` block (the port's widths as
it runs them).  A batch is ``(n, S, steps)``: ``n`` prompts of ``S``
tokens served ``steps`` greedy tokens (a prefill and ``steps - 1`` decode
steps, as ``serve_loop.generate`` runs them).
"""

from __future__ import annotations

import json
from pathlib import Path

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def attention_params(m: dict) -> int:
    d, hd = m["d_model"], m["head_dim"]
    return d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2


def active_params(m: dict) -> int:
    """Parameters a token passes through outside the embedding and the LM
    head: attention, and the MLP or the router and the top-k experts."""
    ffn = 3 * m["d_model"] * m["d_ff"]
    per_layer = attention_params(m)
    if m["family"] == "moe":
        per_layer += m["d_model"] * m["n_experts"] + m["moe_top_k"] * ffn
    else:
        per_layer += ffn
    return m["n_layers"] * per_layer


def causal_pairs(s: int) -> int:
    """Query-key pairs of a causal prefill of ``s`` tokens."""
    return s * (s + 1) // 2


def model_flops(m: dict, batch: tuple) -> float:
    """Model FLOPs of one served batch: the linear layers at 2 a parameter
    a token, attention's two products (causal at prefill, over the cache in
    each decode step), and the LM head at every position whose logits
    ``generate`` returns (the prompt's last and each decode step's)."""
    n, s, steps = batch
    tokens = n * (s + steps - 1)
    width = m["n_heads"] * m["head_dim"]
    attn = 4 * n * width * causal_pairs(s)
    attn += sum(4 * n * width * (s + j) for j in range(1, steps))
    head = 2 * m["d_model"] * m["vocab_size"] * n * steps
    return 2.0 * active_params(m) * tokens + m["n_layers"] * attn + head


def k4_call(m: dict, n: int, s: int, dtype_bytes: int = 2) -> tuple:
    """``(operations, bytes)`` of one K4 call: a causal prefill of ``n``
    prompts of ``s`` tokens; q, k, v and o once, the float32 lse once."""
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ops = 4 * n * hq * hd * causal_pairs(s)
    nbytes = (2 * n * s * hq * hd + 2 * n * s * hkv * hd) * dtype_bytes \
        + 4 * n * hq * s
    return float(ops), float(nbytes)


def k7_calls(m: dict, tokens: int, dtype_bytes: int = 2) -> list:
    """``(operations, bytes)`` of the three K7 calls of one MoE layer over
    ``tokens`` tokens: the gate, up and down products of the ``tokens *
    top_k`` routed rows (not the padded capacity), each with its rows, the
    experts' weights and its output once."""
    rows = tokens * m["moe_top_k"]
    d, f, e = m["d_model"], m["d_ff"], m["n_experts"]
    ops = 2.0 * rows * d * f
    nbytes = float((rows * d + e * d * f + rows * f) * dtype_bytes)
    return [(ops, nbytes)] * 3


def bound_s(ops: float, nbytes: float, peaks: dict = PEAKS) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(ops / peaks["bf16_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
