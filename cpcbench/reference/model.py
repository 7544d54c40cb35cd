"""The served decoder in plain PyTorch, float32 with TF32 off, computed a
layer at a time over whole sequences.

It follows the port's model as a configuration file's ``run_as`` block
states it, departures from the published model included (the file's
``departures``): pre-norm RMSNorm blocks, rotary embeddings on half-split
features, grouped-query attention (query head ``h`` reads kv head ``h //
(n_heads / n_kv_heads)``), a SwiGLU MLP, or a token-choice MoE layer whose
top-k gates are renormalized and whose pairs past an expert's capacity
add nothing.  The capacity is the port's: ``max(8, ceil8(int(T k cf //
E)))`` for the ``T`` tokens routed together, each routing group's pairs
ranked within their expert in (token, k) order.  A served batch routes
its prompt as one group (the prefill) and each later position as one
group of one token a request (a decode step).

The weights are a nested dict in the port's layout (``x @ W``): ``embed``,
``unembed`` (none where ``tie_embeddings``: the head is the embedding
table's transpose), ``final_norm`` and the stacked ``blocks``.  With ``fp8`` every
product that reads a weight reads it and its input rounded to float8
e4m3 (a scale per tensor; per expert for the experts' weights), the rest
in float32: the benchmark's control, one precision below bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F8_MAX = 448.0        # the largest finite float8 e4m3fn


def strict_float32() -> None:
    """Products in true float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    return (to_fp8(x) if fp8 else x) @ w


def _weight(w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.float()
    if not fp8:
        return w
    if w.dim() == 3:
        return torch.stack([to_fp8(e) for e in w])
    return to_fp8(w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (L, H, D) at positions 0 .. L-1; angles in float64."""
    length, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(length, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(x: torch.Tensor, w: dict, m: dict, fp8: bool,
              block: int = 512) -> torch.Tensor:
    """Causal self-attention of one sequence x: (L, d)."""
    length = x.shape[0]
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(_mm(x, w["wq"], fp8).view(length, hq, hd), m["rope_theta"])
    k = rope(_mm(x, w["wk"], fp8).view(length, hkv, hd), m["rope_theta"])
    v = _mm(x, w["wv"], fp8).view(length, hkv, hd)
    k = k.repeat_interleave(hq // hkv, 1).transpose(0, 1)     # (Hq, L, D)
    v = v.repeat_interleave(hq // hkv, 1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty((hq, length, hd), device=x.device)
    for a in range(0, length, block):
        e = min(a + block, length)
        s = q[:, a:e] @ k[:, :e].transpose(1, 2)              # (Hq, b, e)
        rows = torch.arange(a, e, device=x.device)[:, None]
        s.masked_fill_(torch.arange(e, device=x.device)[None] > rows,
                       float("-inf"))
        out[:, a:e] = torch.softmax(s, -1) @ v[:, :e]
    return _mm(out.transpose(0, 1).reshape(length, hq * hd), w["wo"], fp8)


def mlp(x: torch.Tensor, w: dict, fp8: bool) -> torch.Tensor:
    h = F.silu(_mm(x, w["w_gate"], fp8)) * _mm(x, w["w_up"], fp8)
    return _mm(h, w["w_down"], fp8)


def capacity(tokens: int, m: dict) -> int:
    cap = int(tokens * m["moe_top_k"] * m["moe_capacity_factor"]
              // m["n_experts"])
    return max(8, (cap + 7) // 8 * 8)


def route(xt: torch.Tensor, router: torch.Tensor, m: dict, fp8: bool):
    """One routing group's ``(expert ids (T, k), gates (T, k), kept (T,
    k))``: softmax, the k largest (ties to the lower expert), gates
    renormalized, each expert's first ``capacity(T)`` pairs in (token, k)
    order kept."""
    k, e = m["moe_top_k"], m["n_experts"]
    probs = torch.softmax(_mm(xt, router, fp8), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    ranked = torch.arange(flat.numel(), device=xt.device) - starts[flat[order]]
    rank = torch.empty_like(ranked)
    rank[order] = ranked
    keep = (rank < capacity(xt.shape[0], m)).view_as(idx)
    return idx, gates, keep


def moe(x: torch.Tensor, w: dict, m: dict, groups: list, fp8: bool
        ) -> torch.Tensor:
    """The MoE layer over x: (n, L, d), each ``(p0, p1)`` of ``groups`` the
    positions whose tokens of every sequence are routed together."""
    n, length, d = x.shape
    flat_x = x.reshape(n * length, d)
    toks, experts, gates = [], [], []
    for p0, p1 in groups:
        tok = (torch.arange(n, device=x.device)[:, None] * length
               + torch.arange(p0, p1, device=x.device)).reshape(-1)
        idx, g, keep = route(flat_x[tok], w["router"], m, fp8)
        tok = tok[:, None].expand_as(idx)
        toks.append(tok[keep])
        experts.append(idx[keep])
        gates.append(g[keep])
    tok, ex, gate = (torch.cat(t) for t in (toks, experts, gates))
    out = torch.zeros_like(flat_x)
    for e in range(m["n_experts"]):
        sel = ex == e
        rows = tok[sel]
        if rows.numel() == 0:
            continue
        xe = flat_x[rows]
        h = F.silu(_mm(xe, w["w_gate"][e], fp8)) * _mm(xe, w["w_up"][e], fp8)
        out.index_add_(0, rows, _mm(h, w["w_down"][e], fp8)
                       * gate[sel][:, None])
    return out.view(n, length, d)


def _layer(weights: dict, i: int, fp8: bool) -> dict:
    return {name: _weight(t[i], fp8) if t.dim() > 2 else t[i].float()
            for name, t in weights["blocks"].items()}


def logits(weights: dict, m: dict, tokens: torch.Tensor, prompt_len: int,
           steps: int, fp8: bool = False, rows: int = 4096) -> torch.Tensor:
    """The float32 logits ``(n, steps, V)`` at positions ``prompt_len - 1
    ..`` of sequences ``tokens`` (n, prompt_len + steps - 1): each prompt
    and the tokens it was served but the last."""
    strict_float32()
    n, length = tokens.shape
    eps = m["norm_eps"]
    h = weights["embed"]["table"][tokens].float()
    groups = [(0, prompt_len)] + [(p, p + 1)
                                  for p in range(prompt_len, length)]
    for i in range(m["n_layers"]):
        w = _layer(weights, i, fp8)
        for b in range(n):
            h[b] += attention(rms_norm(h[b], w["ln1"], eps), w, m, fp8)
        if m["family"] == "moe":
            h += moe(rms_norm(h, w["ln2"], eps), w, m, groups, fp8)
        else:
            for b in range(n):
                for a in range(0, length, rows):
                    hb = h[b, a:a + rows]
                    hb += mlp(rms_norm(hb, w["ln2"], eps), w, fp8)
        del w
    last = h[:, prompt_len - 1:prompt_len - 1 + steps]
    last = rms_norm(last, weights["final_norm"]["scale"].float(), eps)
    head = (weights["embed"]["table"].T if m.get("tie_embeddings")
            else weights["unembed"]["table"])
    return _mm(last, _weight(head, fp8), fp8)
