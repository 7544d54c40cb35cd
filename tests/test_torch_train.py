"""The port's training path against the JAX reference's, on the CPU.

Inputs are drawn with NumPy from a seed and handed to both packages; the
reference's train state is carried across with
``convert.from_reference_train_state``.  On the CPU the port's attention
runs the plain versions of kernels K4 and K5 through the same
``torch.autograd.Function`` that launches the kernels on the card.
Tolerances are stated with each test: the reference's own for the
attention backward (``tests/test_kernels_bwd.py``: 1e-4 in float32; 2e-2
in bfloat16), 1e-5 for losses and 1e-4 relative L2 for gradients and
parameters in float32.
"""

import contextlib
import dataclasses
import io
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.core.power_model import PAPER_HOST as REF_PAPER_HOST
from repro.core.power_model import TPU_V5E_HOST
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.drs import snapshot as ref_snapshot
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.launch import train as ref_train
from repro.models import layers as ref_layers
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import schedule as ref_schedule
from repro.runtime import power_integration as ref_pi
from repro.runtime import train_loop as ref_loop
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import from_reference_train_state
from repro_torch.core.power_model import PAPER_HOST, HostPowerSpec
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.drs import snapshot
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import kernel_bwd as fa_kernel_bwd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, compress, schedule
from repro_torch.runtime import power_integration as pi
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves, leaves_with_path, map_tree

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: ``tests/test_kernels_bwd.py``'s tolerance in float32; the reference's
#: bfloat16 tolerance.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _pair(rng, shape, dtype="float32", scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, dtype=JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _spec(ref_spec) -> HostPowerSpec:
    return HostPowerSpec(**{f.name: getattr(ref_spec, f.name)
                            for f in dataclasses.fields(HostPowerSpec)})


# ------------------------------------------------------------------ K5
BWD_CASES = [
    (2, 96, 96, 4, 2, 32, True, 0, "float32"),
    (1, 128, 128, 4, 1, 64, True, 0, "float32"),     # MQA
    (2, 64, 64, 2, 2, 16, False, 0, "float32"),      # bidirectional
    (1, 100, 100, 4, 2, 32, True, 0, "float32"),     # non-multiple of block
    (2, 96, 96, 4, 2, 32, True, 0, "bfloat16"),
    (1, 64, 128, 4, 2, 32, True, 64, "float32"),     # continuation
    (1, 72, 72, 2, 2, 112, True, 0, "float32"),      # Zamba2's head dim
    (2, 96, 96, 4, 2, 112, True, 0, "bfloat16"),     # the same, GQA
    (1, 64, 64, 2, 1, 192, True, 0, "float32"),      # Nemotron's head dim
    (1, 64, 64, 2, 1, 192, True, 0, "bfloat16"),
    (1, 64, 64, 2, 1, 256, True, 0, "float32"),      # K5's widest
    (1, 64, 64, 2, 1, 256, True, 0, "bfloat16"),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,qoff,dtype", BWD_CASES)
def test_k5_plain_matches_pallas_vjp_and_oracle(b, sq, skv, hq, hkv, d,
                                                causal, qoff, dtype):
    """The Function's backward (K5's plain version on the CPU) against the
    reference's Pallas custom VJP in interpret mode (blocks of 32) and
    against ``jax.grad`` of ``attention_ref``."""
    rng = np.random.default_rng(sq * 7 + skv + d)
    jq, tq = _pair(rng, (b, sq, hq, d), dtype)
    jk, tk = _pair(rng, (b, skv, hkv, d), dtype)
    jv, tv = _pair(rng, (b, skv, hkv, d), dtype)
    jct, tct = _pair(rng, (b, sq, hq, d), dtype)

    def loss_pallas(q, k, v):
        out = pallas_flash(q, k, v, causal=causal, q_offset=qoff,
                           block_q=32, block_k=32)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))

    def loss_ref(q, k, v):
        out = jax_attn_ref(q, k, v, causal=causal, q_offset=qoff)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))

    g_pallas = jax.grad(loss_pallas, argnums=(0, 1, 2))(jq, jk, jv)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out, lse = fa_ops.flash_attention(tq, tk, tv, causal=causal,
                                      q_offset=qoff)
    assert not lse.requires_grad
    got = torch.autograd.grad(out, (tq, tk, tv), tct)
    tol = BWD_TOL[dtype]
    for name, a, p, r in zip(("dq", "dk", "dv"), got, g_pallas, g_ref):
        assert a.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(a), _np(p), rtol=tol, atol=tol,
                                   err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(_np(a), _np(r), rtol=tol, atol=tol,
                                   err_msg=f"{name} vs attention_ref")
    assert fa_ops.flash_attention.launches == 0
    assert fa_ops.flash_attention_bwd.launches == 0


# ------------------------------------------------------------- K5's plan
def test_k5_plan_puts_path_t_on_the_tensor_cores():
    """Path T's layer (MiniCPM-2B: 4 x 4096, 36/36 heads of 64) in bf16:
    the dk/dv kernel one block per (128 keys, KV head, batch row), the dq
    kernel one per (192 query rows, query head, batch row)."""
    cfg = configs.get("minicpm_2b")
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = fa_kernel_bwd.plan(4, 4096, 4096, hq, hkv, d, torch.bfloat16)
    assert p.regime == "tensor_core"
    assert p.grid == ((hkv, 4, 32), (hq, 4, 22))
    assert all(0 < m <= fa_kernel.SMEM_LIMIT for m in p.smem_bytes)


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_plan_regimes_and_shared_memory(d, dtype):
    """K5 takes D 112 and D 256 in both dtypes (fault P1); bf16 at D 64,
    112 and 128 runs on the tensor cores, the rest on the CUDA cores, with
    blocks of 64 rows (32 at D 256), and every launch fits a block's
    shared memory."""
    assert d in fa_kernel_bwd.HEAD_DIMS
    p = fa_kernel_bwd.plan(8, 512, 512, 32, 32, d, dtype)
    tc = dtype == torch.bfloat16 and d in (64, 112, 128)
    assert p.regime == ("tensor_core" if tc else "cuda_core")
    assert all(0 < m <= fa_kernel.SMEM_LIMIT for m in p.smem_bytes)
    if not tc:
        n = 512 // fa_kernel_bwd.core_rows(d)
        assert p.grid == ((n, 32, 8), (n, 32, 8))
        assert fa_kernel_bwd.core_rows(d) == (32 if d == 256 else 64)


def test_k5_plan_at_head_dim_256_fits_shared_memory():
    """At D 256 the CUDA-core kernels take 32-row blocks: 4 x (4 x 32 x 257
    + 2 x 32 x 33 + 2 x 32) = 140,288 bytes a block, where 64 rows would
    take 296,960, past the 232,448 an H100 block may have."""
    p = fa_kernel_bwd.plan(2, 256, 256, 8, 2, 256, torch.bfloat16)
    assert p.regime == "cuda_core"
    assert p.smem_bytes == (140_288, 140_288)
    assert p.grid == ((8, 2, 2), (8, 8, 2))
    assert 4 * (4 * 64 * 257 + 2 * 64 * 65 + 2 * 64) == 296_960
    assert 296_960 > fa_kernel.SMEM_LIMIT >= p.smem_bytes[0]


@pytest.mark.parametrize("kw", [
    {"aligned": False},
    # dO's row pitch of 32 x 64 + 4 elements
    {"strides": ((512 * 2048, 2048, 64), (512 * 2048, 2048, 64),
                 (512 * 2048, 2048, 64), (512 * 2052, 2052, 64))},
])
def test_k5_plan_keeps_what_tma_cannot_read_on_the_cuda_cores(kw):
    assert fa_kernel_bwd.plan(1, 512, 512, 32, 32, 64, torch.bfloat16,
                              **kw).regime == "cuda_core"


# --------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_vjp_matches_reference(dtype):
    """dx in x's dtype, dscale summed in float32 and cast to the scale's
    dtype: 1e-5 in float32, 2e-2 in bfloat16."""
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (3, 7, 32), dtype)
    js, ts = _pair(rng, (32,), dtype, 0.5)
    jdy, tdy = _pair(rng, (3, 7, 32), dtype)
    y, vjp = jax.vjp(lambda x, s: ref_layers.rms_norm(x, s, 1e-5), jx, js)
    dx, ds = vjp(jdy)
    tx.requires_grad_()
    ts.requires_grad_()
    ty = layers.rms_norm(tx, ts, 1e-5)
    tdx, tds = torch.autograd.grad(ty, (tx, ts), tdy)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert tdx.dtype == tds.dtype == TDT[dtype]
    for got, want in ((ty, y), (tdx, dx), (tds, ds)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_xent_value_and_grad_match_reference(dtype):
    """37 positions in chunks of 16 (the reference pads to 48), padding
    and one masked-out example in the weights: the sums and the gradients
    in h and w_out within 1e-5 (float32) or 2e-2 (bfloat16)."""
    rng = np.random.default_rng(5)
    b, s, d, v = 3, 37, 16, 50
    jh, th = _pair(rng, (b, s, d), dtype)
    jw, tw = _pair(rng, (d, v), dtype, 0.5)
    labels = rng.integers(0, v, (b, s))
    weights = np.ones((b, s), np.float32)
    weights[0, 30:] = 0.0
    weights[2] = 0.0

    def ref_loss(h, w):
        return ref_layers.streamed_xent(h, w, jnp.asarray(labels),
                                        jnp.asarray(weights), chunk=16)

    (ls, ws), vjp = jax.vjp(ref_loss, jh, jw)
    dh, dw = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
    th.requires_grad_()
    tw.requires_grad_()
    tls, tws = layers.streamed_xent(th, tw, torch.from_numpy(labels),
                                    torch.from_numpy(weights), chunk=16)
    tdh, tdw = torch.autograd.grad(tls, (th, tw))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert float(tws) == float(ws) == 3 * s - 7 - s
    np.testing.assert_allclose(float(tls.detach()), float(ls), rtol=tol)
    assert tdh.dtype == tdw.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(tdh), _np(dh), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tdw), _np(dw), rtol=tol, atol=tol)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_keep_the_gradients(remat):
    """Checkpointed layers (recomputed in the backward) give the gradients
    of the plain forward, bit for bit on the CPU."""
    cfg = configs.get_smoke("minicpm_2b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 24))),
             "labels": torch.from_numpy(rng.integers(0, 256, (2, 24))),
             "weights": torch.ones(2, 24)}
    out = {}
    for policy in ("none", remat):
        grads_fn = train_loop.make_grads_fn(
            dataclasses.replace(cfg, remat=policy))
        out[policy] = grads_fn(params, batch)
    assert torch.equal(out[remat][1]["loss"], out["none"][1]["loss"])
    for a, b in zip(leaves(out[remat][0]), leaves(out["none"][0])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- optim
def _opt_tree(rng):
    return {"blocks": {"w": rng.standard_normal((3, 4, 5)).astype(
                np.float32),
                       "ln": rng.standard_normal((3, 5)).astype(np.float32)},
            "scale": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(clip, state_dtype):
    """Three steps with the WSD schedule, gradients large enough to clip:
    parameters, moments and count within 1e-6 (moments in bfloat16 within
    one bfloat16 step)."""
    rng = np.random.default_rng(11)
    p0 = _opt_tree(rng)
    sched_r = ref_schedule.wsd_schedule(3e-3, 2, 1, 2)
    sched_t = schedule.wsd_schedule(3e-3, 2, 1, 2)
    ropt = ref_adamw.AdamW(learning_rate=sched_r, grad_clip_norm=clip,
                           state_dtype=state_dtype)
    topt = adamw.AdamW(learning_rate=sched_t, grad_clip_norm=clip,
                       state_dtype=state_dtype)
    rparams = jax.tree_util.tree_map(jnp.asarray, p0)
    tparams = map_tree(lambda a: torch.from_numpy(a.copy()), p0)
    rstate, tstate = ropt.init(rparams), topt.init(tparams)
    for _ in range(3):
        g = map_tree(lambda a: (rng.standard_normal(a.shape) * 4.0).astype(
            np.float32), p0)
        rparams, rstate = ropt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      rstate, rparams)
        tparams, tstate = topt.update(map_tree(torch.from_numpy, g), tstate,
                                      tparams)
    assert int(tstate.count) == int(rstate.count) == 3
    tol = 1e-2 if state_dtype == "bfloat16" else 1e-6
    for path, t in leaves_with_path(tparams):
        np.testing.assert_allclose(_np(t), _np(_ref_leaf(rparams, path)),
                                   rtol=1e-6, atol=1e-6)
    for mine, theirs in ((tstate.m, rstate.m), (tstate.v, rstate.v)):
        for path, t in leaves_with_path(mine):
            assert t.dtype == TDT[state_dtype]
            np.testing.assert_allclose(_np(t), _np(_ref_leaf(theirs, path)),
                                       rtol=tol, atol=1e-6)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    if name == "cosine":
        r, t = (m.cosine_schedule(1e-3, 10, 100)
                for m in (ref_schedule, schedule))
    else:
        r, t = (m.wsd_schedule(1e-3, 10, 50, 20)
                for m in (ref_schedule, schedule))
    steps = np.arange(0, 130)
    want = np.asarray(r(jnp.asarray(steps)))
    got = t(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # The reference's own checks (tests/test_train_loop.py).
    if name == "cosine":
        assert float(t(0)) == 0.0
        assert np.isclose(float(t(10)), 1e-3, rtol=1e-3)
        assert float(t(100)) < float(t(50))
    else:
        assert np.isclose(float(t(30)), 1e-3)
        assert np.isclose(float(t(59)), 1e-3)
        assert float(t(80)) < 2e-5


def test_int8_compressor_matches_reference():
    """Quantized values and scales equal; error feedback over 20 rounds
    within 1e-6, its residual bounding the cumulative error (the
    reference's own checks)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((128, 64)) * 3.0).astype(np.float32)
    rq, rs = ref_compress.quantize_int8(jnp.asarray(x))
    tq, ts = compress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(ts), float(rs), rtol=1e-7)
    err = (compress.dequantize_int8(tq, ts) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(ts) * 0.51 + 1e-6

    rcomp, tcomp = ref_compress.ErrorFeedbackCompressor(), \
        compress.ErrorFeedbackCompressor()
    g0 = {"w": np.zeros(64, np.float32)}
    rres = rcomp.init(jax.tree_util.tree_map(jnp.asarray, g0))
    tres = tcomp.init(map_tree(torch.from_numpy, g0))
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(20):
        gi = {"w": rng.standard_normal(64).astype(np.float32)}
        rsent, rres = rcomp.compress(jax.tree_util.tree_map(jnp.asarray, gi),
                                     rres)
        tsent, tres = tcomp.compress(map_tree(torch.from_numpy, gi), tres)
        np.testing.assert_allclose(tsent["w"].numpy(), np.asarray(rsent["w"]),
                                   rtol=1e-6, atol=1e-6)
        total_true += gi["w"]
        total_sent += tsent["w"].numpy()
    np.testing.assert_allclose(tres["w"].numpy(), np.asarray(rres["w"]),
                               rtol=1e-5, atol=1e-6)
    gap = float(np.max(np.abs(total_true - total_sent)))
    assert gap <= float(tres["w"].abs().max()) + 1e-4


# ----------------------------------------------------------------- data
def test_synthetic_tokens_are_the_references_bit_for_bit():
    ref = RefTokens(vocab_size=1000, seq_len=16, global_batch=4, seed=3)
    mine = SyntheticTokens(vocab_size=1000, seq_len=16, global_batch=4,
                           seed=3, device="cpu")
    for _ in range(3):
        r, t = ref.next_batch(), mine.next_batch()
        assert t.tokens.dtype == torch.int64
        assert np.array_equal(t.tokens.numpy(), np.asarray(r.tokens))
        assert np.array_equal(t.labels.numpy(), np.asarray(r.labels))
        assert np.array_equal(t.weights.numpy(), np.asarray(r.weights))
    assert mine.state_dict() == ref.state_dict() == {"seed": 3, "step": 3}
    # Restore from a checkpointed cursor: the same stream.
    again = SyntheticTokens(vocab_size=1000, seq_len=16, global_batch=4,
                            device="cpu")
    again.load_state_dict({"seed": 3, "step": 1})
    second = SyntheticTokens(vocab_size=1000, seq_len=16, global_batch=4,
                             seed=3, device="cpu")
    second.next_batch()
    assert torch.equal(again.next_batch().tokens, second.next_batch().tokens)


# ----------------------------------------------------------- train step
def _batch(cfg, rng, b=4, s=24):
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    weights = np.ones((b, s), np.float32)
    weights[b // 2 + 1:] = 0.0               # a pod's masked examples
    weights[0, s - 5:] = 0.0                 # padding
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32),
             "weights": jnp.asarray(weights)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "weights": torch.from_numpy(weights)})


def _ref_grads(rcfg, params, batch):
    """The reference's gradient (``train_loop.py:101-136``): one
    ``value_and_grad``, or the token-weighted sum over microbatches."""
    loss_fn = ref_loop.make_loss_fn(rcfg)
    k = max(rcfg.microbatches, 1)
    if k == 1:
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch)
        return grads, metrics
    gsum, loss_sum, tok_sum = None, 0.0, 0.0
    for i in range(k):
        mb = {key: jnp.split(v, k)[i] for key, v in batch.items()}
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, mb)
        tok = metrics["tokens"]
        scaled = jax.tree_util.tree_map(lambda g: g * tok, grads)
        gsum = scaled if gsum is None else jax.tree_util.tree_map(
            jnp.add, gsum, scaled)
        loss_sum += metrics["loss"] * tok
        tok_sum += tok
    tok = max(float(tok_sum), 1.0)
    return (jax.tree_util.tree_map(lambda g: g / tok, gsum),
            {"loss": loss_sum / tok, "tokens": tok_sum})


@pytest.mark.parametrize("microbatches,compression",
                         [(1, False), (2, False), (1, True)])
def test_train_step_matches_reference(microbatches, compression):
    """Three steps from the reference's own initial state: loss and tokens
    within 1e-5, every gradient (and the gradients' norm) within 1e-4
    relative each step, and every parameter within 1e-4 relative L2 after
    the three steps."""
    rcfg = dataclasses.replace(ref_configs.get_smoke("granite_8b"),
                               microbatches=microbatches)
    cfg = dataclasses.replace(configs.get_smoke("granite_8b"),
                              microbatches=microbatches)
    sched = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    ropt = ref_adamw.AdamW(learning_rate=ref_schedule.cosine_schedule(
        **sched))
    opt = adamw.AdamW(learning_rate=schedule.cosine_schedule(**sched))
    rstate = ref_loop.init_train_state(jax.random.PRNGKey(0), rcfg, ropt,
                                       compression=compression)
    state = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, device="cpu")
    assert (state.compress_residual is None) != compression
    rstep = jax.jit(ref_loop.make_train_step(rcfg, ropt,
                                             compression=compression))
    step = train_loop.make_train_step(cfg, opt, compression=compression)
    grads_fn = train_loop.make_grads_fn(cfg)
    rng = np.random.default_rng(microbatches)
    for _ in range(3):
        rbatch, batch = _batch(cfg, rng)
        rgrads, _ = _ref_grads(rcfg, rstate.params, rbatch)
        grads, _ = grads_fn(state.params, batch)
        for path, g in leaves_with_path(grads):
            assert _rel_l2(g, _ref_leaf(rgrads, path)) <= 1e-4, path
        rstate, rmetrics = rstep(rstate, rbatch)
        state, metrics = step(state, batch)
        for key in ("loss", "tokens"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(rmetrics[key]), rtol=1e-5,
                                       err_msg=key)
        # The norm of the (compressed) gradients: a gradient's 1e-7 can
        # move one int8 rounding, so it is held to the gradients' bound.
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(rmetrics["grad_norm"]), rtol=1e-4)
    assert state.step == int(rstate.step) == 3
    assert int(state.opt_state.count) == int(rstate.opt_state.count)
    for path, p in leaves_with_path(state.params):
        assert _rel_l2(p, _ref_leaf(rstate.params, path)) <= 1e-4, path


def test_weight_mask_excludes_examples():
    """Power-aware masking: zero-weight examples do not affect the loss
    (the reference's test, ported)."""
    cfg = configs.get_smoke("granite_8b")
    opt = adamw.AdamW(learning_rate=1e-3)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    w_mask = torch.ones(4, 32)
    w_mask[2:] = 0.0
    junk_tokens, junk_labels = tokens.clone(), labels.clone()
    junk_tokens[2:] = (tokens[2:] + 17) % cfg.vocab_size
    junk_labels[2:] = (labels[2:] + 5) % cfg.vocab_size
    out = []
    for t, lab in ((tokens, labels), (junk_tokens, junk_labels)):
        state = train_loop.init_train_state(
            cfg, opt, torch.Generator().manual_seed(0), "cpu")
        step = train_loop.make_train_step(cfg, opt)
        _, m = step(state, {"tokens": t, "labels": lab, "weights": w_mask})
        out.append(m)
    assert abs(float(out[0]["loss"]) - float(out[1]["loss"])) < 1e-5
    assert float(out[0]["tokens"]) == 64.0


def test_loss_decreases_dense():
    """The reference's end-to-end check, ported: 30 steps on the synthetic
    stream lower the loss by more than 0.2."""
    cfg = configs.get_smoke("granite_8b")
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8, seed=7, device="cpu")
    opt = adamw.AdamW(learning_rate=3e-3)
    state = train_loop.init_train_state(
        cfg, opt, torch.Generator().manual_seed(0), "cpu")
    step = train_loop.make_train_step(cfg, opt)
    losses = []
    for _ in range(30):
        b = data.next_batch()
        state, metrics = step(state, {"tokens": b.tokens,
                                      "labels": b.labels,
                                      "weights": b.weights})
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


# ---------------------------------------------------------- power plane
def _snapshots(caps, spec_pair=(REF_PAPER_HOST, PAPER_HOST)):
    out = []
    for mod, spec in zip((ref_snapshot, snapshot), spec_pair):
        hosts = [mod.Host(f"h{i}", spec, power_cap=c)
                 for i, c in enumerate(caps)]
        vms = [mod.VirtualMachine(vm_id=f"job{i}", demand=8000.0,
                                  host_id=f"h{i}") for i in range(len(caps))]
        out.append(mod.ClusterSnapshot(hosts, vms, power_budget=sum(caps)))
    return out


@pytest.mark.parametrize("caps,hysteresis,batch", [
    ([320.0, 250.0], 0.0, 64), ([320.0, 320.0], 0.0, 64),
    ([300.0, 220.0, 260.0, 240.0], 0.05, 96), ([250.0, 180.0], 0.0, 10)])
def test_batch_plans_match_reference(caps, hysteresis, batch):
    """Plans (examples per pod, mask, shares) equal the reference's, also
    after a small cap change that hysteresis absorbs."""
    ref_snap, snap = _snapshots(caps)
    pods = [[f"h{i}"] for i in range(len(caps))]
    rs = ref_pi.PowerAwareBatchScheduler(batch, pods, hysteresis=hysteresis)
    ts = pi.PowerAwareBatchScheduler(batch, pods, hysteresis=hysteresis)
    for _ in range(2):
        rp, tp = rs.plan(ref_snap), ts.plan(snap)
        assert np.array_equal(tp.examples_per_pod, rp.examples_per_pod)
        assert np.array_equal(tp.weights, rp.weights)
        assert np.array_equal(tp.shares, rp.shares)
        assert tp.active_examples == rp.active_examples
        for s in (ref_snap, snap):
            s.hosts["h0"].power_cap -= 4.0
    masked = ts.apply({"weights": torch.ones(batch, 3)}, tp)
    assert float(masked["weights"].sum()) == tp.weights.sum() * 3


@pytest.mark.parametrize("times", [
    {"h0": 1.4, "h1": 1.0, "h2": 1.0}, {"h0": 1.0, "h1": 1.6, "h2": 1.1}])
def test_straggler_mitigation_matches_reference(times):
    """Detection strikes and the rebalanced caps equal the reference's
    (BalancePowerCap on K2's plain version here)."""
    ref_snap, snap = _snapshots([250.0, 250.0, 250.0])
    rm = ref_pi.StragglerMitigator(threshold=0.15, patience=2)
    tm = pi.StragglerMitigator(threshold=0.15, patience=2, device="cpu")
    rrep, trep = ref_pi.StragglerReport(dict(times)), \
        pi.StragglerReport(dict(times))
    for _ in range(2):
        assert tm.detect(trep) == rm.detect(rrep)
    rb = rm.mitigate(ref_snap.clone(), rrep)
    tb = tm.mitigate(snap.clone(), trep)
    assert (rb is None) == (tb is None)
    if tb is not None:
        for h in rb.hosts:
            np.testing.assert_allclose(tb.hosts[h].power_cap,
                                       rb.hosts[h].power_cap, rtol=1e-9)
        assert tb.total_allocated_power() <= snap.power_budget + 1e-6


# ----------------------------------------------------------- checkpoint
def _ref_state(dtype):
    rcfg = dataclasses.replace(ref_configs.get_smoke("granite_8b"),
                               param_dtype=dtype)
    return rcfg, ref_loop.init_train_state(
        jax.random.PRNGKey(0), rcfg,
        ref_adamw.AdamW(state_dtype=dtype), compression=True)


def _leaf_bytes(path) -> dict:
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """The reference's checkpoint restores in the port bit for bit; the
    port's checkpoint of the same state holds the same leaves, by path,
    dtype and bytes.  (In bfloat16 the reference's own restore cannot read
    its ``|V2`` leaves: ROADMAP fault F2.)"""
    rcfg, rstate = _ref_state(dtype)
    cfg = dataclasses.replace(configs.get_smoke("granite_8b"),
                              param_dtype=dtype)
    state = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, device="cpu")
    rck = RefCheckpointer(str(tmp_path / "ref"))
    rpath = rck.save(0, rstate, {"data": {"seed": 0, "step": 0}})
    ck = Checkpointer(str(tmp_path / "port"))
    path = ck.save(0, state, {"data": {"seed": 0, "step": 0}})
    assert _leaf_bytes(path) == _leaf_bytes(rpath)
    assert ck.metadata(0) == rck.metadata(0)

    restored = Checkpointer(str(tmp_path / "ref")).restore(0, state)
    assert restored.step == 0
    for (p, a), (_, b) in zip(
            leaves_with_path(restored.params), leaves_with_path(
                state.params)):
        assert a.dtype == b.dtype and a.requires_grad
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), p
    for mine, theirs in ((restored.opt_state.m, state.opt_state.m),
                         (restored.compress_residual,
                          state.compress_residual)):
        for a, b in zip(leaves(mine), leaves(theirs)):
            assert a.dtype == b.dtype and torch.equal(a.float(), b.float())
    assert torch.equal(restored.opt_state.count, state.opt_state.count)

    target = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), rstate)
    if dtype == "float32":
        back = RefCheckpointer(str(tmp_path / "port")).restore(0, target)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(rstate)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        with pytest.raises(ValueError, match="No cast function"):
            RefCheckpointer(str(tmp_path / "port")).restore(0, target)


def test_checkpointer_async_gc_and_marker(tmp_path):
    """The reference's checkpointer tests, ported: async saves, GC of all
    but ``keep``, metadata, and a step without its marker is invisible."""
    cfg = configs.get_smoke("granite_8b")
    opt = adamw.AdamW()
    state = train_loop.init_train_state(
        cfg, opt, torch.Generator().manual_seed(0), "cpu")
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save_async(step, state, {"data_step": step * 10})
    ck.wait()
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    assert ck.metadata(3)["data_step"] == 30
    back = ck.restore(3, state)
    for a, b in zip(leaves(back.params), leaves(state.params)):
        assert torch.equal(a, b)
    path = ck.save(5, state)
    os.remove(path.replace(".npz", ".json"))
    assert ck.latest_step() == 3


# --------------------------------------------------------------- driver
ARGV = ["--arch", "minicpm_2b", "--smoke", "--steps", "6",
        "--global-batch", "4", "--seq-len", "32", "--pods", "2",
        "--power-budget-drop-at", "1", "--straggler-at", "2",
        "--checkpoint-every", "0"]


def _ref_main_lines(ckpt_dir) -> list[str]:
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["train"] + ARGV + ["--checkpoint-dir", ckpt_dir]
    try:
        with contextlib.redirect_stdout(buf):
            ref_train.main()
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines()


def test_train_driver_matches_reference_plans_and_caps(tmp_path, capsys):
    """The driver with the reference's host spec carried across: its
    printed plans and caps (the budget cut at step 1, the straggler at step
    4 after three strikes) equal the reference driver's."""
    report = train.main(ARGV + ["--device", "cpu", "--checkpoint-dir",
                                str(tmp_path / "port")],
                        host_spec=_spec(TPU_V5E_HOST))
    lines = capsys.readouterr().out.splitlines()
    ref_lines = _ref_main_lines(str(tmp_path / "ref"))

    def events(ls):
        return [ln for ln in ls if "plan" in ln]

    assert events(lines) == events(ref_lines) == [
        "initial batch plan: [2, 2] (shares [0.5, 0.5])",
        "step 1: budget cut; caps=[449, 748] -> plan [1, 2]",
        "step 4: straggler pod1, caps exhausted -> batch replan [1, 2]"]
    assert report.plans == [(0, [2, 2]), (1, [1, 2]), (4, [1, 2])]
    assert report.caps == [(1, "budget cut", [449, 748]),
                           (4, "straggler", [449, 748])]
    assert len(report.losses) == 6 and np.isfinite(report.losses).all()
    assert report.tokens[0] == 4 * 32 and report.tokens[1] == 3 * 32
    assert np.isfinite(report.grad_norms).all()
    assert report.state.step == 6
    assert Checkpointer(str(tmp_path / "port")).latest_step() == 6


def test_train_driver_power_plane_calls_each_kernel_as_often_as_it_launches(
        tmp_path):
    """The driver's power plane on ``H100_HOST`` calls K1-K3's plain
    versions, outermost calls only, as often as the card launches the
    kernels: the budget cut's manager invocation runs K2 and the migration
    balancer (K1 twice: its entitlement waterfill, then the pair refill of
    the one round that finds nothing to move), the straggler K2, and
    neither commits a balance, so no note runs K3.  K2's plain loop calls
    K1's plain waterfill each round, inside the one K2 launch: those calls
    do not count."""
    from repro_torch.kernels.powercap import ref as pc_ref
    names = ("waterfill_dense", "balance_caps", "waterfill_segmented")
    outermost, every, depth = dict.fromkeys(names, 0), dict.fromkeys(
        names, 0), [0]

    def counting(name, fn):
        def call(*args, **kwargs):
            every[name] += 1
            if depth[0] == 0:
                outermost[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                pc_ref, f"{name}_ref",
                counting(name, getattr(pc_ref, f"{name}_ref"))))
        report = train.main(ARGV + ["--device", "cpu", "--checkpoint-dir",
                                    str(tmp_path)])
    assert report.plans == [(0, [2, 2]), (1, [1, 2]), (4, [1, 2])]
    assert outermost == {"waterfill_dense": 2, "balance_caps": 2,
                         "waterfill_segmented": 0}
    assert every["waterfill_dense"] > outermost["waterfill_dense"]
