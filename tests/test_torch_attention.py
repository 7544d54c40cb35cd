"""Kernels K4 and K6 and the port's model layers against the JAX reference.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
these tests hold them against the reference's Pallas kernels (in interpret
mode, as ``tests/test_kernels.py`` and ``tests/test_decode_kernel.py`` run
them) and its oracles, and hold ``repro_torch.models.layers`` against
``repro.models.layers``.  Inputs are drawn with NumPy from a seed and
handed to both packages.  Tolerances are the reference's own ``_tol``:
2e-5 in float32 and 2e-2 in bfloat16 for the kernels, 1e-5 in float32 for
the layers.  The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.
"""

import dataclasses
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import kernel_bwd as fa_kernel_bwd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype="float32", scale=1.0):
    """The same values for both packages: float32 from NumPy, rounded to
    bfloat16 identically on both sides when asked."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


# ------------------------------------------------------------------ K4
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 1, 128, True, 0),     # MQA
    (2, 100, 100, 4, 4, 32, True, 0),      # non-multiple of block
    (1, 1, 384, 4, 2, 64, True, 383),      # decode
    (2, 64, 64, 4, 2, 64, False, 0),       # bidirectional
    (1, 96, 160, 2, 2, 16, True, 64),      # continuation prefill
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,qoff", FLASH_CASES)
def test_k4_plain_matches_pallas_and_oracle(b, sq, skv, hq, hkv, d, causal,
                                            qoff, dtype):
    rng = np.random.default_rng(sq * 31 + skv + d)
    jq, tq = _pair(rng, (b, sq, hq, d), dtype)
    jk, tk = _pair(rng, (b, skv, hkv, d), dtype)
    jv, tv = _pair(rng, (b, skv, hkv, d), dtype)
    out, lse = fa_ops.flash_attention(tq, tk, tv, causal=causal,
                                      q_offset=qoff)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert out.shape == (b, sq, hq, d) and lse.shape == (b, hq, sq)
    p_out, p_lse = flash_attention_kernel(jq, jk, jv, causal=causal,
                                          q_offset=qoff, block_q=64,
                                          block_k=64, interpret=True)
    oracle = jax_attn_ref(jq, jk, jv, causal=causal, q_offset=qoff)
    np.testing.assert_allclose(_np(out), _np(p_out), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))
    np.testing.assert_allclose(lse.numpy(), _np(p_lse), **_tol(dtype))
    np.testing.assert_allclose(
        _np(fa_ref.attention_ref(tq, tk, tv, causal=causal, q_offset=qoff)),
        _np(oracle), **_tol(dtype))


def test_k4_reads_a_view_into_a_longer_cache():
    """The prefill's K and V are the cache's first rows: a view with the
    cache's batch stride gives what a packed copy gives."""
    rng = np.random.default_rng(5)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 64, 2, 16))
                             .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16))
                         .astype(np.float32))
    view_out, view_lse = fa_ops.flash_attention(
        q, cache[0, :, :40], cache[1, :, :40], q_offset=16)
    copy_out, copy_lse = fa_ops.flash_attention(
        q, cache[0, :, :40].contiguous(), cache[1, :, :40].contiguous(),
        q_offset=16)
    assert torch.equal(view_out, copy_out) and torch.equal(view_lse,
                                                           copy_lse)


def test_k4_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 6, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q, torch.zeros(1, 4, 4, 16),
                               torch.zeros(1, 4, 4, 16))
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.flash_attention(q, torch.zeros(1, 4, 2, 16),
                               torch.zeros(1, 4, 2, 16, dtype=torch.float64))
    before = fa_ops.flash_attention.launches
    fa_ops.flash_attention(q, torch.zeros(1, 4, 2, 16),
                           torch.zeros(1, 4, 2, 16))
    assert fa_ops.flash_attention.launches == before   # the plain version


# ------------------------------------------------------------- K4's plan
BF16 = torch.bfloat16


def _heads(arch: str) -> tuple[int, int, int]:
    cfg = configs.get(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim


def _cache_view_strides(max_len: int, hkv: int, d: int):
    """K's and V's strides as the cached prefill reads them:
    ``ck[:, :cur + s]`` of a (B, max_len, Hkv, D) cache."""
    return (max_len * hkv * d, hkv * d, d)


#: The prefill shapes of the paths, ``(arch, B, Sq, Skv, cache or None)``:
#: T trains on 4 x 4096 without a cache; S, M and H prefill 8 prompts of
#: 512 into a 1024-position cache.
PATHS = {"T": ("minicpm_2b", 4, 4096, 4096, None),
         "S": ("granite_8b", 8, 512, 512, 1024),
         "M": ("olmoe_1b_7b", 8, 512, 512, 1024),
         "H": ("zamba2_7b", 8, 512, 512, 1024)}


def _path_plan(path: str):
    arch, b, sq, skv, cache = PATHS[path]
    hq, hkv, d = _heads(arch)
    qs = fa_kernel.packed_strides(sq, hq, d)
    ks = (fa_kernel.packed_strides(skv, hkv, d) if cache is None
          else _cache_view_strides(cache, hkv, d))
    return fa_kernel.plan(b, sq, skv, hq, hkv, d, BF16, (qs, ks, ks))


@pytest.mark.parametrize("path", list(PATHS))
def test_k4_plan_puts_the_paths_bf16_prefill_on_the_tensor_cores(path):
    arch, b, sq, _, _ = PATHS[path]
    hq = _heads(arch)[0]
    p = _path_plan(path)
    assert p.regime == "tensor_core"
    # One block per (128 query rows, query head, batch row).
    assert p.grid == (hq, b, -(-sq // 128))


@pytest.mark.parametrize("d,kw", [
    (64, {"dtype": torch.float32}),
    (128, {"dtype": torch.float32}),
    (112, {"dtype": torch.float32}),
    (16, {}), (32, {}), (256, {}),          # head dims it has no tiles for
    (112, {"aligned": False}),
    # a head pitch of 116 elements (232 bytes: no multiple of 16)
    (112, {"strides": ((512 * 4 * 116, 4 * 116, 116),) * 3}),
    # a row pitch of 4 x 112 + 4 = 452 elements
    (112, {"strides": ((512 * 452, 452, 112),) * 3}),
])
def test_k4_plan_keeps_float32_and_what_tma_cannot_read_on_the_cuda_cores(
        d, kw):
    kw = dict({"dtype": BF16}, **kw)
    p = fa_kernel.plan(2, 512, 512, 4, 4, d, kw.pop("dtype"), **kw)
    assert p.regime == "cuda_core"
    assert p.grid == (512 // 64, 4, 2)
    assert p.smem_bytes == 4 * (3 * 64 * (d + 1) + 64 * 65)


def test_k4_plan_takes_a_strided_cache_view():
    """Path S's continued prefill reads ``ck[:, :cur + s]`` of a longer
    cache, and a view whose heads lie 8 features apart past D: both keep
    the tensor cores, as the chip check's NaN-poisoned views do."""
    hq, hkv, d = _heads("granite_8b")
    cur, s = 64, 100
    q = fa_kernel.packed_strides(s, hq, d)
    ck = _cache_view_strides(1024, hkv, d)
    assert fa_kernel.plan(8, s, cur + s, hq, hkv, d, BF16,
                          (q, ck, ck)).regime == "tensor_core"
    padded = ((cur + s + 36) * hkv * (d + 8), hkv * (d + 8), d + 8)
    assert fa_kernel.plan(2, s, cur + s, 8, hkv, d, BF16,
                          (q, padded, padded)).regime == "tensor_core"


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k4_plan_fits_shared_memory(d, dtype):
    p = fa_kernel.plan(4, 4096, 4096, 36, 36, d, dtype)
    assert 0 < p.smem_bytes <= fa_kernel.SMEM_LIMIT
    if p.regime == "tensor_core":
        assert d in fa_kernel.TC_HEAD_DIMS and dtype == BF16


def test_k4_k5_cuda_call_with_an_unsupported_dtype_raises():
    """The plans refuse float16, and the wrappers' CUDA branches go
    through them before anything reaches the card (the tensors only claim
    to be on it here)."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel.plan(1, 8, 8, 2, 2, 64, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel_bwd.plan(1, 8, 8, 2, 2, 64, torch.float16)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention_bwd.launches)
    cuda = property(lambda self: torch.device("cuda"))
    with mock.patch.object(torch.Tensor, "device", cuda):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fa_ops.flash_attention(q, q, q)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fa_ops.flash_attention_bwd(q, q, q, q,
                                       torch.zeros(1, 2, 8), q)
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_bwd.launches) == before


#: ``chip_smoke.py``'s ``attn_close`` tolerances: relative, with an
#: absolute term of the tolerance times the plain output's RMS under 1.
ATTN_TOL = {torch.float32: 2e-5, BF16: 2e-2}
K5_TOL = {torch.float32: 1e-4, BF16: 2e-2}


def _attn_close(got, want, tol):
    got, want = got.float(), want.float()
    atol = tol * min(1.0, float(want.square().mean().sqrt()))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d", [80, 96, 192])
def test_head_dim_padding_around_the_plain_versions(d, dtype):
    """The wrappers' zero padding along D (to the next dim both kernels
    take: 112, or 256 for Nemotron-4-340B's 192) with the true 1/sqrt(D),
    run around the plain versions, gives the plain versions' output,
    log-sum-exp and gradients at D."""
    pad = 112 if d < 112 else 256
    assert fa_ops.padded_head_dim(d, fa_kernel.HEAD_DIMS, "K4") == pad
    assert fa_ops.padded_head_dim(d, fa_kernel_bwd.HEAD_DIMS, "K5") == pad
    rng = np.random.default_rng(d)
    q, k, v, do = (_pair(rng, shape, str(dtype)[6:])[1] for shape in (
        (2, 100, 4, d), (2, 164, 2, d), (2, 164, 2, d), (2, 100, 4, d)))
    out, lse = fa_ref.flash_attention_ref(q, k, v, q_offset=64)
    p_out, p_lse = fa_ops.padded_forward(fa_ref.flash_attention_ref, q, k,
                                         v, pad, q_offset=64)
    assert p_out.shape == out.shape and p_out.is_contiguous()
    _attn_close(p_out, out, ATTN_TOL[dtype])
    _attn_close(p_lse, lse, ATTN_TOL[dtype])
    # The scale is the point: padded operands at 1/sqrt(pad) are wrong.
    wrong, _ = fa_ref.flash_attention_ref(
        *(fa_ops.pad_head_dim(t, pad) for t in (q, k, v)), q_offset=64)
    with pytest.raises(AssertionError):
        _attn_close(wrong[..., :d], out, ATTN_TOL[dtype])
    grads = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                           q_offset=64)
    p_grads = fa_ops.padded_backward(fa_ref.flash_attention_bwd_ref, q, k,
                                     v, out, lse, do, pad, q_offset=64)
    for got, want in zip(p_grads, grads):
        assert got.shape == want.shape and got.dtype == want.dtype
        _attn_close(got, want, K5_TOL[dtype])


def test_k4_k5_head_dims_past_the_padding_raise():
    """Past the widest dim a kernel takes (256 for both K4 and K5) the
    wrappers' CUDA branches raise, naming the limit, before anything
    reaches the card (the tensors only claim to be on it here)."""
    assert fa_ops.padded_head_dim(200, fa_kernel.HEAD_DIMS, "K4") == 256
    assert fa_ops.padded_head_dim(8, fa_kernel.HEAD_DIMS, "K4") == 16
    assert fa_ops.padded_head_dim(192, fa_kernel_bwd.HEAD_DIMS, "K5") == 256
    q = torch.zeros(1, 8, 2, 264)
    q5 = torch.zeros(1, 8, 2, 264)
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention_bwd.launches)
    cuda = property(lambda self: torch.device("cuda"))
    with mock.patch.object(torch.Tensor, "device", cuda):
        with pytest.raises(ValueError, match="K4 takes head dims up to 256"):
            fa_ops.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="K5 takes head dims up to 256"):
            fa_ops.flash_attention_bwd(q5, q5, q5, q5,
                                       torch.zeros(1, 2, 8), q5)
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_bwd.launches) == before


def test_flash_attention_sources_use_no_float_atomics():
    """Each output element of K4 and K5 is one thread's sum in a fixed
    order (the dq sum has its own kernel, trap T1): no atomic adds or
    reductions in the package's CUDA sources or the shared header."""
    csrc = Path(fa_kernel.__file__).parent / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    sources.append(Path(fa_kernel.__file__).parents[1] / "include"
                   / "sm90.cuh")
    assert len(sources) >= 6
    for src in sources:
        text = src.read_text()
        assert "atomicAdd" not in text and "red.global" not in text, src
        assert "cp.reduce.async" not in text, src


# ------------------------------------------------------------------ K6
DECODE_CASES = [
    (2, 256, 4, 2, 64, 64),
    (1, 384, 8, 1, 128, 128),    # MQA, long cache
    (3, 100, 4, 4, 32, 64),      # ragged block tail
    (1, 64, 2, 2, 16, 64),       # single block
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,bk", DECODE_CASES)
def test_k6_plain_matches_pallas_and_oracle(b, s, hq, hkv, d, bk, dtype):
    rng = np.random.default_rng(s * 7 + d)
    jq, tq = _pair(rng, (b, hq, d), dtype)
    jk, tk = _pair(rng, (b, s, hkv, d), dtype)
    jv, tv = _pair(rng, (b, s, hkv, d), dtype)
    kv_len = rng.integers(1, s + 1, b).astype(np.int32)
    out = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  block_k=bk)
    assert out.dtype == tq.dtype and out.shape == (b, hq, d)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=bk)
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))
    np.testing.assert_allclose(
        _np(da_ref.decode_attention_ref(tq, tk, tv,
                                        torch.from_numpy(kv_len))),
        _np(oracle), **_tol(dtype))


def test_k6_fully_masked_blocks_do_not_pollute():
    """kv_len 1 and 3 over 8 blocks: every block but the first is fully
    masked, keeps m = -1e30 and l = 0, and the combine ignores it."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 512, 2, 32
    jq, tq = _pair(rng, (b, h, d))
    jk, tk = _pair(rng, (b, s, h, d))
    jv, tv = _pair(rng, (b, s, h, d))
    kv_len = np.array([1, 3], dtype=np.int32)
    out = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  block_k=64)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=64)
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(out), _np(oracle), rtol=2e-5, atol=2e-5)
    o, m, l = da_ref.decode_partials_ref(tq, tk, tv,
                                         torch.from_numpy(kv_len), 64)
    assert (m[:, :, 1:] == da_ref.NEG_INF).all() and (l[:, :, 1:] == 0).all()
    assert (o[:, :, 1:] == 0).all()


def test_k6_wrapper_refuses_a_wrong_kv_len():
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        da_ops.decode_attention(q, k, k, torch.ones(3, dtype=torch.int32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_plain_matches_pallas_at_head_dim_80(dtype):
    """Phi-2's head dim, which the earlier kernel refused: ragged lengths
    over a cache of 3 blocks, GQA, against the Pallas kernel and the
    oracle."""
    rng = np.random.default_rng(80)
    b, s, hq, hkv, d = 3, 192, 4, 2, 80
    jq, tq = _pair(rng, (b, hq, d), dtype)
    jk, tk = _pair(rng, (b, s, hkv, d), dtype)
    jv, tv = _pair(rng, (b, s, hkv, d), dtype)
    kv_len = np.array([2, 150, 192], np.int32)
    out = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  block_k=64)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=64)
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))


# ------------------------------------------------------------- K6's plan
#: The decode shapes of the paths: ``(arch, B, cache)``, 8 rows over a
#: 1024-position cache.
DECODE_PATHS = {"S": ("granite_8b", 8, 1024), "M": ("olmoe_1b_7b", 8, 1024),
                "H": ("zamba2_7b", 8, 1024)}


@pytest.mark.parametrize("path,split,lanes,rows", [
    ("S", 64, 16, 4), ("M", 128, 16, 1), ("H", 256, 16, 1)])
def test_k6_plan_at_the_paths_decode_shapes(path, split, lanes, rows):
    """The split fills the card from the cache's capacity: four blocks an
    SM at least, so the live blocks of path S's lengths (513-543) still
    give every SM two or more; one row group a KV head (G of 4 or 1)."""
    arch, b, cache = DECODE_PATHS[path]
    hq, hkv, d = _heads(arch)
    ks = _cache_view_strides(cache, hkv, d)[:2]
    p = da_kernel.plan(b, cache, hq, hkv, d, BF16, (ks, ks), True, 132)
    assert (p.split, p.lanes, p.rows) == (split, lanes, rows)
    assert p.grid == (-(-cache // split), hkv, b)
    # one row group a KV head, one output a thread
    assert p.combine_grid == (hkv, b, -(-rows * d // 128))
    assert p.grid[0] * p.grid[1] * p.grid[2] >= 4 * 132
    live = -(-543 // split) * hkv * b
    assert live >= 2 * 132
    assert p.vector_loads
    assert p.smem_bytes == 2 * 2 * 32 * d * 2 <= da_kernel.SMEM_LIMIT
    assert da_kernel.workspace_floats(b, hkv, hq // hkv, d, p) == \
        b * hkv * p.grid[0] * (hq // hkv) * (d + 2)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_k6_plan_takes_any_head_dim_that_is_a_multiple_of_8(d, dtype):
    p = da_kernel.plan(2, 300, 8, 2, d, dtype)
    assert p.lanes * 8 >= d and p.lanes in (4, 8, 16, 32)
    assert 0 < p.smem_bytes <= da_kernel.SMEM_LIMIT
    assert p.split % 32 == 0 and p.grid[0] * p.split >= 300


def test_k6_plan_keeps_the_combine_within_512_splits():
    p = da_kernel.plan(1, 1 << 20, 4, 1, 64, BF16)
    assert p.split % 32 == 0 and p.splits <= 512
    assert p.splits * p.split >= 1 << 20


@pytest.mark.parametrize("d", [260, 100, 4, 0])
def test_k6_refuses_head_dims_it_does_not_take(d):
    """The plan and the wrapper's CUDA branch say what K6 takes, before
    anything reaches the card (the tensors only claim to be on it)."""
    rule = "multiple of 8 up to 256"
    with pytest.raises(ValueError, match=rule):
        da_kernel.plan(2, 64, 4, 2, d, BF16)
    q, k = torch.zeros(2, 4, d, dtype=BF16), torch.zeros(2, 64, 2, d,
                                                          dtype=BF16)
    before = da_ops.decode_attention.launches
    cuda = property(lambda self: torch.device("cuda"))
    with mock.patch.object(torch.Tensor, "device", cuda):
        with pytest.raises(ValueError, match=rule):
            da_ops.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            da_ops.decode_attention(q.half(), k.half(), k.half(),
                                    torch.ones(2, dtype=torch.int32))
    assert da_ops.decode_attention.launches == before


@pytest.mark.parametrize("dtype,strides,aligned,vector", [
    (BF16, ((1024 * 8 * 128, 8 * 128),) * 2, True, True),
    (BF16, ((1024 * 8 * 128, 8 * 128),) * 2, False, False),
    # a position pitch of 8 x 128 + 4 elements (8 bytes past 16)
    (BF16, ((1024 * 1028, 1028),) * 2, True, False),
    (torch.float32, ((1024 * 1028, 1028),) * 2, True, True),
    (torch.float32, ((1024 * 1026, 1026),) * 2, True, False),
])
def test_k6_plan_copies_with_16_byte_loads_only_where_aligned(
        dtype, strides, aligned, vector):
    p = da_kernel.plan(8, 1024, 32, 8, 128, dtype, strides, aligned)
    assert p.vector_loads is vector


#: Atomic adds and reductions in a CUDA source (``cp.async...shared.global``
#: is a copy, not a ``red.global``).
FLOAT_ATOMICS = re.compile(
    r"\batomicAdd|\bred\.(global|shared)|cp\.reduce\.async")


def test_decode_attention_sources_use_no_float_atomics():
    """Each partial and each output is one block's sums in a fixed order
    (the combine reads the splits in order): no atomic adds or reductions
    in K6's CUDA source."""
    sources = sorted((Path(da_kernel.__file__).parent / "csrc").glob("*.cu"))
    assert sources
    for src in sources:
        assert not FLOAT_ATOMICS.search(src.read_text()), src


# --------------------------------------------------------------- layers
def _cfg(**kw):
    return dataclasses.replace(configs.get_smoke("granite_8b"), **kw)


def _ref_cfg(**kw):
    return dataclasses.replace(ref_configs.get_smoke("granite_8b"), **kw)


def _weights(rng, specs, scale_of=lambda shape: 1.0 / np.sqrt(shape[0])):
    ref, port = {}, {}
    for name, (shape, _) in specs.items():
        ref[name], port[name] = _pair(rng, shape, scale=scale_of(shape))
    return ref, port


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (3, 5, 64), scale=3.0)
    js, ts = _pair(rng, (64,))
    np.testing.assert_allclose(_np(layers.rms_norm(tx, ts, 1e-5)),
                               _np(ref_layers.rms_norm(jx, js, 1e-5)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_apply_rope_matches_reference(positions):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 6, 4, 16))
    pos = (np.arange(6)[None, :] if positions == "prefill"
           else np.array([[300], [7]]) + np.zeros((1, 6), np.int64))
    np.testing.assert_allclose(
        _np(layers.apply_rope(tx, torch.from_numpy(pos), 1e4)),
        _np(ref_layers.apply_rope(jx, jnp.asarray(pos, jnp.int32), 1e4)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(activation):
    cfg, rcfg = _cfg(activation=activation), _ref_cfg(activation=activation)
    rng = np.random.default_rng(2)
    jw, tw = _weights(rng, ref_layers.mlp_param_specs(rcfg))
    assert set(layers.mlp_param_specs(cfg)) == set(jw)
    jx, tx = _pair(rng, (2, 5, cfg.d_model))
    np.testing.assert_allclose(_np(layers.mlp(tw, tx, cfg)),
                               _np(ref_layers.mlp(jw, jx, rcfg)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt", [8, 24])
def test_attention_with_a_cache_matches_reference(prompt):
    """A prefill of ``prompt`` tokens (8 takes the reference's one-block
    branch, 24 its scan over blocks), then three decode steps: outputs and
    cache contents within 1e-5."""
    cfg, rcfg = _cfg(), _ref_cfg()
    rng = np.random.default_rng(prompt)
    jw, tw = _weights(rng, ref_layers.attention_param_specs(rcfg))
    b, max_len = 2, 40
    shape = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "cursor": jnp.int32(0)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape), "cursor": 0}
    jx, tx = _pair(rng, (b, prompt, cfg.d_model))
    jo, jcache = ref_layers.attention(jw, jx, rcfg, kv_cache=jcache)
    to, tcache = layers.attention(tw, tx, cfg, kv_cache=tcache)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-5, atol=1e-5)
    for step in range(3):
        pos = np.full((b, 1), prompt + step)
        jx, tx = _pair(rng, (b, 1, cfg.d_model))
        jo, jcache = ref_layers.attention(
            jw, jx, rcfg, positions=jnp.asarray(pos, jnp.int32),
            kv_cache=jcache)
        to, tcache = layers.attention(tw, tx, cfg,
                                      positions=torch.from_numpy(pos),
                                      kv_cache=tcache)
        np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-5, atol=1e-5)
    assert tcache["cursor"] == int(jcache["cursor"]) == prompt + 3
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,kv_len", [(4, None), (20, None), (20, 30)])
def test_flash_attention_xla_twin_matches_reference(sq, kv_len):
    rng = np.random.default_rng(sq)
    jq, tq = _pair(rng, (2, sq, 4, 16))
    jk, tk = _pair(rng, (2, 48, 2, 16))
    jv, tv = _pair(rng, (2, 48, 2, 16))
    kw = dict(causal=True, q_offset=10, kv_len=kv_len, block_k=16)
    np.testing.assert_allclose(
        _np(layers.flash_attention_xla(tq, tk, tv, **kw)),
        _np(ref_layers.flash_attention_xla(jq, jk, jv, **kw)),
        rtol=1e-5, atol=1e-5)


def test_unported_layers_raise_naming_their_roadmap_item():
    cfg = _cfg()
    x = torch.zeros(1, 2, cfg.d_model)
    # Cross attention is ported now (the encdec family, ROADMAP item 9:
    # tests/test_torch_encdec.py).  The streamed cross-entropy is ported now (training, ROADMAP item
    # 10): on zero logits every token's loss is log(V).
    loss, w_sum = layers.streamed_xent(x, torch.zeros(cfg.d_model, 4),
                                       torch.zeros(1, 2, dtype=torch.long),
                                       torch.ones(1, 2))
    assert float(w_sum) == 2.0
    assert abs(float(loss) - 2 * np.log(4.0)) < 1e-6


def test_bfloat16_inputs_agree_bit_for_bit():
    """The rounding helper hands both packages the same bfloat16 values."""
    rng = np.random.default_rng(9)
    j, t = _pair(rng, (64,), "bfloat16")
    assert np.array_equal(np.asarray(j).view(np.int16),
                          t.view(torch.int16).numpy())
    assert np.asarray(j).dtype == ml_dtypes.bfloat16
