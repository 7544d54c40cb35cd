"""Kernel K7 and the port's MoE layer and models against the JAX reference.

On the CPU the port's wrapper runs K7's plain PyTorch version; these tests
hold it against the reference's Pallas kernel (in interpret mode, as
``tests/test_kernels.py`` runs it) and its oracle, and hold
``repro_torch.models.moe`` and the ``moe`` family of
``repro_torch.models.transformer`` against the reference's at the smoke
size (OLMoE-1B-7B's and DeepSeekMoE-16B's smoke configs), with the
reference's parameters carried across by ``convert.from_reference_params``.
Inputs are drawn with NumPy from a seed and handed to both packages.
Tolerances: K7 1e-5 in float32 and 2e-2 in bfloat16 (the reference's own
bfloat16 bar); the MoE layer, the hidden states and the aux loss 1e-5 in
float32; routing (top-k ids, their ties and the capacity drops) and greedy
tokens exactly.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import dataclasses
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.moe_gmm import grouped_matmul as pallas_gmm
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jax_gmm_ref
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.runtime import serve_loop as ref_loop
from repro_torch import configs
from repro_torch.convert import from_reference_params
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.runtime import serve_loop

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32 = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("olmoe_1b_7b", "deepseek_moe_16b")


def _pair(rng, shape, dtype="float32", scale=1.0):
    """The same values for both packages, rounded to bfloat16 identically
    on both sides when asked."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _port_params(rparams, cfg):
    return from_reference_params(jax.tree_util.tree_map(np.asarray, rparams),
                                 cfg, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = ref_configs.get_smoke(request.param)
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = configs.get_smoke(request.param)
    return rcfg, rparams, cfg, _port_params(rparams, cfg)


# ------------------------------------------------------------------ K7
GMM_SHAPES = [(4, 64, 128, 96), (8, 100, 60, 70), (2, 16, 512, 256),
              (1, 8, 8, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_k7_plain_matches_pallas_and_oracle(e, c, d, f, dtype):
    """``tests/test_kernels.py``'s four shapes, the Pallas kernel at its
    small blocks (ragged C, D and F against them).  The weights have the
    model's scale, 1/sqrt(D), so the products are of order 1 as in the MoE
    layer and 1e-5 is a bar on float32 rounding, not on the values' size."""
    rng = np.random.default_rng(e * 1000 + c + d + f)
    jx, tx = _pair(rng, (e, c, d), dtype)
    jw, tw = _pair(rng, (e, d, f), dtype, scale=d ** -0.5)
    out = gmm_ops.grouped_matmul(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (e, c, f)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    pallas = pallas_gmm(jx, jw, block_c=32, block_d=64, block_f=32)
    np.testing.assert_allclose(_np(out), _np(pallas), **tol)
    np.testing.assert_allclose(_np(out), _np(jax_gmm_ref(jx, jw)), **tol)


def test_k7_wrapper_checks_and_dispatch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    before = gmm_ops.grouped_matmul.launches
    assert torch.equal(gmm_ops.grouped_matmul(x, w),
                       gmm_ref.grouped_matmul_ref(x, w))
    assert gmm_ops.grouped_matmul.launches == before   # no kernel on a CPU
    with pytest.raises(ValueError, match="experts or contraction"):
        gmm_ops.grouped_matmul(x, w[:, :6])
    with pytest.raises(ValueError, match="expected"):
        gmm_ops.grouped_matmul(x[0], w)
    with pytest.raises(TypeError, match="dtype"):
        gmm_ops.grouped_matmul(x, w.double())
    # D = 0: zeros, as the empty sum is.
    empty = gmm_ops.grouped_matmul(x[:, :, :0], w[:, :0])
    assert torch.equal(empty, torch.zeros(3, 5, 4))


# ------------------------------------------------------------- K7's plan
BF16 = torch.bfloat16
#: Path M's products at OLMoE-1B-7B's widths: the prefill's gate and up
#: products, its down product, and a decode step's gate and up products.
PATH_M = {"prefill": (64, 640, 2048, 1024), "down": (64, 640, 1024, 2048),
          "decode": (64, 8, 2048, 1024)}


@pytest.mark.parametrize("case,regime,n", [("prefill", "wide", 0),
                                           ("down", "wide", 0),
                                           ("decode", "narrow", 8)])
def test_k7_plan_puts_path_m_on_the_tensor_cores(case, regime, n):
    e, c, d, f = PATH_M[case]
    p = gmm_kernel.plan(e, c, d, f, BF16)
    assert (p.regime, p.n) == (regime, n)
    if regime == "wide":     # one persistent block an SM (132 on an H100)
        assert p.grid == (132, 1, 1)
        assert gmm_kernel.plan(e, c, d, f, BF16, sms=7000).grid == (
            5 * (f // 256) * 64, 1, 1)     # a tile each: 1,280 or 2,560
    else:                    # 64 columns of F a block: 1,024 blocks
        assert p.grid == (16, 64, 1)


@pytest.mark.parametrize("c,regime,n", [(1, "narrow", 8), (8, "narrow", 8),
                                        (9, "narrow", 16), (32, "narrow", 32),
                                        (33, "narrow", 64), (64, "narrow", 64),
                                        (65, "wide", 0), (72, "wide", 0)])
def test_k7_plan_regime_boundary(c, regime, n):
    p = gmm_kernel.plan(4, c, 2048, 1024, BF16)
    assert (p.regime, p.n) == (regime, n)


@pytest.mark.parametrize("shape,kw", [
    (PATH_M["prefill"], {"dtype": torch.float32}),
    (PATH_M["decode"], {"dtype": torch.float32}),
    ((64, 650, 2048, 1408), {"dtype": torch.float32}),
    ((4, 33, 1001, 77), {}),              # x's and w's row pitches
    ((4, 33, 1024, 77), {}),              # w's and out's row pitch
    ((4, 33, 1001, 1024), {}),            # x's row pitch
    ((4, 8, 2048, 1024), {"aligned": False}),
    ((4, 640, 2048, 1024), {"strides": ((640 * 2052, 2052, 1),
                                        (2048 * 1024, 1024, 1))}),
    ((4, 8, 0, 1024), {}),                # nothing to contract
])
def test_k7_plan_keeps_float32_and_bad_pitches_on_the_cuda_cores(shape, kw):
    kw = dict({"dtype": BF16}, **kw)
    p = gmm_kernel.plan(*shape, kw.pop("dtype"), **kw)
    e, c, d, f = shape
    assert p.regime == "cuda_core" and p.smem_bytes == 0
    assert p.grid == (-(-f // 64), -(-c // 64), e)


def test_k7_plan_takes_a_strided_view_whose_pitches_tma_reads():
    """A view into a larger allocation (rows past C and columns past D
    beyond it) stays on the tensor cores when its pitches are 16 bytes."""
    strides = ((648 * 2112, 2112, 1), (2048 * 1024, 1024, 1))
    assert gmm_kernel.plan(64, 640, 2048, 1024, BF16,
                           strides).regime == "wide"
    assert gmm_kernel.plan(64, 8, 2048, 1024, BF16,
                           ((16 * 2112, 2112, 1), (2048 * 1024, 1024, 1))
                           ).regime == "narrow"


@pytest.mark.parametrize("c", [1, 8, 16, 17, 32, 64, 65, 640, 4096])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k7_plan_fits_shared_memory_and_covers_the_output(c, dtype):
    e, d, f = 8, 2048, 1408
    p = gmm_kernel.plan(e, c, d, f, dtype)
    assert 0 <= p.smem_bytes <= gmm_kernel.SMEM_LIMIT
    if p.regime == "narrow":
        assert p.n >= c and p.grid[0] * 64 >= f and p.grid[1] == e
        # Two blocks an SM at the least, with 40 KB of weights in flight.
        assert 2 * p.smem_bytes <= gmm_kernel.SMEM_LIMIT
    elif p.regime == "wide":     # persistent: a block an SM, tiles left over
        tiles = -(-c // 128) * -(-f // 256) * e
        assert p.grid == (min(tiles, 132), 1, 1)
    else:
        assert p.grid[0] * 64 >= f and p.grid[1] * 64 >= c


def test_k7_cuda_call_with_an_unsupported_dtype_raises():
    """The plan refuses float16, and the wrapper's CUDA branch goes through
    it before anything reaches the card (the tensors only claim to be on
    it here)."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm_kernel.plan(4, 8, 64, 64, torch.float16)
    x = torch.zeros(2, 8, 16, dtype=torch.float16)
    w = torch.zeros(2, 16, 8, dtype=torch.float16)
    before = gmm_ops.grouped_matmul.launches
    cuda = property(lambda self: torch.device("cuda"))
    with mock.patch.object(torch.Tensor, "device", cuda):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            gmm_ops.grouped_matmul(x, w)
    assert gmm_ops.grouped_matmul.launches == before


def test_k7_sources_use_no_float_atomics():
    """Each output element is one thread's sum in a fixed order (a launch
    gives the same bits every time): no atomic adds in K7's sources."""
    csrc = Path(gmm_kernel.__file__).parent / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert len(sources) >= 2
    for src in sources:
        text = src.read_text()
        assert "atomicAdd" not in text and "red.global" not in text, src
        assert "cp.reduce.async" not in text, src


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0])
def test_expert_capacity_matches_reference(arch, factor):
    for cfg_of in (configs.get, configs.get_smoke):
        cfg = dataclasses.replace(cfg_of(arch), moe_capacity_factor=factor)
        rcfg = dataclasses.replace(
            (ref_configs.get if cfg_of is configs.get
             else ref_configs.get_smoke)(arch), moe_capacity_factor=factor)
        for t in list(range(0, 300)) + [4096, 4097, 8192, 32768]:
            assert moe.expert_capacity(t, cfg) == \
                ref_moe.expert_capacity(t, rcfg), (t, factor)
    olmoe = configs.get("olmoe_1b_7b")
    assert moe.expert_capacity(8 * 512, olmoe) == 640     # path M prefill
    assert moe.expert_capacity(8, olmoe) == 8             # a decode step


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (40, cfg.d_model))
    jr, tr = _pair(rng, (cfg.d_model, cfg.n_experts), scale=0.3)
    gates, ids, aux = moe._route({"router": tr}, tx, cfg)
    rg, rids, raux = ref_moe._route({"router": jr}, jx, cfg)
    assert np.array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)
    assert gates.dtype == aux.dtype == torch.float32


def test_route_ties_select_what_lax_top_k_selects():
    """One-hot tokens read router rows with equal logits at and around the
    k-th place (and everywhere): the lower expert index wins each tie, as
    ``jax.lax.top_k`` picks it."""
    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"), n_experts=8,
                              moe_top_k=3, d_model=6)
    router = np.array([
        [3, 1, 2, 2, 2, 0, 1, 2],      # k-th and (k+1)-th tie (three ways)
        [1, 1, 1, 1, 1, 1, 1, 1],      # all equal
        [0, 5, 0, 5, 0, 5, 0, 5],      # ties inside the top k
        [2, 2, 4, 0, 0, 0, 0, 2],      # second place ties three ways
        [-1, 0, 0, 0, 0, 0, 0, -1],
        [9, 8, 7, 7, 8, 9, 7, 7],
    ], np.float32)
    x = np.eye(6, dtype=np.float32)
    gates, ids, aux = moe._route({"router": torch.from_numpy(router)},
                                 torch.from_numpy(x), cfg)
    rg, rids, raux = ref_moe._route({"router": jnp.asarray(router)},
                                    jnp.asarray(x), cfg)
    assert np.array_equal(ids.numpy(), np.asarray(rids))
    assert ids[0].tolist() == [0, 2, 3] and ids[1].tolist() == [0, 1, 2]
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_moe_ffn_matches_reference(arch, factor):
    """Capacity factor 0.5 drops pairs (asserted); DeepSeek's smoke config
    adds the shared expert."""
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              moe_capacity_factor=factor)
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                               moe_capacity_factor=factor)
    rng = np.random.default_rng(int(factor * 8))
    params, rparams = {}, {}
    for name, (shape, _) in moe.moe_param_specs(cfg).items():
        rparams[name], params[name] = _pair(rng, shape,
                                            scale=shape[-2] ** -0.5)
    assert ("shared_w_gate" in params) == (arch == "deepseek_moe_16b")
    jx, tx = _pair(rng, (3, 16, cfg.d_model))
    out, aux = moe.moe_ffn(params, tx, cfg)
    rout, raux = ref_moe._moe_ffn_dense(rparams, jx, rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)
    # Drops: more (token, k) pairs went to some expert than it holds.
    _, ids, _ = moe._route(params, tx.reshape(-1, cfg.d_model), cfg)
    most = int(torch.bincount(ids.reshape(-1)).max())
    if factor == 0.5:
        assert most > moe.expert_capacity(48, cfg)


def test_moe_ffn_in_bfloat16_matches_reference():
    """Routing identical; the output within 2e-2 relative L2, since the two
    frameworks round to bfloat16 at other places (SiLU, the shared
    expert's sum): about one bfloat16 ulp of RMS, a few ulps at worst."""
    cfg = dataclasses.replace(configs.get_smoke("deepseek_moe_16b"),
                              param_dtype="bfloat16")
    rng = np.random.default_rng(9)
    params, rparams = {}, {}
    for name, (shape, _) in moe.moe_param_specs(cfg).items():
        rparams[name], params[name] = _pair(rng, shape, "bfloat16",
                                            scale=shape[-2] ** -0.5)
    jx, tx = _pair(rng, (2, 8, cfg.d_model), "bfloat16")
    _, ids, _ = moe._route(params, tx.reshape(-1, cfg.d_model), cfg)
    _, rids, _ = ref_moe._route(rparams, jx.reshape(-1, cfg.d_model), cfg)
    assert np.array_equal(ids.numpy(), np.asarray(rids))
    out, _ = moe.moe_ffn(params, tx, cfg)
    rout, _ = ref_moe._moe_ffn_dense(rparams, jx, cfg)
    assert out.dtype == torch.bfloat16
    got, want = _np(out), _np(rout)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


# ------------------------------------------------------------ the model
def test_convert_carries_the_moe_leaves_bit_for_bit(smoke):
    rcfg, rparams, cfg, params = smoke
    names = {"router", "w_gate", "w_up", "w_down"}
    if cfg.n_shared_experts:
        names |= {"shared_w_gate", "shared_w_up", "shared_w_down"}
    assert names <= set(params["blocks"])
    for name in names:
        want = np.asarray(rparams["blocks"][name])
        assert params["blocks"][name].shape == want.shape
        assert np.array_equal(params["blocks"][name].numpy(), want)
    assert params["blocks"]["w_gate"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    # bfloat16 through the int16 view.
    bcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    brcfg = dataclasses.replace(rcfg, param_dtype="bfloat16")
    bparams = ref_tfm.init_params(jax.random.PRNGKey(3), brcfg)
    got = _port_params(bparams, bcfg)["blocks"]["w_down"]
    want = np.asarray(bparams["blocks"]["w_down"])
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))


def test_init_params_draws_experts_with_fan_in_d():
    cfg = configs.get_smoke("olmoe_1b_7b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = params["blocks"]["w_gate"]
    assert w.shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2.0 * std
    assert abs(float(w.std()) / std - 0.88) < 0.05    # truncated at 2 sd
    down = params["blocks"]["w_down"]
    assert float(down.abs().max()) <= 2.0 / np.sqrt(cfg.d_ff)
    assert sum(p.numel() for grp in params.values()
               for p in grp.values()) == sum(
        int(np.prod(shape)) for _, shape in tfm._leaves(tfm.param_specs(cfg)))


def test_decoder_forward_matches_reference(smoke):
    rcfg, rparams, cfg, params = smoke
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    ref = ref_tfm.decoder_forward(rparams, jnp.asarray(tokens), rcfg)
    res = tfm.decoder_forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(res.hidden.numpy(), np.asarray(ref.hidden),
                               **F32)
    assert float(res.aux_loss) > 0
    np.testing.assert_allclose(float(res.aux_loss), float(ref.aux_loss),
                               **F32)
    module = tfm.DecoderLM(cfg, params)
    assert torch.equal(module(torch.from_numpy(tokens)).hidden, res.hidden)


@pytest.mark.parametrize("prompt_len", [8, 24])
def test_greedy_generate_matches_reference(smoke, prompt_len):
    """Prefill drops pairs past the capacity and decode steps do not, in
    both packages alike."""
    rcfg, rparams, cfg, params = smoke
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len))
    ref_tokens = np.asarray(ref_loop.greedy_generate(
        rcfg, rparams, jnp.asarray(prompt), steps=6, max_len=48))
    tokens = serve_loop.greedy_generate(cfg, params, prompt, 6, 48,
                                        device="cpu")
    assert np.array_equal(tokens.numpy(), ref_tokens)
