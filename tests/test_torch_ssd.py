"""Kernel K8, the SSD scan and the port's SSM and hybrid models against the
JAX reference.

On the CPU the port's wrapper runs K8's plain PyTorch version; these tests
hold it against the reference's Pallas kernel (in interpret mode, as
``tests/test_kernels.py`` runs it), hold the port's chunked scan against
the reference's scan and its sequential oracle, hold ``repro_torch.models.
ssd`` against ``repro.models.ssd`` on the same weights, and hold the
``ssm`` and ``hybrid`` families of ``repro_torch.models.transformer``
(Mamba2-2.7B's and Zamba2-7B's smoke configs, the reference's parameters
carried across by ``convert.from_reference_params``) against the
reference's forward and greedy decoding.  Inputs are drawn with NumPy
from a seed and handed to both packages.  Tolerances: K8's plain version
1e-5 against the Pallas kernel (both sum in float32; the cumulative sums
and products run in other orders); the scans 1e-4 against each other and
the oracle (the reference's own bar, ``tests/test_kernels.py``); the
model pieces, hidden states and logits 1e-5 in float32; greedy tokens
exactly.  Zamba2's attention head dim is 112, so K4's and K6's plain
versions are held at D 112 too.  The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan.kernel import ssd_chunk_kernel
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import ssd as ref_ssd
from repro.models import transformer as ref_tfm
from repro.runtime import serve_loop as ref_loop
from repro_torch import configs
from repro_torch.convert import from_reference_params
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import serve
from repro_torch.models import ssd
from repro_torch.models import transformer as tfm
from repro_torch.runtime import serve_loop

F32 = dict(rtol=1e-5, atol=1e-5)
SCAN = dict(rtol=1e-4, atol=1e-4)
#: (arch, config overrides): the two smoke models, and a hybrid of 7
#: layers with a site every 2, so one layer runs after the last site.
MODELS = {"mamba2": ("mamba2_2p7b", {}), "zamba2": ("zamba2_7b", {}),
          "zamba2_rem": ("zamba2_7b", dict(n_layers=7))}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _pair(x: np.ndarray, dtype=jnp.float32):
    """The same float32 values for both packages (bfloat16 rounded the same
    way on both sides when asked)."""
    j = jnp.asarray(x, dtype=dtype)
    t = torch.from_numpy(np.asarray(x, np.float32))
    return j, t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


def _ssd_inputs(b, l, h, p, n, seed, with_state=False):
    """x, dt (post-softplus), a_log, B, C (and an initial state), as the
    reference's kernel tests draw them, from NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, l, h, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, h, n)) * 0.3).astype(np.float32)
    out = [x, dt, a_log, bm, cm]
    if with_state:
        out.append((rng.standard_normal((b, h, p, n)) * 0.2)
                   .astype(np.float32))
    return out


# ------------------------------------------------------------------ K8
#: ``tests/test_kernels.py``'s shapes with L % chunk == 0, then head
#: counts that are no multiple of the Pallas kernel's head block of 4.
K8_SHAPES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 32, 16, 32),
             (2, 48, 2, 8, 8, 16), (1, 48, 6, 16, 16, 16),
             (2, 32, 5, 8, 24, 32)]


@pytest.mark.parametrize("b,l,h,p,n,chunk", K8_SHAPES)
def test_k8_plain_matches_pallas(b, l, h, p, n, chunk):
    x, dt, a_log, bm, cm = _ssd_inputs(b, l, h, p, n, seed=l * 7 + h + n)
    ld = (dt * -np.exp(a_log)).astype(np.float32)
    got = ssd_ops._intra_chunk(*(torch.from_numpy(t) for t in
                                 (x, ld, dt, bm, cm)), chunk)
    want = ssd_chunk_kernel(*(jnp.asarray(t) for t in (x, ld, dt, bm, cm)),
                            chunk=chunk, interpret=True)
    nc = l // chunk
    for name, g, w, shape in zip(("y_intra", "contrib", "total"), got, want,
                                 ((b, l, h, p), (b, nc, h, p, n),
                                  (b, nc, h))):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=name, **F32)


def test_k8_wrapper_checks_and_dispatch():
    x, dt, a_log, bm, cm = (torch.from_numpy(t) for t in
                            _ssd_inputs(1, 32, 2, 8, 8, seed=1))
    ld = dt * -torch.exp(a_log)
    before = ssd_ops.ssd_scan.launches
    got = ssd_ops._intra_chunk(x, ld, dt, bm, cm, 16)
    want = ssd_ref.ssd_chunk_ref(x, ld, dt, bm, cm, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ssd_ops.ssd_scan(x, dt, a_log, bm, cm, chunk=16)
    assert ssd_ops.ssd_scan.launches == before   # no kernel on a CPU
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops._intra_chunk(x, ld, dt, bm, cm, 12)
    with pytest.raises(ValueError, match="expected x"):
        ssd_ops._intra_chunk(x[0], ld, dt, bm, cm, 16)
    with pytest.raises(ValueError, match="dt"):
        ssd_ops._intra_chunk(x, ld, dt[:, :16], bm, cm, 16)
    with pytest.raises(ValueError, match="does not match"):
        ssd_ops._intra_chunk(x, ld, dt, bm[:, :, :1], cm[:, :, :1], 16)


def test_k8_reads_b_and_c_shared_across_heads():
    """B and C as (B, L, 1, N) rows expanded over the heads (a head stride
    of 0, as the model hands them over) give what packed copies give."""
    rng = np.random.default_rng(2)
    x, dt, a_log, _, _ = (torch.from_numpy(t) for t in
                          _ssd_inputs(2, 32, 4, 8, 8, seed=2))
    rows = torch.from_numpy(rng.standard_normal((2, 2, 32, 1, 8))
                            .astype(np.float32))
    bm, cm = (r.expand(2, 32, 4, 8) for r in rows)
    assert bm.stride(2) == 0
    view = ssd_ops.ssd_scan(x, dt, a_log, bm, cm, chunk=16)
    packed = ssd_ops.ssd_scan(x, dt, a_log, bm.contiguous(),
                              cm.contiguous(), chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(view, packed))


def test_k8_decay_never_overflows_over_a_long_chunk():
    """A at -16 and dt about 5 take cum to about -2e4 within a chunk of
    256: the weights stay finite because the decay is exp(cum_t - cum_s)
    for s <= t only."""
    x, dt, _, bm, cm = _ssd_inputs(1, 256, 2, 8, 8, seed=3)
    a_log = np.full(2, np.log(16.0), np.float32)
    dt = dt + 4.0
    y, state = ssd_ops.ssd_scan(*(torch.from_numpy(t) for t in
                                  (x, dt, a_log, bm, cm)), chunk=256)
    ld = torch.from_numpy(dt * -16.0).reshape(1, 1, 256, 2)
    assert float(torch.cumsum(ld, 2).min()) < -1e4
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    yr, sr = ssd_ref.ssd_ref(*(torch.from_numpy(t) for t in
                               (x, dt, a_log, bm, cm)))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **SCAN)
    np.testing.assert_allclose(state.numpy(), sr.numpy(), **SCAN)


# ------------------------------------------------------------- K8's plan
BF16 = torch.bfloat16
#: K8's tolerance, relative to the values' scale (``chip_smoke.py``'s
#: ``K8_TOL`` and ``attn_close``).
K8_TOL = 1e-4


def _shared_strides(l, n):
    """B's or C's (batch, position, head) strides as the models pass them:
    one (B, L, N) row expanded over the heads."""
    return (l * n, n, 0)


@pytest.mark.parametrize("arch,slices", [("mamba2_2p7b", (8, 4)),
                                         ("zamba2_7b", (8, 4))])
def test_k8_plan_puts_the_paths_bf16_prefill_on_the_tensor_cores(arch,
                                                                 slices):
    """Paths P's and H's prefill call (8 x 512 tokens, chunk 256): C_t.B_s
    formed once for a slice of 8 heads (one block per 64 query rows), the
    state kernel's slices of 4, so that each kernel gives every SM two
    blocks or more."""
    cfg = configs.get(arch)
    b, l, h, p, n, q = 8, 512, cfg.n_ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state, cfg.ssm_chunk
    st = _shared_strides(l, n)
    plan = ssd_kernel.plan(b, l, h, p, n, q, BF16, (st, st), True, 132)
    assert plan.regime == "tensor_core"
    assert (plan.intra_slice, plan.state_slice) == slices
    assert plan.intra_grid == (q // 64, -(-h // 8), b * l // q)
    assert plan.state_grid == (-(-h // 4), b * l // q, 1)
    for grid in (plan.intra_grid, plan.state_grid):
        assert grid[0] * grid[1] * grid[2] >= 2 * 132
    assert 0 < plan.intra_smem <= ssd_kernel.SMEM_LIMIT
    assert 0 < plan.state_smem <= ssd_kernel.SMEM_LIMIT


def test_k8_plan_gives_packed_b_and_c_a_head_a_block():
    """Packed copies (a head stride of N) stay on the tensor cores, one
    head a block: the same products on the same tiles as the shared row,
    so the same bits."""
    l, n = 512, 128
    packed = (l * 80 * n, 80 * n, n)
    plan = ssd_kernel.plan(8, l, 80, 64, n, 256, BF16, (packed, packed))
    assert plan.regime == "tensor_core"
    assert (plan.intra_slice, plan.state_slice) == (1, 1)
    assert plan.intra_grid == (4, 80, 16) and plan.state_grid == (80, 16, 1)


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float32),
    dict(p=40),                              # P no multiple of 16
    dict(p=144),                             # P past 128
    dict(n=72),                              # N no multiple of 16
    dict(q=512),                             # four key tiles at most
    dict(q=96, l=480),                       # Q no multiple of 64
    dict(aligned=False),
    # a position pitch of 68 elements (136 bytes: no multiple of 16)
    dict(strides=((512 * 68, 68, 0), (512 * 68, 68, 0))),
])
def test_k8_plan_keeps_float32_and_what_tma_cannot_read_on_the_cuda_cores(
        kw):
    a = dict(dict(p=64, n=64, q=256, l=512, dtype=BF16, aligned=True,
                  strides=None), **kw)
    strides = a["strides"] or (_shared_strides(a["l"], a["n"]),) * 2
    plan = ssd_kernel.plan(8, a["l"], 112, a["p"], a["n"], a["q"],
                           a["dtype"], strides, a["aligned"])
    assert plan.regime == "cuda_core"
    assert (plan.intra_slice, plan.state_slice) == (1, 1)
    assert plan.intra_grid == (-(-a["q"] // 64), 112, 8 * a["l"] // a["q"])


def test_k8_plan_refuses_float16():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_kernel.plan(1, 64, 2, 16, 16, 64, torch.float16)


def _to_scale(got, want, tol=K8_TOL):
    """``chip_smoke.py``'s ``attn_close``: rtol ``tol`` and atol ``tol``
    times the RMS of ``want`` where that is under 1."""
    got, want = got.float(), want.float()
    atol = tol * min(1.0, float(want.square().mean().sqrt()))
    return bool(torch.allclose(got, want, rtol=tol, atol=atol))


def test_k8_tensor_core_arithmetic_keeps_the_tolerance():
    """The tensor-core regime's arithmetic (y in the plain version's
    order; the state product's scaled x split into three bf16 parts, each
    part's product with B summed in float32) against the Pallas kernel in
    interpret mode at K8's tolerance, on inputs drawn as the chip check
    draws them (unit B and C rows shared by the heads, dt a softplus,
    A = -linspace(1, 16))."""
    rng = np.random.default_rng(19)
    b, l, h, p, n, q = 1, 128, 4, 32, 64, 64
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF16).float()
    x = bf(rng.standard_normal((b, l, h, p)))
    dt = bf(np.log1p(np.exp(rng.standard_normal((b, l, h)))))
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = bf(rng.standard_normal((b, l, 1, n))).expand(b, l, h, n)
    cm = bf(rng.standard_normal((b, l, 1, n))).expand(b, l, h, n)
    ld = dt * torch.from_numpy(a)
    got = ssd_ref.ssd_chunk_tc_ref(x, ld, dt, bm, cm, q)
    want = ssd_chunk_kernel(*(jnp.asarray(t.contiguous().numpy())
                              for t in (x, ld, dt, bm, cm)),
                            chunk=q, interpret=True)
    plain = ssd_ref.ssd_chunk_ref(x, ld, dt, bm, cm, q)
    for name, g, w, pl in zip(("y_intra", "contrib", "total"), got, want,
                              plain):
        assert _to_scale(g, torch.from_numpy(_np(w))), name
        assert _to_scale(g, pl), name


def test_k8_bf16_parts_keep_eight_bits_each():
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32) * 100)
    for parts, bound in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -23)):
        err = (sum(ssd_ref.bf16_parts(w, parts)) - w).abs() / w.abs()
        assert float(err.max()) <= bound, parts


def test_ssd_scan_sources_use_no_float_atomics():
    """Every output of K8 and of its backward K8b is one thread's sums in a
    fixed order: no atomic adds or reductions in their CUDA sources."""
    pattern = re.compile(r"\batomicAdd|\bred\.(global|shared)"
                         r"|cp\.reduce\.async")
    sources = sorted((Path(ssd_kernel.__file__).parent / "csrc").glob("*.cu"))
    assert [src.name for src in sources] == ["ssd.cu", "ssd_bwd.cu",
                                             "ssd_bwd_tc.cu", "ssd_tc.cu"]
    for src in sources:
        assert not pattern.search(src.read_text()), src


# ------------------------------------------------------------ the scan
#: ``(b, l, h, p, n, chunk, with_state)``: ``tests/test_kernels.py``'s
#: four shapes (the last with a ragged tail), an initial state, and prompts
#: shorter than the chunk.
SCAN_CASES = [(2, 64, 4, 16, 32, 16, False), (1, 128, 8, 32, 16, 32, False),
              (2, 48, 2, 8, 8, 16, False), (1, 40, 4, 16, 16, 16, False),
              (1, 32, 2, 8, 8, 16, True), (1, 40, 4, 16, 16, 16, True),
              (2, 10, 3, 8, 8, 16, False), (1, 7, 2, 16, 8, 256, True)]


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state", SCAN_CASES)
def test_ssd_scan_matches_reference_scan_and_oracle(b, l, h, p, n, chunk,
                                                    with_state):
    arrays = _ssd_inputs(b, l, h, p, n, seed=l + h * 3 + p, with_state=
                         with_state)
    init = arrays[5] if with_state else None
    tensors = [torch.from_numpy(t) for t in arrays[:5]]
    y, state = ssd_ops.ssd_scan(*tensors, chunk=chunk, init_state=(
        None if init is None else torch.from_numpy(init)))
    assert y.shape == (b, l, h, p) and state.shape == (b, h, p, n)
    jarrays = [jnp.asarray(t) for t in arrays[:5]]
    jinit = None if init is None else jnp.asarray(init)
    ry, rstate = ref_ssd_scan(*jarrays, chunk=chunk, init_state=jinit)
    oy, ostate = jax_ssd_ref(*jarrays, init_state=jinit)
    for got, want in ((y, ry), (y, oy), (state, rstate), (state, ostate)):
        np.testing.assert_allclose(got.numpy(), _np(want), **SCAN)
    py, pstate = ssd_ref.ssd_ref(*tensors, init_state=(
        None if init is None else torch.from_numpy(init)))
    np.testing.assert_allclose(py.numpy(), _np(oy), **F32)
    np.testing.assert_allclose(pstate.numpy(), _np(ostate), **F32)


# ---------------------------------------------------------- model pieces
@pytest.fixture(scope="module")
def mamba_layer():
    """(reference cfg, reference layer-0 weights, port cfg, port layer-0
    weights) of the Mamba2 smoke config."""
    rcfg = ref_configs.get_smoke("mamba2_2p7b")
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = configs.get_smoke("mamba2_2p7b")
    params = from_reference_params(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    rblk = {k: v[0] for k, v in rparams["blocks"].items()}
    blk = {k: v[0] for k, v in params["blocks"].items()}
    return rcfg, rblk, cfg, blk


def test_ssd_chunked_matches_reference():
    x, dt, a_log, bm, cm, init = _ssd_inputs(2, 40, 4, 16, 24, seed=5,
                                             with_state=True)
    ry, rs = ref_ssd.ssd_chunked(*(jnp.asarray(t) for t in
                                   (x, dt, a_log, bm, cm)), 16,
                                 init_state=jnp.asarray(init))
    y, s = ssd.ssd_chunked(*(torch.from_numpy(t) for t in
                             (x, dt, a_log, bm, cm)), 16,
                           init_state=torch.from_numpy(init))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _np(ry), **F32)
    np.testing.assert_allclose(s.numpy(), _np(rs), **F32)


def test_ssd_chunked_returns_x_dtype():
    x, dt, a_log, bm, cm = _ssd_inputs(1, 32, 2, 8, 8, seed=6)
    y, s = ssd.ssd_chunked(torch.from_numpy(x).bfloat16(),
                           *(torch.from_numpy(t) for t in
                             (dt, a_log, bm, cm)), 16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32


def test_ssd_decode_step_matches_reference():
    x, dt, a_log, bm, cm, state = _ssd_inputs(2, 1, 4, 16, 24, seed=7,
                                              with_state=True)
    ry, rs = ref_ssd.ssd_decode_step(*(jnp.asarray(t) for t in
                                       (state, x, dt, a_log, bm, cm)))
    y, s = ssd.ssd_decode_step(*(torch.from_numpy(t) for t in
                                 (state, x, dt, a_log, bm, cm)))
    np.testing.assert_allclose(y.numpy(), _np(ry), **F32)
    np.testing.assert_allclose(s.numpy(), _np(rs), **F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    ry, rst = ref_ssd._causal_conv(*(jnp.asarray(t) for t in (x, w, b)),
                                   None if st is None else jnp.asarray(st))
    y, new = ssd._causal_conv(*(torch.from_numpy(t) for t in (x, w, b)),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), _np(ry), **F32)
    assert torch.equal(new, torch.from_numpy(np.array(rst)))


def test_ssd_block_prefill_then_decode_matches_reference(mamba_layer):
    """From a zero state: a prefill of 20 tokens (two chunks of 16, the
    second ragged), then three one-token decode steps."""
    rcfg, rblk, cfg, blk = mamba_layer
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 23, cfg.d_model)) * 0.5).astype(np.float32)
    rstate = ref_ssd.ssd_init_state(rcfg, 2)
    state = ssd.ssd_init_state(cfg, 2)
    for lo, hi in ((0, 20), (20, 21), (21, 22), (22, 23)):
        rout, rstate = ref_ssd.ssd_block(rblk, jnp.asarray(x[:, lo:hi]),
                                         rcfg, state=rstate)
        out, state = ssd.ssd_block(blk, torch.from_numpy(x[:, lo:hi]), cfg,
                                   state=state)
        np.testing.assert_allclose(out.numpy(), _np(rout), **F32)
        np.testing.assert_allclose(state["ssm"].numpy(),
                                   _np(rstate["ssm"]), **F32)
        for got, want in zip(state["conv"], rstate["conv"]):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_ssd_block_without_state_matches_reference(mamba_layer):
    rcfg, rblk, cfg, blk = mamba_layer
    x = (np.random.default_rng(10).standard_normal((2, 40, cfg.d_model))
         * 0.5).astype(np.float32)
    rout, _ = ref_ssd.ssd_block(rblk, jnp.asarray(x), rcfg)
    out, _ = ssd.ssd_block(blk, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), _np(rout), **F32)


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module", params=list(MODELS))
def smoke(request):
    """(reference cfg, reference params, port cfg, port params)."""
    arch, extra = MODELS[request.param]
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch), **extra)
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = dataclasses.replace(configs.get_smoke(arch), **extra)
    params = from_reference_params(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


def test_convert_carries_every_parameter_bit_for_bit(smoke):
    rcfg, rparams, cfg, params = smoke
    flat = jax.tree_util.tree_leaves_with_path(rparams)
    assert len(flat) == len(jax.tree_util.tree_leaves(
        tfm.param_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    assert sorted(params) == sorted(rparams)


def test_forward_matches_reference(smoke):
    rcfg, rparams, cfg, params = smoke
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 40))
    ref = ref_tfm.forward(rparams, rcfg, tokens=jnp.asarray(tokens))
    res = tfm.forward(params, cfg, tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(res.hidden.numpy(), _np(ref.hidden), **F32)
    assert float(res.aux_loss) == 0.0
    module = tfm.DecoderLM(cfg, params)
    assert torch.equal(module(torch.from_numpy(tokens)).hidden, res.hidden)


def _ref_generate(rcfg, rparams, prompt, steps, max_len):
    """The reference's ``greedy_generate``, keeping the logits."""
    prefill = ref_loop.make_prefill_step(rcfg, max_len)
    decode = jax.jit(ref_loop.make_decode_step(rcfg))
    logits, state = prefill(rparams, jnp.asarray(prompt))
    out, seen = [jnp.argmax(logits, -1)], [logits]
    for _ in range(steps - 1):
        logits, state = decode(rparams, state, out[-1])
        out.append(jnp.argmax(logits, -1))
        seen.append(logits)
    return np.stack(out, 1), np.stack(seen, 1)


@pytest.mark.parametrize("prompt_len", [20, 8])
def test_greedy_generate_matches_reference(smoke, prompt_len):
    """A prefill of 20 (a chunk of 16 and a ragged one) or of 8 (shorter
    than the chunk), then 6 greedy steps."""
    rcfg, rparams, cfg, params = smoke
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len))
    ref_tokens, ref_logits = _ref_generate(rcfg, rparams, prompt, 7, 48)
    tokens, logits = serve_loop.generate(cfg, params,
                                         torch.from_numpy(prompt), 7, 48)
    assert torch.equal(tokens, torch.from_numpy(ref_tokens).long())
    np.testing.assert_allclose(logits.numpy(), ref_logits, **F32)
    free = serve_loop.greedy_generate(cfg, params, prompt, 7, 48,
                                      device="cpu")
    assert torch.equal(free, tokens)


def test_decode_matches_full_forward(smoke):
    """``tests/test_decode_consistency.py``'s check on the port: token by
    token from a zero state equals one forward over the whole sequence,
    and a prefill of 9 then decode steps equals it too."""
    _, _, cfg, params = smoke
    b, s = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, s)))
    full = tfm.forward(params, cfg, tokens=tokens).hidden
    for prefix in (1, 9):
        state = tfm.init_decode_state(cfg, b, s, "cpu")
        r = tfm.forward(params, cfg, tokens=tokens[:, :prefix], cache=state)
        outs, state = [r.hidden], r.cache
        for t in range(prefix, s):
            r = tfm.forward(params, cfg, tokens=tokens[:, t:t + 1],
                            cache=state,
                            positions=torch.full((b, 1), t))
            outs.append(r.hidden)
            state = r.cache
        dec = torch.cat(outs, dim=1)
        assert float((full - dec).abs().max()) < 5e-5
        if cfg.family == "hybrid":
            assert state["kv"]["cursor"] == s


def test_decode_state_matches_reference_layout(smoke):
    rcfg, _, cfg, _ = smoke
    ref = ref_tfm.init_decode_state(rcfg, 3, 24)
    got = tfm.init_decode_state(cfg, 3, 24, "cpu")
    ref_ssm = ref["ssm"] if cfg.family == "hybrid" else ref
    ssm_state = got["ssm"] if cfg.family == "hybrid" else got
    assert tuple(ssm_state["ssm"].shape) == ref_ssm["ssm"].shape
    for a, b in zip(ssm_state["conv"], ref_ssm["conv"]):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not a.any()
    if cfg.family == "hybrid":
        assert tuple(got["kv"]["k"].shape) == ref["kv"]["k"].shape
        assert got["kv"]["cursor"] == 0


# ------------------------------------------------------ init_params
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_7b"])
def test_init_params_follows_the_reference_scheme(arch):
    """Shapes equal the reference's; the three fix-ups equal its values;
    the untouched stacked leaves (conv biases, ``ln``, ``norm_scale``) are
    truncated normals with fan-in n_layers, as in the reference (whose
    random bits differ)."""
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch), n_layers=32)
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=32)
    rparams = jax.tree_util.tree_map(
        np.asarray, ref_tfm.init_params(jax.random.PRNGKey(0), rcfg))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == sorted(rparams)
    for group, leaves in params.items():
        for name, t in leaves.items():
            assert tuple(t.shape) == rparams[group][name].shape, name
    blocks, rblocks = params["blocks"], rparams["blocks"]
    np.testing.assert_allclose(blocks["a_log"].numpy(), rblocks["a_log"],
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(blocks["a_log"][0], blocks["a_log"][-1])
    assert not blocks["dt_bias"].any() and not rblocks["dt_bias"].any()
    assert torch.equal(blocks["d_skip"], torch.ones_like(blocks["d_skip"]))
    assert (rblocks["d_skip"] == 1).all()
    std = 1.0 / np.sqrt(cfg.n_layers)
    for name in ("conv_x_b", "conv_b_b", "conv_c_b", "ln", "norm_scale"):
        t, r = blocks[name], rblocks[name]
        for v in (t.numpy(), r):
            assert np.abs(v).max() <= 2.0 * std
            assert abs(v.std() / std - 0.88) < 0.1, name
        assert abs(float(t.mean())) < 0.1 * std
    assert torch.equal(params["final_norm"]["scale"],
                       torch.ones(cfg.d_model))
    if arch == "zamba2_7b":
        assert torch.equal(params["shared_attn"]["ln1"],
                           torch.ones(cfg.d_model))
    assert sum(t.numel() for grp in params.values()
               for t in grp.values()) == sum(
        r.size for grp in rparams.values() for r in grp.values())


# ---------------------------------------------------- the serving driver
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_7b"])
def test_serve_driver_runs_the_cap_event_as_for_granite(capsys, arch):
    """The serving driver on the CPU at the smoke size: the SSM and the
    hybrid model behind the router give the routing, caps and note of the
    granite run's cap event (which ``tests/test_torch_serve.py`` holds
    against the reference's driver)."""
    argv = ["--smoke", "--device", "cpu", "--requests", "32",
            "--decode-steps", "8"]
    report = serve.main(["--arch", arch] + argv)
    dense = serve.main(["--arch", "granite_8b"] + argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[2] == lines[5]
    assert report.cfg.family == ("ssm" if arch == "mamba2_2p7b"
                                 else "hybrid")
    for field in ("routing", "caps", "routing_after", "caps_after",
                  "notes", "cap_changes", "migrations", "tokens"):
        assert getattr(report, field) == getattr(dense, field), field
    assert report.routing == {"rep0": 16, "rep1": 16}
    for rep, (prompts, tokens, logits) in report.batches.items():
        assert tokens.shape == (16, 8) and logits.shape == (16, 8, 256)
        assert torch.isfinite(logits).all()
        assert torch.equal(tokens, logits.argmax(-1))


# ----------------------------------------------------------- head dim 112
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_pallas_at_head_dim_112(dtype):
    """Zamba2-7B's shared attention (32 heads of 112) at a small size, a
    prefill and a continuation with a query offset."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    rng = np.random.default_rng(13)
    for b, sq, skv, h, qoff in ((2, 100, 100, 4, 0), (1, 40, 104, 2, 64)):
        jq, tq = _pair(rng.standard_normal((b, sq, h, 112)), jdt)
        jk, tk = _pair(rng.standard_normal((b, skv, h, 112)), jdt)
        jv, tv = _pair(rng.standard_normal((b, skv, h, 112)), jdt)
        out, lse = fa_ops.flash_attention(tq, tk, tv, q_offset=qoff)
        p_out, p_lse = flash_attention_kernel(jq, jk, jv, causal=True,
                                              q_offset=qoff, block_q=64,
                                              block_k=64, interpret=True)
        np.testing.assert_allclose(_np(out), _np(p_out), **tol)
        np.testing.assert_allclose(lse.numpy(), _np(p_lse), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_at_head_dim_112(dtype):
    """Ragged lengths over a cache of 3 blocks, and a row whose blocks are
    all fully masked but the first."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    rng = np.random.default_rng(14)
    b, s, h = 3, 192, 4
    jq, tq = _pair(rng.standard_normal((b, h, 112)), jdt)
    jk, tk = _pair(rng.standard_normal((b, s, h, 112)), jdt)
    jv, tv = _pair(rng.standard_normal((b, s, h, 112)), jdt)
    kv_len = np.array([2, 150, 192], np.int32)
    out = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                  block_k=64)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(kv_len), block_k=64)
    np.testing.assert_allclose(_np(out), _np(pallas), **tol)
