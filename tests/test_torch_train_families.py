"""Training the MoE, SSM and hybrid families: the port against the JAX
reference, on the CPU.

On the CPU K7's autograd Function runs its plain versions (the forward
:func:`ref.grouped_matmul_ref`, the backward
:func:`ref.grouped_matmul_bwd_ref`), and the SSD scan's intra-chunk step
runs K8's and K8b's plain versions (:func:`ref.ssd_chunk_ref`,
:func:`ref.ssd_chunk_bwd_ref`) through the same Functions that launch the
kernels on the card.  The reference has no backward kernel: its training
differentiates its einsums, so the plain versions are held against
``jax.vjp`` of them.  Inputs are drawn with NumPy from a seed and handed
to both packages; the reference's train state is carried across with
``convert.from_reference_train_state``.  Tolerances, all in float32: K7's
gradient 1e-6 relative (both sum the same products in float32), K8b's and
the scan's gradient 1e-5 relative L2 (the products and cumulative sums run
in other orders), the models' gradients 1e-4 relative L2 a leaf and the
loss 1e-5 (``tests/test_torch_train.py``'s bar for the dense family), the
parameters 1e-4 relative L2 after three steps; the reference's own
microbatching bar (``tests/test_models_smoke.py``).  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
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
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jax_gmm_ref
from repro.models import ssd as ref_ssd
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro.runtime import train_loop as ref_loop
from repro_torch import configs
from repro_torch.convert import from_reference_train_state
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import train
from repro_torch.models import moe, ssd
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, schedule
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves, leaves_with_path

ARCHS = ("olmoe_1b_7b", "mamba2_2p7b", "zamba2_7b")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


# ------------------------------------------------------------ K7's backward
#: ``(E, C, D, F)``: a square case, ragged widths, and C = 1.
K7_SHAPES = [(4, 16, 32, 24), (3, 13, 40, 7), (5, 1, 9, 17)]


@pytest.mark.parametrize("e,c,d,f", K7_SHAPES)
def test_k7_backward_plain_matches_jax_vjp(e, c, d, f):
    """``grouped_matmul_bwd_ref`` and the autograd Function's gradient on
    the CPU against ``jax.vjp`` of the reference's oracle."""
    rng = np.random.default_rng(e * 100 + c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    _, vjp = jax.vjp(jax_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    got = gmm_ref.grouped_matmul_bwd_ref(tx, tw, tdy)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    auto = torch.autograd.grad(gmm_ops.grouped_matmul(tx, tw), (tx, tw),
                               tdy)
    for name, g, a, ww in zip(("dx", "dw"), got, auto, want):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), _np(ww), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        assert torch.equal(g, a), name


def test_k7_backward_on_the_cpu_launches_nothing_and_keeps_dtypes():
    x = torch.randn(2, 3, 4, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(2, 4, 5, dtype=torch.bfloat16, requires_grad=True)
    before = gmm_ops.grouped_matmul.launches
    out = gmm_ops.grouped_matmul(x, w)
    dx, dw = torch.autograd.grad(out.float().sum(), (x, w))
    assert gmm_ops.grouped_matmul.launches == before
    assert dx.dtype == dw.dtype == torch.bfloat16
    with torch.no_grad():
        assert gmm_ops.grouped_matmul(x, w).requires_grad is False


# ------------------------------------------------- K7's backward's plan
#: Path TM's three products at OLMoE-1B-7B's widths and a microbatch's
#: capacity: ``(E, C, D, F)`` of the forward ``x @ w``.
TM_PRODUCTS = {"gate": (64, 1280, 2048, 1024), "up": (64, 1280, 2048, 1024),
               "down": (64, 1280, 1024, 2048)}


@pytest.mark.parametrize("case", sorted(TM_PRODUCTS))
def test_k7_plan_reads_the_backwards_transposed_operands_in_place(case):
    """dX = dY W^T and dW = X^T dY at path TM's shapes, on the views the
    backward passes: the wide regime, W^T read K-major and X^T MN-major,
    shared memory within an H100 block's; float32 on the CUDA cores with
    the same layouts."""
    e, c, d, f = TM_PRODUCTS[case]
    x = torch.empty((e, c, d), dtype=torch.bfloat16)
    w = torch.empty((e, d, f), dtype=torch.bfloat16)
    dy = torch.empty((e, c, f), dtype=torch.bfloat16)
    wt, xt = gmm_ops.transposed_operands(x, w)
    for dtype in (torch.bfloat16, torch.float32):
        dx_plan = gmm_kernel.plan(e, c, f, d, dtype, (dy.stride(),
                                                      wt.stride()))
        dw_plan = gmm_kernel.plan(e, d, c, f, dtype, (xt.stride(),
                                                      dy.stride()))
        want = "wide" if dtype == torch.bfloat16 else "cuda_core"
        assert (dx_plan.regime, dx_plan.x_t, dx_plan.w_t) == (want, False,
                                                               True)
        assert (dw_plan.regime, dw_plan.x_t, dw_plan.w_t) == (want, True,
                                                               False)
        for plan in (dx_plan, dw_plan):
            assert plan.smem_bytes <= gmm_kernel.SMEM_LIMIT
    assert dx_plan.grid == (-(-d // 64), -(-c // 64), e)
    # The forward's and the decode step's plans are unchanged.
    fwd = gmm_kernel.plan(e, c, d, f, torch.bfloat16)
    assert (fwd.regime, fwd.x_t, fwd.w_t) == ("wide", False, False)
    assert gmm_kernel.plan(e, 8, d, f, torch.bfloat16).regime == "narrow"


def test_k7_plan_takes_either_packed_axis_and_refuses_neither():
    """A transposed operand never goes to the narrow regime (its weight
    stream reads F packed), a pitch TMA cannot read keeps it on the CUDA
    cores, and an operand with neither inner axis packed raises."""
    e, c, d, f = 4, 8, 256, 128
    x = torch.empty((e, d, c), dtype=torch.bfloat16).transpose(1, 2)
    w = torch.empty((e, d, f), dtype=torch.bfloat16)
    p = gmm_kernel.plan(e, c, d, f, torch.bfloat16, (x.stride(),
                                                     w.stride()))
    assert (p.regime, p.x_t, p.w_t) == ("wide", True, False)
    assert gmm_kernel.plan(e, c, d, f, torch.bfloat16).regime == "narrow"
    odd = torch.empty((e, d, c + 3),
                      dtype=torch.bfloat16)[:, :, :c].transpose(1, 2)
    p = gmm_kernel.plan(e, c, d, f, torch.bfloat16, (odd.stride(),
                                                     w.stride()))
    assert (p.regime, p.x_t) == ("cuda_core", True)
    strided = torch.empty((e, c, 2 * d), dtype=torch.bfloat16)[:, :, ::2]
    with pytest.raises(ValueError, match="inner axes packed"):
        gmm_kernel.plan(e, c, d, f, torch.bfloat16, (strided.stride(),
                                                     w.stride()))
    with pytest.raises(ValueError, match="inner axes packed"):
        gmm_kernel.plan(e, c, d, f, torch.float32,
                        (x.stride(), (d * f * 2, 2 * f, 2)))


def test_k7_backward_operands_share_storage_with_x_and_w():
    """The backward's W^T and X^T are views: the saved x's and w's
    storage and element, their inner strides swapped, no copy made."""
    x = torch.randn(3, 40, 24, dtype=torch.bfloat16)
    w = torch.randn(3, 24, 16, dtype=torch.bfloat16)
    wt, xt = gmm_ops.transposed_operands(x, w)
    for t, src in ((wt, w), (xt, x)):
        assert t.data_ptr() == src.data_ptr()
        assert t.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr()
        assert t.stride() == (src.stride(0), src.stride(2), src.stride(1))
        assert not t.is_contiguous() and torch.equal(t, src.transpose(1, 2))
    assert wt.shape == (3, 16, 24) and xt.shape == (3, 24, 40)


# ------------------------------------------------------------------ K8b
def _jax_intra(x, ld, dt, bm, cm, q):
    """The intra-chunk part of the reference's ``ssd_chunked`` chunk step
    (``repro/models/ssd.py``): y_intra, the chunk's state contribution and
    its total log decay, every chunk at once."""
    bsz, l, h, p = x.shape
    nc = l // q

    def chunks(t):
        return t.reshape((bsz, nc, q) + t.shape[2:])

    xq, ldq, dtq, bq, cq = map(chunks, (x, ld, dt, bm, cm))
    cum = jnp.cumsum(ldq, axis=2)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = jnp.tril(jnp.ones((q, q), bool))
    lmat = jnp.exp(jnp.where(tri[None, None, :, :, None], dec, -jnp.inf))
    scores = jnp.einsum("bcthn,bcshn->bctsh", cq, bq)
    w = scores * lmat * dtq[:, :, None, :, :]
    y = jnp.einsum("bctsh,bcshp->bcthp", w, xq)
    total = cum[:, :, -1:, :]
    rem = jnp.exp(total - cum)
    contrib = jnp.einsum("bcshn,bcshp->bchpn",
                         bq * (rem * dtq)[..., None], xq)
    return y.reshape(bsz, l, h, p), contrib, total[:, :, 0, :]


def _k8b_case(b, l, h, p, n, q, seed, dyadic=False):
    """x, log decay, dt, B, C and the three cotangents, from NumPy.  With
    ``dyadic`` the log decays are multiples of 1/2 down to -11.5, whose
    prefix sums float32 holds exactly in any order: over a chunk of 256
    they reach about -1,500, where ``exp(-cum_s)`` overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    if dyadic:
        ld = (-rng.integers(1, 24, (b, l, h)) / 2.0).astype(np.float32)
    else:
        a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
        ld = (dt * a).astype(np.float32)
    bm = (rng.standard_normal((b, l, h, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, h, n)) * 0.3).astype(np.float32)
    nc = l // q
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dcon = rng.standard_normal((b, nc, h, p, n)).astype(np.float32)
    dtot = rng.standard_normal((b, nc, h)).astype(np.float32)
    return (x, ld, dt, bm, cm), (dy, dcon, dtot)


def _hold_k8b(operands, cots, q, torch_operands=None):
    _, vjp = jax.vjp(lambda *a: _jax_intra(*a, q),
                     *(jnp.asarray(t) for t in operands))
    want = vjp(tuple(jnp.asarray(t) for t in cots))
    ops_in = torch_operands or [torch.from_numpy(t) for t in operands]
    got = ssd_ref.ssd_chunk_bwd_ref(*ops_in, q,
                                    *(torch.from_numpy(t) for t in cots))
    for name, g, w in zip(("dx", "dlog_decay", "ddt", "db", "dc"), got,
                          want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert tuple(g.shape) == w.shape, name
        assert _rel_l2(g, w) <= 1e-5, (name, _rel_l2(g, w))
    return got


#: ``(B, L, H, P, N, Q)``: K8's test shapes with L % Q == 0.
K8B_SHAPES = [(2, 64, 4, 16, 32, 16), (1, 128, 3, 32, 16, 64),
              (2, 48, 2, 8, 8, 16), (1, 96, 5, 16, 24, 32)]


@pytest.mark.parametrize("b,l,h,p,n,q", K8B_SHAPES)
def test_k8b_plain_matches_jax_vjp_of_the_intra_chunk_math(b, l, h, p, n, q):
    operands, cots = _k8b_case(b, l, h, p, n, q, seed=l + h * 7 + n)
    _hold_k8b(operands, cots, q)


def test_k8b_plain_over_a_long_chunk_never_overflows():
    """A chunk of 256 whose log decay falls to about -1,500: split as
    ``exp(cum_t) exp(-cum_s)`` it would overflow; the twin takes the
    decays as differences and matches the reference's gradient."""
    operands, cots = _k8b_case(1, 256, 2, 16, 16, 256, seed=3, dyadic=True)
    cum = np.cumsum(operands[1], axis=1)
    with np.errstate(over="ignore"):
        assert cum.min() < -1000.0 and not np.isfinite(np.exp(-cum)).all()
    _hold_k8b(operands, cots, 256)


def test_k8b_plain_reads_poisoned_views_shared_across_heads():
    """B and C as one row shared by the heads (a head stride of 0, as the
    model passes them), views into allocations whose features past N and
    whose other rows hold NaN (T3): the twin reads only the view, and the
    per-head gradients sum to the shared row's."""
    b, l, h, p, n, q = 2, 64, 3, 8, 16, 32
    operands, cots = _k8b_case(b, l, h, p, n, q, seed=9)
    rng = np.random.default_rng(10)
    shared = [(rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
              for _ in range(2)]
    views = []
    for rows in shared:
        big = torch.full((b, l, 2, n + 8), float("nan"))
        big[:, :, :1, :n] = torch.from_numpy(rows)
        views.append(big[:, :, :1, :n].expand(b, l, h, n))
    operands = operands[:3] + tuple(np.broadcast_to(r, (b, l, h, n)).copy()
                                    for r in shared)
    torch_operands = [torch.from_numpy(t) for t in operands[:3]] + views
    got = _hold_k8b(operands, cots, q, torch_operands)
    packed = ssd_ref.ssd_chunk_bwd_ref(
        *(torch.from_numpy(t) for t in operands), q,
        *(torch.from_numpy(t) for t in cots))
    for g, w in zip(got, packed):
        assert torch.equal(g, w)


def test_k8b_plain_is_the_gradient_of_k8s_plain_version():
    """The written-out einsums equal autograd's gradient of
    ``ssd_chunk_ref`` (the SSDChunk Function's two halves agree)."""
    operands, cots = _k8b_case(2, 64, 3, 8, 12, 32, seed=5)
    leaves_in = [torch.from_numpy(t).requires_grad_() for t in operands]
    outs = ssd_ref.ssd_chunk_ref(*leaves_in, 32)
    auto = torch.autograd.grad(outs, leaves_in,
                               [torch.from_numpy(t) for t in cots])
    got = ssd_ref.ssd_chunk_bwd_ref(*(torch.from_numpy(t) for t in operands),
                                    32, *(torch.from_numpy(t) for t in cots))
    for g, a in zip(got, auto):
        assert _rel_l2(g, a) <= 1e-5


#: ``(b, l, h, p, n, chunk, with_state)``: the scan's shapes, a ragged
#: tail (the scan pads it), an initial state, a prompt shorter than the
#: chunk.
SCAN_CASES = [(2, 64, 4, 16, 32, 16, False), (1, 40, 4, 16, 16, 16, True),
              (2, 48, 2, 8, 8, 16, True), (1, 7, 2, 16, 8, 256, False)]


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state", SCAN_CASES)
def test_ssd_scan_gradient_matches_reference(b, l, h, p, n, chunk,
                                             with_state):
    """The gradient of the port's ``ssd_chunked`` (the scan, SSDChunk on
    the plain versions, the torch recurrence) in every input against
    ``jax.vjp`` of the reference's ``ssd_chunked``, B and C shared across
    the heads as the model passes them."""
    rng = np.random.default_rng(l * 3 + h)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    init = (rng.standard_normal((b, h, p, n)) * 0.2).astype(np.float32) \
        if with_state else None
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def ref_fn(x, dt, a_log, bm, cm, *init):
        return ref_ssd.ssd_chunked(
            x, dt, a_log, jnp.broadcast_to(bm, (b, l, h, n)),
            jnp.broadcast_to(cm, (b, l, h, n)), chunk,
            init_state=init[0] if init else None)

    inputs = (x, dt, a_log, bm, cm) + ((init,) if with_state else ())
    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(t) for t in inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    tin = [torch.from_numpy(t).requires_grad_() for t in inputs]
    y, state = ssd.ssd_chunked(
        tin[0], tin[1], tin[2], tin[3].expand(b, l, h, n),
        tin[4].expand(b, l, h, n), chunk,
        init_state=tin[5] if with_state else None)
    got = torch.autograd.grad((y, state), tin, (torch.from_numpy(dy),
                                                torch.from_numpy(dstate)))
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "init"), got, want):
        assert _rel_l2(g, w) <= 1e-5, (name, _rel_l2(g, w))


def test_ssd_scan_backward_on_the_cpu_launches_nothing():
    x = torch.randn(1, 32, 2, 8, requires_grad=True)
    dt = torch.rand(1, 32, 2)
    bm = torch.randn(1, 32, 2, 8)
    before = (ssd_ops.ssd_scan.launches, ssd_ops.ssd_chunk_bwd.launches)
    y, _ = ssd_ops.ssd_scan(x, dt, torch.zeros(2), bm, bm, chunk=16)
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert (ssd_ops.ssd_scan.launches,
            ssd_ops.ssd_chunk_bwd.launches) == before


# ------------------------------------------------------------ K8b's plan
#: Paths TP's and TH's calls: one sequence of 4096 a microbatch, chunk 256.
PLAN_CASES = {"TP": (1, 4096, 80, 64, 128, 256),
              "TH": (1, 4096, 112, 64, 64, 256)}


@pytest.mark.parametrize("tag", sorted(PLAN_CASES))
def test_k8b_plan_fits_shared_memory_at_the_paths(tag):
    b, l, h, p, n, q = PLAN_CASES[tag]
    plan = ssd_kernel.plan_bwd(b, l, h, p, n, q)
    assert plan.grid == (h, b * l // q, 1) and plan.threads == 256
    assert plan.smem_bytes == ssd_kernel.bwd_smem(p, n, q)
    assert 48 * 1024 < plan.smem_bytes <= ssd_kernel.SMEM_LIMIT


def test_k8b_plan_refuses_what_the_kernel_cannot_take():
    assert ssd_kernel.plan_bwd(2, 1024, 8, 128, 128, 512).smem_bytes <= \
        ssd_kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="up to 128"):
        ssd_kernel.plan_bwd(1, 256, 4, 160, 64, 256)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_kernel.plan_bwd(1, 250, 4, 64, 64, 256)
    with pytest.raises(ValueError, match="65535"):
        ssd_kernel.plan_bwd(70_000, 16, 1, 8, 8, 16)


def test_k8b_source_uses_no_float_atomics():
    """Every output of K8b is one block's sums in a fixed order: no atomic
    adds or reductions in either regime's source (``ssd_bwd.cu``,
    ``ssd_bwd_tc.cu``)."""
    pattern = re.compile(r"\batomic[A-Z]|\bred\.(global|shared)"
                         r"|\batom\.|cp\.reduce\.async")
    csrc = Path(ssd_kernel.__file__).parent / "csrc"
    for name, entry in (("ssd_bwd.cu", "ssd_chunk_bwd"),
                        ("ssd_bwd_tc.cu", "ssd_chunk_bwd_tc")):
        text = (csrc / name).read_text()
        assert entry in text and not pattern.search(text), name


#: Paths TP's and TH's bf16 calls with B and C one row shared by the heads
#: (head stride 0, position stride N): ``(B, L, H, P, N, Q)``.
def _shared_strides(l, n):
    return ((l * n, n, 0), (l * n, n, 0))


@pytest.mark.parametrize("tag", sorted(PLAN_CASES))
def test_k8b_plan_puts_the_paths_bf16_calls_on_the_tensor_cores(tag):
    b, l, h, p, n, q = PLAN_CASES[tag]
    plan = ssd_kernel.plan_bwd(b, l, h, p, n, q, torch.bfloat16,
                               _shared_strides(l, n))
    assert plan.regime == "tensor_core"
    assert plan.grid == (h, b * l // q, 1) and plan.threads == 128
    assert plan.smem_bytes == ssd_kernel.bwd_tc_smem(n, q)
    # Two blocks an SM: one block's loads run under the other's products.
    assert 2 * (plan.smem_bytes + 1024) <= 233_472
    # Packed B and C (a head each) take the same regime.
    assert ssd_kernel.plan_bwd(b, l, h, p, n, q, torch.bfloat16).regime == \
        "tensor_core"
    # float32 stays on the CUDA cores, as before.
    assert ssd_kernel.plan_bwd(b, l, h, p, n, q, torch.float32,
                               _shared_strides(l, n)) == \
        ssd_kernel.plan_bwd(b, l, h, p, n, q)


@pytest.mark.parametrize("shape,kw", [
    ((1, 512, 8, 32, 64, 128), {}),                  # P 32
    ((1, 512, 8, 64, 96, 128), {}),                  # N 96
    ((1, 512, 8, 64, 32, 128), {}),                  # N 32
    ((1, 1024, 8, 64, 64, 512), {}),                 # Q 512
    ((1, 480, 8, 64, 64, 96), {}),                   # Q no multiple of 64
    ((1, 512, 8, 64, 64, 128), {"aligned": False}),
    ((1, 512, 8, 64, 64, 128),                        # B's row pitch 68
     {"bc_strides": ((512 * 68, 68, 0), (512 * 64, 64, 0))}),
])
def test_k8b_plan_keeps_what_the_tensor_cores_refuse_on_the_cuda_cores(
        shape, kw):
    b, l, h, p, n, q = shape
    plan = ssd_kernel.plan_bwd(b, l, h, p, n, q, torch.bfloat16, **kw)
    assert plan.regime == "cuda_core" and plan.threads == 256
    assert plan.smem_bytes == ssd_kernel.bwd_smem(p, n, q)


def test_k8b_plan_refuses_a_dtype_it_does_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_kernel.plan_bwd(1, 512, 8, 64, 64, 128, torch.float16)


# ------------------------------------------------------- the MoE dispatch
def _moe_layer(seed=0):
    cfg = configs.get_smoke("olmoe_1b_7b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    blk = {k: params["blocks"][k][0].clone().requires_grad_()
           for k in moe.moe_param_specs(cfg)}
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)).requires_grad_()
    return cfg, blk, x


def test_moe_dispatch_gradient_is_bitwise_equal_over_runs():
    """Under ``torch.use_deterministic_algorithms(True)`` two backward
    passes of the MoE layer give the same bits in x, the router, the
    experts and through the aux loss.  On the CPU autograd's own gather
    backward is deterministic too; the card, where it would add with
    float atomics, reruns one OLMoE layer's backward in ``chip_smoke.py``
    (path TM)."""
    cfg, blk, x = _moe_layer()
    leaves_in = [x] + list(blk.values())
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            out, aux = moe.moe_ffn(blk, x, cfg)
            runs.append(torch.autograd.grad(out.square().sum() + aux,
                                            leaves_in))
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][1].abs().sum() > 0          # the router has a gradient


def test_token_gather_gradient_sums_each_tokens_pairs():
    """``_TokenGather``'s backward equals autograd's own gradient of the
    gather ``xt[token_of]`` (each token's k rows summed)."""
    rng = np.random.default_rng(4)
    t, k, d = 7, 3, 5
    xt = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    order = torch.from_numpy(rng.permutation(t * k))
    inv = torch.argsort(order, stable=True)
    g = torch.from_numpy(rng.standard_normal((t * k, d)).astype(np.float32))
    a = xt.clone().requires_grad_()
    b = xt.clone().requires_grad_()
    out = moe._TokenGather.apply(a, order // k, inv, k)
    assert torch.equal(out, xt[order // k])
    (ga,) = torch.autograd.grad(out, a, g)
    (gb,) = torch.autograd.grad(b[order // k], b, g)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6, atol=1e-6)


def test_moe_ffn_forward_is_unchanged_without_grad():
    """The dispatch's Function gives the forward's bits with and without
    a graph."""
    cfg, blk, x = _moe_layer(1)
    with torch.no_grad():
        want = moe.moe_ffn(blk, x, cfg)
    got = moe.moe_ffn(blk, x, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -------------------------------------------------- the families' training
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
    """The reference's gradient (``train_loop.py:101-136``): one jitted
    ``value_and_grad``, or the token-weighted sum over microbatches."""
    grad_fn = jax.jit(jax.value_and_grad(ref_loop.make_loss_fn(rcfg),
                                         has_aux=True))
    k = max(rcfg.microbatches, 1)
    if k == 1:
        (_, metrics), grads = grad_fn(params, batch)
        return grads, metrics
    gsum, loss_sum, tok_sum = None, 0.0, 0.0
    for i in range(k):
        mb = {key: jnp.split(v, k)[i] for key, v in batch.items()}
        (_, metrics), grads = grad_fn(params, mb)
        tok = metrics["tokens"]
        scaled = jax.tree_util.tree_map(lambda g: g * tok, grads)
        gsum = scaled if gsum is None else jax.tree_util.tree_map(
            jnp.add, gsum, scaled)
        loss_sum += metrics["loss"] * tok
        tok_sum += tok
    tok = max(float(tok_sum), 1.0)
    return (jax.tree_util.tree_map(lambda g: g / tok, gsum),
            {"loss": loss_sum / tok, "tokens": tok_sum})


def _states(arch, microbatches):
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                               microbatches=microbatches)
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              microbatches=microbatches)
    sched = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    ropt = ref_adamw.AdamW(learning_rate=ref_schedule.cosine_schedule(
        **sched))
    opt = adamw.AdamW(learning_rate=schedule.cosine_schedule(**sched))
    rstate = ref_loop.init_train_state(jax.random.PRNGKey(0), rcfg, ropt)
    state = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, device="cpu")
    return rcfg, cfg, ropt, opt, rstate, state


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, microbatches):
    """``make_grads_fn`` from the reference's own initial state (its expert
    stacks, SSD leaves and shared attention block carried across): every
    leaf within 1e-4 relative L2 and the loss within 1e-5 of the
    reference's ``jax.value_and_grad``."""
    rcfg, cfg, _, _, rstate, state = _states(arch, microbatches)
    rbatch, batch = _batch(cfg, np.random.default_rng(microbatches))
    rgrads, rmetrics = _ref_grads(rcfg, rstate.params, rbatch)
    grads, metrics = train_loop.make_grads_fn(cfg)(state.params, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=1e-5)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    paths = 0
    for path, g in leaves_with_path(grads):
        assert g.dtype == torch.float32
        assert _rel_l2(g, _ref_leaf(rgrads, path)) <= 1e-4, path
        paths += 1
    assert paths == len(jax.tree_util.tree_leaves(rgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same state: loss within 1e-5 and the gradients' norm
    within 1e-4 each step, every parameter within 1e-4 relative L2
    after the three."""
    rcfg, cfg, ropt, opt, rstate, state = _states(arch, 1)
    rstep = jax.jit(ref_loop.make_train_step(rcfg, ropt))
    step = train_loop.make_train_step(cfg, opt)
    rng = np.random.default_rng(7)
    for _ in range(3):
        rbatch, batch = _batch(cfg, rng)
        rstate, rmetrics = rstep(rstate, rbatch)
        state, metrics = step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(rmetrics["grad_norm"]), rtol=1e-4)
    assert state.step == int(rstate.step) == 3
    for path, p in leaves_with_path(state.params):
        assert _rel_l2(p, _ref_leaf(rstate.params, path)) <= 1e-4, path


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_2p7b"])
def test_microbatched_step_meets_the_references_bar(arch):
    """The reference's ``test_microbatched_grads_match_single_shot`` on the
    port: one step at 1 and at 2 microbatches from one state, the loss
    within 5e-2 for moe (capacity drops differ between the token pools)
    and within 2e-5 for ssm, whose parameters agree within 1e-4."""
    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (4, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (4, 32))),
             "weights": torch.ones(4, 32)}
    out = {}
    for k in (1, 2):
        kcfg = dataclasses.replace(cfg, microbatches=k)
        opt = adamw.AdamW(learning_rate=1e-3)
        state = train_loop.init_train_state(
            kcfg, opt, torch.Generator().manual_seed(2), "cpu")
        out[k] = train_loop.make_train_step(kcfg, opt)(state, batch)
    (s1, m1), (s2, m2) = out[1], out[2]
    tol = 5e-2 if cfg.family == "moe" else 2e-5
    assert abs(float(m1["loss"]) - float(m2["loss"])) < tol
    if cfg.family != "moe":
        diff = max(float((a - b).detach().abs().max()) for a, b in
                   zip(leaves(s1.params), leaves(s2.params)))
        assert diff < 1e-4


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_7b"])
def test_remat_keeps_the_gradients(arch, remat):
    """Checkpointed Mamba layers (recomputed in the backward) give the
    gradients of the plain forward, bit for bit on the CPU."""
    cfg = configs.get_smoke(arch)
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


# ---------------------------------------------------------- the driver
ARGV = ["--smoke", "--device", "cpu", "--steps", "4", "--global-batch", "4",
        "--seq-len", "32", "--pods", "2", "--power-budget-drop-at", "1",
        "--checkpoint-every", "0"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_the_family_with_the_dense_power_plane(tmp_path,
                                                                 arch):
    """``launch.train`` trains the family on the CPU with MiniCPM's power
    plane: the same plans and caps after the budget cut, finite losses,
    and a checkpoint at the last step."""
    report = train.main(["--arch", arch, "--checkpoint-dir",
                         str(tmp_path / arch)] + ARGV)
    dense = train.main(["--arch", "minicpm_2b", "--checkpoint-dir",
                        str(tmp_path / "dense")] + ARGV)
    assert report.cfg.family == {"olmoe_1b_7b": "moe", "mamba2_2p7b": "ssm",
                                 "zamba2_7b": "hybrid"}[arch]
    assert (report.plans, report.caps) == (dense.plans, dense.caps)
    assert report.plans == [(0, [2, 2]), (1, [1, 2])]
    assert len(report.losses) == 4 and np.isfinite(report.losses).all()
    assert np.isfinite(report.grad_norms).all()
    assert report.state.step == 4
    assert Path(report.checkpoint_path).exists()
