"""The port's segmented waterfill (K3) against the JAX package's.

The same ragged problems, made from a seed with NumPy (the reference
harness's builder and regimes: plain, zero-demand hosts, all-reserved,
single-VM hosts, an empty host, capacity below the reserved floor), go
through the port's ``ops.waterfill_segmented`` on the CPU (the plain
PyTorch version of kernel K3) and through the reference's NumPy
``waterfill_core``, its lax mirror ``lax_waterfill_segmented`` and its
Pallas driver ``pallas_waterfill_segmented`` (interpret mode off-TPU).
Tolerance 1e-9 MHz, relative and absolute: only the order of the sums
differs, and the residual bump absorbs the bisection's last ULPs.
"""

import contextlib

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.core import kernels as rk
from repro.drs.entitlement import batched_waterfill as ref_batched_waterfill
from repro.drs.entitlement import waterfill_core as ref_waterfill_core
from repro.kernels.powercap.ops import pallas_waterfill_segmented
from repro.kernels.powercap.ref import lax_waterfill_segmented
from repro_torch.core import kernels as tk
from repro_torch.drs.entitlement import batched_waterfill, waterfill_core
from repro_torch.kernels.powercap import ops, ref
from repro_torch.kernels.powercap.segments import (row_sums, row_width,
                                                   segment_layout, to_rows)

TOL = dict(rtol=1e-9, atol=1e-9)
SCENARIOS = ("plain", "zero_demand", "all_reserved", "single_vm",
             "empty_host", "budget_below_floor")
SEEDS = (0, 1, 2)


@pytest.fixture
def x64(monkeypatch):
    """JAX float64 for the reference, per test: JAX 0.9 dropped
    ``jax.experimental.enable_x64``, which the reference's segmented
    drivers import at call time, so it gets a stand-in around
    ``jax.enable_x64`` here."""
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        with jax.enable_x64(new_val):
            yield

    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)
    yield


def segmented_problem(seed: int, scenario: str, n: int = 40,
                      n_segs: int = 7):
    """``(capacity, floors, ceils, weights, seg, n_segs)``: the reference
    harness's ragged builder (``tests/test_kernel_parity.py``)."""
    rng = np.random.default_rng(seed ^ 0xCAFE)
    seg = rng.integers(0, n_segs, n)
    floors = rng.uniform(0.0, 100.0, n)
    ceils = floors + rng.uniform(0.0, 300.0, n)
    weights = rng.uniform(0.1, 5.0, n)
    if scenario == "zero_demand":
        floors[seg == 0] = 0.0
        ceils[seg == 0] = 0.0
    elif scenario == "all_reserved":
        ceils = floors.copy()
    elif scenario == "single_vm":
        keep = np.zeros(n, dtype=bool)
        keep[np.unique(seg, return_index=True)[1]] = True
        floors, ceils, weights, seg = (floors[keep], ceils[keep],
                                       weights[keep], seg[keep])
    elif scenario == "empty_host":
        seg = np.where(seg == 1, 2, seg)     # host 1 has no VMs
    total_floor = np.bincount(seg, weights=floors, minlength=n_segs)
    if scenario == "budget_below_floor":
        capacity = total_floor * rng.uniform(0.1, 0.9, n_segs)
    else:
        capacity = rng.uniform(0.0, 3000.0, n_segs)
    return capacity, floors, ceils, weights, seg, n_segs


def _port(capacity, floors, ceils, weights, seg, n_segs):
    return ops.waterfill_segmented(capacity, floors, ceils, weights, seg,
                                   n_segs, device="cpu").numpy()


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_matches_numpy_core(seed, scenario):
    cap, fl, ce, w, seg, m = segmented_problem(seed, scenario)
    want = ref_waterfill_core(ref_backend.NUMPY, cap, fl, ce,
                              np.maximum(w, 1e-12), seg, m)
    got = _port(cap, fl, ce, w, seg, m)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_segmented_matches_lax_mirror_and_pallas_interpret(x64, scenario):
    cap, fl, ce, w, seg, m = segmented_problem(3, scenario)
    got = _port(cap, fl, ce, w, seg, m)
    mirror = np.asarray(lax_waterfill_segmented(cap, fl, ce, w, seg, m))
    pallas = np.asarray(pallas_waterfill_segmented(cap, fl, ce, w, seg, m))
    assert mirror.dtype == pallas.dtype == np.float64
    np.testing.assert_allclose(got, mirror, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("scenario", ("plain", "budget_below_floor"))
def test_torch_waterfill_core_matches_numpy_core(scenario):
    cap, fl, ce, w, seg, m = segmented_problem(4, scenario)
    want = ref_waterfill_core(ref_backend.NUMPY, cap, fl, ce, w, seg, m)
    got = waterfill_core(*(torch.from_numpy(x) for x in (cap, fl, ce, w,
                                                          seg)), m)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_values_past_a_row_change_nothing():
    """Each host reads only its own window: changing every other host's
    items (to large stale values) leaves host 3's allocation bitwise the
    same, and so does poisoning the plain version's padded slots."""
    cap, fl, ce, w, seg, m = segmented_problem(5, "plain")
    clean = _port(cap, fl, ce, w, seg, m)
    rng = np.random.RandomState(6)
    other = seg != 3
    poison = rng.uniform(1e6, 1e9, fl.shape)
    got = _port(cap, np.where(other, poison, fl),
                np.where(other, 2 * poison, ce),
                np.where(other, rng.uniform(1e-6, 1e6, fl.shape), w), seg, m)
    np.testing.assert_array_equal(got[~other], clean[~other])

    layout = segment_layout(seg, m, "cpu")
    t = [torch.from_numpy(x) for x in (cap, fl, ce, w)]

    def poisoned_rows(values):
        pad = torch.arange(layout.jb) >= layout.counts[:, None]
        return torch.where(pad, 1e9, to_rows(layout, values))

    active = torch.arange(layout.jb) < layout.counts[:, None]
    out_rows = ref.waterfill_dense_ref(t[0], poisoned_rows(t[1]),
                                       poisoned_rows(t[2]),
                                       poisoned_rows(t[3]), 200, active)
    np.testing.assert_array_equal(
        out_rows[layout.seg, layout.slot].numpy(), clean[layout.order])


def test_layout_is_the_reference_csr():
    seg = np.array([2, 0, 2, 2, 0, 4, 2, 2, 2])
    lay = segment_layout(seg, 6, "cpu")
    np.testing.assert_array_equal(lay.order, np.argsort(seg, kind="stable"))
    np.testing.assert_array_equal(lay.counts, [2, 0, 6, 0, 1, 0])
    np.testing.assert_array_equal(lay.starts, [0, 2, 2, 8, 8, 9])
    np.testing.assert_array_equal(lay.slot, [0, 1, 0, 1, 2, 3, 4, 5, 0])
    assert lay.jb == 8 and lay.n_segs == 6
    assert [row_width(c) for c in (0, 1, 4, 5, 16, 17, 256)] == \
        [4, 4, 4, 8, 16, 32, 256]
    values = torch.arange(9, dtype=torch.float64)
    np.testing.assert_array_equal(
        row_sums(lay, values), np.bincount(seg, weights=values.numpy(),
                                           minlength=6))
    with pytest.raises(ValueError):
        segment_layout(seg, 4, "cpu")


def test_wrapper_dispatches_on_device_and_checks_inputs():
    """CPU tensors take the plain version and launch nothing; a prebuilt
    layout gives the same result; malformed inputs raise before anything
    runs, and a row wider than 256 slots is taken (here degenerate: its
    floors exceed the capacity, so each item gets its pro-rata share)."""
    cap, fl, ce, w, seg, m = segmented_problem(7, "plain")
    before = ops.waterfill_segmented.launches
    a = _port(cap, fl, ce, w, seg, m)
    lay = segment_layout(seg, m, "cpu")
    b = ops.waterfill_segmented(*(torch.from_numpy(x)
                                  for x in (cap, fl, ce, w)), layout=lay)
    np.testing.assert_array_equal(a, b.numpy())
    c = batched_waterfill(cap, fl, ce, w, seg, m, device="cpu")
    np.testing.assert_array_equal(a, c.numpy())
    assert ops.waterfill_segmented.launches == before
    t = [torch.from_numpy(x) for x in (cap, fl, ce, w)]
    with pytest.raises(TypeError):
        ops.waterfill_segmented(t[0], t[1].float(), t[2], t[3], seg, m)
    with pytest.raises(ValueError):
        ops.waterfill_segmented(t[0][:-1], t[1], t[2], t[3], seg, m)
    with pytest.raises(ValueError):
        ops.waterfill_segmented(t[0], t[1][:-1], t[2], t[3], seg, m)
    wide = np.zeros(257, dtype=np.int64)
    x = np.ones(257)
    got = ops.waterfill_segmented(np.ones(1), x, x, x, wide, 1, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.full(257, 1 / 257), **TOL)
    assert ops.waterfill_segmented(np.ones(2), x[:0], x[:0], x[:0],
                                   wide[:0], 2, device="cpu").shape == (0,)


def wide_problem(width: int, seed: int):
    """Hosts of ``width``, 3, 0 and ``width // 2 + 1`` items, items in a
    shuffled order, some reservations, capacities from 0.3x to 1.2x the
    demand, and one wide host whose floors exceed its capacity."""
    rng = np.random.default_rng(seed)
    counts = np.array([width, 3, 0, width // 2 + 1, width])
    seg = rng.permutation(np.repeat(np.arange(counts.size), counts))
    n = seg.size
    ceils = rng.uniform(200.0, 3000.0, n)
    floors = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 150.0, n), 0.0)
    weights = rng.choice([1000.0, 2000.0], n)
    demand = np.bincount(seg, weights=ceils, minlength=counts.size)
    capacity = rng.uniform(0.3, 1.2, counts.size) * demand
    floors[seg == 4] = 400.0
    capacity[4] = 0.5 * 400.0 * width
    return capacity, floors, ceils, weights, seg, counts.size


@pytest.mark.parametrize("executor", ("numpy", "jax-pallas"))
@pytest.mark.parametrize("width", (300, 1000))
def test_wide_rows_match_reference_batched_waterfill(x64, width, executor):
    """Rows wider than 256 items (the CUDA kernel streams them) against
    the reference's ``batched_waterfill``, as its own tests run it: NumPy
    by default and, under the ``jax-pallas`` executor, its segmented
    Pallas kernel in interpret mode with a window of 512 or 1024."""
    cap, fl, ce, w, seg, m = wide_problem(width, seed=width)
    with ref_backend.executor_scope(executor):
        want = ref_batched_waterfill(cap, fl, ce, w, seg, m)
    got = _port(cap, fl, ce, w, seg, m)
    assert segment_layout(seg, m, "cpu").jb == row_width(width) > 256
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.bincount(seg, weights=got, minlength=m),
                               np.minimum(cap, np.bincount(
                                   seg, weights=ce, minlength=m)),
                               rtol=1e-9)


def test_entitlement_sums_match_the_reference():
    """Per-host entitlement sums over (S, V) columns, through the port's
    K3 path, against the reference's NumPy ``entitlement_sums``."""
    rng = np.random.default_rng(8)
    S, H, V = 3, 5, 30
    on = rng.random((S, H)) < 0.8
    idle = rng.uniform(80.0, 120.0, (S, H))
    peak = idle + rng.uniform(100.0, 200.0, (S, H))
    cpk = rng.uniform(2000.0, 4000.0, (S, H))
    hyp = rng.uniform(0.0, 50.0, (S, H))
    caps = rng.uniform(idle, peak)
    seg = rng.integers(0, H, (S, V))
    floors = rng.uniform(0.0, 100.0, (S, V))
    ceils = floors + rng.uniform(0.0, 600.0, (S, V))
    weights = rng.uniform(0.5, 4.0, (S, V))
    want = rk.entitlement_sums(ref_backend.NUMPY,
                               rk.HostCols(on, idle, peak, cpk, hyp), caps,
                               floors, ceils, weights, seg)
    t = torch.from_numpy
    got = tk.entitlement_sums(
        tk.HostCols(t(on), t(idle), t(peak), t(cpk), t(hyp)), t(caps),
        t(floors), t(ceils), t(weights), seg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
