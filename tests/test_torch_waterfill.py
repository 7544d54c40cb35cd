"""The port's dense waterfill against the JAX package's.

The same inputs, made from a seed with NumPy, go through the port's
``waterfill_dense`` (on the CPU: the plain PyTorch version of kernel K1)
and through the reference's ``waterfill_dense_math`` (jnp, float64), its
Pallas driver ``pallas_waterfill_dense`` (interpret mode off-TPU) and the
NumPy segment form ``waterfill_core``.  Tolerance 1e-9 MHz, relative and
absolute: only the order of the sums differs, and the residual bump
absorbs the bisection's last ULPs.
"""

import contextlib

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as ref_backend
from repro.drs.entitlement import waterfill_core, waterfill_dense_math
from repro.kernels.powercap.ops import pallas_waterfill_dense
from repro_torch.drs.entitlement import waterfill_dense
from repro_torch.kernels.powercap import ops

TOL = dict(rtol=1e-9, atol=1e-9)
ITERS = 100
CASES = ("random", "degenerate", "single_slot", "limits_and_idle")


@pytest.fixture
def x64(monkeypatch):
    """JAX float64 for the reference, per test: JAX 0.9 dropped
    ``jax.experimental.enable_x64``, which the reference imports at call
    time, so it gets a stand-in around ``jax.enable_x64`` here."""
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        with jax.enable_x64(new_val):
            yield

    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)
    with jax.enable_x64(True):
        yield


def _case(kind: str, seed: int = 0, S: int = 3, H: int = 5, J: int = 7):
    """(capacity, floors, ceilings, weights, active) as NumPy arrays."""
    rng = np.random.RandomState(seed)
    if kind == "single_slot":
        J = 1
    active = rng.rand(S, H, J) < 0.8
    floors = rng.uniform(0.0, 400.0, (S, H, J)) * (rng.rand(S, H, J) < 0.4)
    ceils = floors + rng.uniform(0.0, 3000.0, (S, H, J))
    weights = rng.choice([500.0, 1000.0, 2000.0], (S, H, J))
    live_ceil = (ceils * active).sum(-1)
    cap = rng.uniform(0.1, 1.2, (S, H)) * live_ceil
    if kind == "degenerate":
        # Floors alone reach the capacity: pro-rata floors.
        floors = np.where(active, rng.uniform(100.0, 400.0, (S, H, J)), 0.0)
        ceils = floors + 50.0
        cap = 0.5 * floors.sum(-1)
    elif kind == "limits_and_idle":
        # Zero-demand slots, zero-capacity hosts and demand past capacity.
        ceils = np.where(rng.rand(S, H, J) < 0.3, 0.0, ceils)
        floors = np.minimum(floors, ceils)
        cap[:, 0] = 0.0
        cap[:, 1] = 10.0 * live_ceil[:, 1]
    return cap, floors, ceils, weights, active


def _port(cap, fl, ce, w, act):
    return waterfill_dense(*(torch.from_numpy(x) for x in (cap, fl, ce, w)),
                           ITERS, active=torch.from_numpy(act)).numpy()


def _fori(n, body, init):
    return jax.lax.fori_loop(0, n, body, init)


@pytest.mark.parametrize("kind", CASES)
def test_waterfill_matches_jax_math(x64, kind):
    cap, fl, ce, w, act = _case(kind, seed=1)
    want = np.asarray(waterfill_dense_math(
        jnp, _fori, *(jnp.asarray(x) for x in (cap, fl, ce, w)),
        iters=ITERS, active=jnp.asarray(act)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(_port(cap, fl, ce, w, act), want, **TOL)


@pytest.mark.parametrize("kind", CASES)
def test_waterfill_matches_pallas_interpret(x64, kind):
    cap, fl, ce, w, act = _case(kind, seed=2)
    want = np.asarray(pallas_waterfill_dense(cap, fl, ce, w, iters=ITERS,
                                             active=act))
    assert want.dtype == np.float64
    np.testing.assert_allclose(_port(cap, fl, ce, w, act), want, **TOL)


@pytest.mark.parametrize("kind", CASES)
def test_waterfill_matches_numpy_segments(kind):
    """Against the NumPy segment form over the live slots only."""
    cap, fl, ce, w, act = _case(kind, seed=3)
    seg = np.broadcast_to(np.arange(cap.size).reshape(cap.shape)[..., None],
                          act.shape)[act]
    want = waterfill_core(ref_backend.NUMPY, cap.reshape(-1), fl[act],
                          ce[act], np.maximum(w[act], 1e-12), seg, cap.size,
                          ITERS)
    got = _port(cap, fl, ce, w, act)
    np.testing.assert_allclose(got[act], want, **TOL)
    assert (got[~act] == 0.0).all()


def test_inactive_slots_are_inert():
    """Large stale values in inactive slots leave the output bitwise
    unchanged: the mask is applied inside the primitive."""
    cap, fl, ce, w, act = _case("random", seed=4)
    clean = _port(cap, np.where(act, fl, 0.0), np.where(act, ce, 0.0),
                  np.where(act, w, 1e-12), act)
    rng = np.random.RandomState(5)
    poison = rng.uniform(1e6, 1e12, fl.shape)
    got = _port(cap, np.where(act, fl, poison), np.where(act, ce, poison),
                np.where(act, w, rng.uniform(1e-6, 1e6, fl.shape)), act)
    np.testing.assert_array_equal(got, clean)


def test_wrapper_dispatches_on_tensor_device():
    """CPU tensors take the plain version and launch nothing; array-likes
    go where ``device`` says; malformed inputs raise."""
    cap, fl, ce, w, act = _case("random", seed=6)
    before = ops.waterfill_dense.launches
    a = ops.waterfill_dense(cap, fl, ce, w, ITERS, active=act, device="cpu")
    b = _port(cap, fl, ce, w, act)
    np.testing.assert_array_equal(a.numpy(), b)
    assert ops.waterfill_dense.launches == before
    t = [torch.from_numpy(x) for x in (cap, fl, ce, w)]
    with pytest.raises(TypeError):
        ops.waterfill_dense(t[0], t[1].float(), t[2], t[3])
    with pytest.raises(ValueError):
        ops.waterfill_dense(t[0][:, :-1], t[1], t[2], t[3])
    with pytest.raises(ValueError):
        ops.waterfill_dense(t[0], t[1], t[2].transpose(0, 1).contiguous()
                            .transpose(0, 1), t[3])
    empty = ops.waterfill_dense(t[0], t[1][..., :0], t[2][..., :0],
                                t[3][..., :0])
    assert empty.shape == (3, 5, 0)
