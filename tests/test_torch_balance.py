"""The port's BalancePowerCap loop against the JAX package's.

The same random cells, made from a seed with NumPy (both host types of the
sweeps, hypervisor overheads, reservations, hosts powered off, cells with
the policy disabled or fewer than two hosts on), go through the port's
``balance_caps`` (on the CPU: the plain PyTorch version of kernel K2), the
reference's ``balance_caps`` on its JAX backend, and its Pallas driver
``pallas_balance_caps`` (interpret mode off-TPU).  Caps agree to 1e-9
relative (only the order of sums differs); the did-anything flags exactly.
"""

import contextlib

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import jax_backend
from repro.core import kernels as rk
from repro.drs.entitlement import waterfill_dense_math
from repro.kernels.powercap.ops import pallas_balance_caps
from repro_torch.core import kernels as tk
from repro_torch.kernels.powercap import ops
from repro_torch.sim.sweep import SMALL_HOST
from repro_torch.core.power_model import PAPER_HOST

ITERS = 100
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture
def x64(monkeypatch):
    """JAX float64 for the reference, per test (JAX 0.9 dropped
    ``jax.experimental.enable_x64``, which the reference imports)."""
    @contextlib.contextmanager
    def enable_x64(new_val=True):
        with jax.enable_x64(new_val):
            yield

    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64,
                        raising=False)
    with jax.enable_x64(True):
        yield


def _cells(seed: int, S: int = 6, H: int = 8, J: int = 5):
    rng = np.random.RandomState(seed)
    small = rng.rand(S, H) < 0.5
    pick = lambda f: np.where(small, getattr(SMALL_HOST, f),  # noqa: E731
                              getattr(PAPER_HOST, f))
    idle, peak, cpk = pick("power_idle"), pick("power_peak"), \
        pick("capacity_peak")
    hyp = np.where(rng.rand(S, H) < 0.3, rng.uniform(0, 400, (S, H)), 0.0)
    on = rng.rand(S, H) < 0.9
    on[0, 1:] = False                      # one host on: passes through
    caps = np.where(on, rng.uniform(idle + 5, peak - 5), 0.0)
    budget = (caps * on).sum(-1)
    active = (rng.rand(S, H, J) < 0.85) & on[..., None]
    res = np.where(rng.rand(S, H, J) < 0.3, rng.uniform(0, 300, (S, H, J)),
                   0.0)
    dem = rng.uniform(200, 3000, (S, H, J)) * (
        1.0 + 2.0 * (rng.rand(S, H, 1) < 0.25))
    floors = np.where(active, res, 0.0)
    ceils = np.where(active, np.maximum(dem, res), 0.0)
    weights = rng.choice([1000.0, 2000.0], (S, H, J))
    enabled = rng.rand(S) < 0.8
    enabled[1] = False
    return dict(on=on, idle=idle, peak=peak, cpk=cpk, hyp=hyp, caps=caps,
                budget=budget, floors=floors, ceils=ceils, weights=weights,
                active=active, cpu_res=(res * active).sum(-1),
                enabled=enabled)


def _port(c):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}
    hosts = tk.HostCols(t["on"], t["idle"], t["peak"], t["cpk"], t["hyp"])
    dense = tk.DenseCols(t["floors"], t["ceils"], t["weights"], t["active"],
                         ITERS)
    caps, did = tk.balance_caps(hosts, t["caps"], dense, t["cpu_res"],
                                t["budget"], t["enabled"], tk.BalanceParams())
    return caps.numpy(), did.numpy()


def _ref_hosts(c):
    return rk.HostCols(*(jnp.asarray(c[k])
                         for k in ("on", "idle", "peak", "cpk", "hyp")))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_balance_matches_jax_backend(x64, seed):
    c = _cells(seed)
    hosts = _ref_hosts(c)
    fl, ce, w, act = (jnp.asarray(c[k])
                      for k in ("floors", "ceils", "weights", "active"))

    def ents_at(caps):
        managed = rk.managed_capacity(jnp, hosts, caps)
        return jnp.sum(waterfill_dense_math(
            jnp, jax_backend().fori, managed, fl, ce, w, iters=ITERS,
            active=act), axis=-1)

    caps, did = rk.balance_caps(
        jax_backend(), hosts, jnp.asarray(c["caps"]), ents_at,
        jnp.asarray(c["cpu_res"]), jnp.asarray(c["budget"]),
        jnp.asarray(c["enabled"]), rk.BalanceParams())
    got_caps, got_did = _port(c)
    np.testing.assert_allclose(got_caps, np.asarray(caps), **TOL)
    np.testing.assert_array_equal(got_did, np.asarray(did))
    assert np.asarray(did).any(), "the cells should move some watts"


@pytest.mark.parametrize("seed", (3, 4))
def test_balance_matches_pallas_interpret(x64, seed):
    c = _cells(seed)
    caps, did = pallas_balance_caps(
        _ref_hosts(c), c["caps"],
        rk.DenseCols(c["floors"], c["ceils"], c["weights"], c["active"],
                     ITERS),
        jnp.asarray(c["cpu_res"]), jnp.asarray(c["budget"]),
        jnp.asarray(c["enabled"]), rk.BalanceParams())
    got_caps, got_did = _port(c)
    np.testing.assert_allclose(got_caps, np.asarray(caps), **TOL)
    np.testing.assert_array_equal(got_did, np.asarray(did))


def test_balance_passes_through_disabled_and_lonely_cells():
    """Disabled cells and cells with fewer than two hosts on keep their
    caps bitwise; the plain version launches nothing."""
    c = _cells(5)
    before = ops.balance_caps.launches
    got_caps, got_did = _port(c)
    assert ops.balance_caps.launches == before
    for s in (0, 1):
        assert not got_did[s]
        np.testing.assert_array_equal(got_caps[s], c["caps"][s])


def test_balance_without_slots_is_well_formed():
    """J == 0: every host has zero entitlement, so nothing is moved."""
    c = _cells(6)
    for k in ("floors", "ceils", "weights", "active"):
        c[k] = c[k][..., :0]
    got_caps, got_did = _port(c)
    np.testing.assert_array_equal(got_caps, c["caps"])
    assert not got_did.any()
