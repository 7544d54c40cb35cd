"""The port's expert-parallel MoE dispatch on CPU ranks (gloo), against
the JAX package's dense dispatch and the port's own.

The reference's bar (``tests/test_moe_shardmap.py``): at
``moe_capacity_factor=8.0`` no pair is dropped, so the expert-parallel
output equals the dense path's within 1e-6 in float32.  Here each rank of
a ``("data", "model")`` mesh takes its batch shard over ``data`` and its
experts (and its slice of DeepSeek-MoE's shared experts) over ``model``:
its output against the reference's ``_moe_ffn_dense`` on the whole
batch, its aux loss against the mean over the data shards of the
reference's (the reference's ``pmean``), the aux loss's router gradient,
summed over the data ranks, against the gradient of that mean, and the
gradients of ``sum(y * probe)`` in x, the router and every expert leaf,
summed over the data ranks, against the port's dense path at 1e-5
relative.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.launch import mesh
from repro_torch.models import moe
from repro_torch.runtime.sharding import Rules, sharding_context

TIMEOUT_S = 120.0


def _layer(arch: str, seed: int = 0):
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              moe_capacity_factor=8.0)
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                               moe_capacity_factor=8.0)
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update(shared_w_gate=(d, fs), shared_w_up=(d, fs),
                      shared_w_down=(fs, d))
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in shapes.items()}
    x = (rng.standard_normal((4, 16, d)) * 0.5).astype(np.float32)
    probe = rng.standard_normal(x.shape).astype(np.float32)
    return cfg, rcfg, params, x, probe


def _dense_grads(cfg, params, x, probe) -> dict:
    own = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in params.items()}
    xs = torch.from_numpy(x).requires_grad_(True)
    y, _ = moe._moe_ffn_dense(own, xs, cfg)
    g = torch.autograd.grad((y * torch.from_numpy(probe)).sum(),
                            [xs] + list(own.values()))
    return dict(zip(["x"] + list(own), (t.numpy() for t in g)))


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["w4", "w8"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_moe_16b"])
def test_expert_parallel_matches_the_dense_dispatch(arch, shape):
    cfg, rcfg, params, x, probe = _layer(arch)
    outs = mesh.spawn(ranks.moe_ep, shape[0] * shape[1], "cpu", cfg, params,
                      x, probe, shape, timeout_s=TIMEOUT_S)
    rparams = {k: jnp.asarray(v) for k, v in params.items()}
    y_ref, _ = ref_moe._moe_ffn_dense(rparams, jnp.asarray(x), rcfg)
    y_ref = np.asarray(y_ref)
    b = x.shape[0] // shape[0]
    aux_ref = np.mean([float(ref_moe._moe_ffn_dense(
        rparams, jnp.asarray(x[i * b:(i + 1) * b]), rcfg)[1])
        for i in range(shape[0])])
    for o in outs:
        di, _ = o["coord"]
        assert np.max(np.abs(o["y"] - y_ref[di * b:(di + 1) * b])) < 1e-6
        np.testing.assert_allclose(o["aux"], aux_ref, rtol=1e-6)

    want = _dense_grads(cfg, params, x, probe)

    def summed(key, mi):
        return sum(o["grads"][key] for o in outs if o["coord"][1] == mi)
    got = {"x": np.concatenate([o["grads"]["x"] for o in outs
                                if o["coord"][1] == 0]),
           "router": summed("router", 0)}
    for key in want:
        if key.startswith("w_"):
            got[key] = np.concatenate([summed(key, m)
                                       for m in range(shape[1])])
        elif key.startswith("shared_"):
            got[key] = np.concatenate(
                [summed(key, m) for m in range(shape[1])],
                axis=0 if key == "shared_w_down" else 1)
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) < 1e-5, key
    # The aux loss's router gradient, summed over the data ranks as the
    # training step sums it, is the gradient of the mean over the data
    # shards of each shard's aux loss (the reference's ``pmean``).
    def shard_aux_grad(i):
        own = {k: torch.from_numpy(v) for k, v in params.items()}
        own["router"] = own["router"].clone().requires_grad_(True)
        _, a = moe._moe_ffn_dense(own, torch.from_numpy(x[i * b:(i + 1) * b]),
                                  cfg)
        return torch.autograd.grad(a, own["router"])[0].numpy()
    want_aux = sum(shard_aux_grad(i) for i in range(shape[0])) / shape[0]
    got_aux = sum(o["aux_router"] for o in outs if o["coord"][1] == 0)
    assert _rel(got_aux, want_aux) < 1e-5
    # Every expert rank of one data shard holds the same router gradient.
    for o in outs:
        np.testing.assert_array_equal(
            o["grads"]["router"],
            next(p["grads"]["router"] for p in outs
                 if p["coord"] == (o["coord"][0], 0)))


def test_expert_parallel_gradient_is_bitwise_over_runs():
    """Two backward passes on two ranks under deterministic algorithms:
    every gradient equal bit for bit (ROADMAP trap T1)."""
    _, _, params, x, _ = _layer("deepseek_moe_16b", seed=1)
    cfg = configs.get_smoke("deepseek_moe_16b")
    assert all(mesh.spawn(ranks.moe_ep_deterministic, 2, "cpu", cfg, params,
                          x, timeout_s=TIMEOUT_S))


class _Mesh:
    """A stand-in with a ``DeviceMesh``'s names and sizes."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


def test_expert_axis_needs_a_context_an_axis_that_divides_and_no_opt_out(
        monkeypatch):
    """The expert-parallel dispatch runs only under a context whose
    expert axis has more than one rank and divides ``n_experts``, and not
    with ``REPRO_MOE_DENSE`` set (the reference's choice)."""
    cfg = configs.get_smoke("olmoe_1b_7b")       # 8 experts
    assert moe._expert_axis(cfg) is None
    rules = Rules(batch=("data",), expert=("model",))
    for sizes, runs in (((1, 2), True), ((1, 1), False), ((1, 3), False)):
        with sharding_context(_Mesh(("data", "model"), sizes), rules):
            assert (moe._expert_axis(cfg) is not None) == runs, sizes
    with sharding_context(_Mesh(("data",), (4,)), rules):
        assert moe._expert_axis(cfg) is None
    monkeypatch.setitem(os.environ, "REPRO_MOE_DENSE", "1")
    with sharding_context(_Mesh(("data", "model"), (1, 2)), rules):
        assert moe._expert_axis(cfg) is None


def test_expert_shard_slices_the_reference_in_specs():
    """Rank i of n holds experts ``[i E/n, (i+1) E/n)``, the i-th ffn slice
    of the shared experts, and the whole router."""
    cfg, _, params, _, _ = _layer("deepseek_moe_16b")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    parts = [moe.expert_shard(full, cfg, i, 4) for i in range(4)]
    for key in ("w_gate", "w_up", "w_down", "shared_w_down"):
        assert torch.equal(torch.cat([p[key] for p in parts]), full[key])
    for key in ("shared_w_gate", "shared_w_up"):
        assert torch.equal(torch.cat([p[key] for p in parts], 1), full[key])
    assert all(p["router"] is full["router"] for p in parts)
