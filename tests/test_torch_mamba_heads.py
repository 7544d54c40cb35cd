"""A Mamba2 mixer split over its heads on CPU ranks (gloo), held against
the reference's single-device functions.

The reference shards a mixer's ``heads`` over ``model`` through GSPMD
(``repro/models/ssd.py``'s annotations and ``ssd_param_specs``); the port
runs each rank's block of heads explicitly (``models/ssd.py``): its
columns of ``in_z``, ``in_x``, ``in_dt`` and the x conv, its ``a_log``,
``d_skip``, ``dt_bias`` and ``norm_scale`` and its rows of ``out_proj``,
with ``in_b``, ``in_c`` and their convs whole, the input entering through
Megatron's ``f``, the output leaving through ``g`` and the gated RMSNorm
summing its squares over the ranks.  Mamba2-2.7B's and Zamba2-7B's smoke
configs (8 heads) run under the production rules ``rules_for(configs
.get(arch), shape, mesh_size=256 or 512)`` (``prefill_32k``,
``decode_32k``, ``train_4k`` at 512: heads over ``model``) on meshes of
model size 2 and 4, and Zamba2 under ``long_500k``'s rules on ``("pod",
"data", "model") = (1, 2, 2)`` (``kv_seq`` over ``data``, no batch
split, heads over ``model``): the prefill's logits within
1e-5, the greedy tokens identical, the gradients within 1e-4 relative L2
a leaf and the loss within 1e-5.  Zamba2's shared attention block
splits its kv heads over ``model`` too (32 of them in production): at
model size 4 its smoke config's 2 kv heads stay whole (``kv_heads``
replicated, as ``rules_for`` keeps a kv head count that the axis does
not divide; split, they would not be whole heads, a ``ValueError``).
The split RMSNorm's forward and VJP
are held against the reference's ``layers.rms_norm``.  One spawn a mesh
runs every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_split_ranks as split
from repro.models import layers as ref_layers
from repro_torch.launch import mesh
from test_torch_sequence_parallel import (CELLS, case, check_decode,
                                          check_prefill, check_train,
                                          production_rules, reference, spawn)

ARCHS = ("mamba2_2p7b", "zamba2_7b")
TIMEOUT_S = 240.0
#: The rules' changes at model size 4: the smoke's 2 kv heads whole.
FOUR = {"mamba2_2p7b": {}, "zamba2_7b": {"kv_heads": None}}


def _four(arch: str) -> dict:
    return {kind: dataclasses.replace(r, **FOUR[arch])
            for kind, r in production_rules(arch).items()}


@pytest.fixture(scope="module")
def model2():
    return spawn([case(a, production_rules(a)) for a in ARCHS], (1, 1, 2))


@pytest.fixture(scope="module")
def model4():
    """Model size 4, and in the same spawn Zamba2 under ``long_500k``'s
    rules on (1, 2, 2): no batch split, so the four prompts of the other
    cases serve."""
    long = production_rules("zamba2_7b", {
        "prefill": ("long_500k", 256), "decode": ("long_500k", 512)})
    return spawn([case(a, _four(a)) for a in ARCHS], (1, 1, 4),
                 ((1, 2, 2), [case("zamba2_7b", long, "zamba2_7b-long")]))


def test_the_production_rules_split_the_mixer_s_heads():
    for arch in ARCHS:
        for kind, rules in production_rules(arch).items():
            assert rules.heads == ("model",), (arch, kind)
    long = production_rules("zamba2_7b", {"d": ("long_500k", 256)})["d"]
    assert long.kv_seq == ("pod", "data") and long.batch == ()
    assert CELLS["train"] == ("train_4k", 512)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_two_ranks(arch, model2):
    check_prefill(model2[arch], reference(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_two_ranks(arch, model2):
    check_decode(model2[arch], reference(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_two_ranks(arch, model2):
    check_train(model2[arch], reference(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_four_ranks(arch, model4):
    check_prefill(model4[arch], reference(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_four_ranks(arch, model4):
    check_decode(model4[arch], reference(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_four_ranks(arch, model4):
    check_train(model4[arch], reference(arch))


@pytest.mark.parametrize("check", ["prefill", "decode"])
def test_long_500k_layout(check, model4):
    """``kv_seq`` over ``data`` (a 20-position cache: rank 1's block of
    the positions holds none of the prompt) and the heads over
    ``model``."""
    ref = reference("zamba2_7b")
    ranks = model4["zamba2_7b-long"]
    (check_prefill if check == "prefill" else check_decode)(ranks, ref)


WIDTHS = (64, 128)


def _norm_inputs(width: int) -> tuple:
    rng = np.random.default_rng(width)
    x = rng.standard_normal((2, 5, width)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    return x, scale, rng.standard_normal(x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def split_norms():
    outs = mesh.spawn(split.split_norms, 2, "cpu", (1, 1, 2),
                      [_norm_inputs(w) for w in WIDTHS], timeout_s=TIMEOUT_S)
    return {w: [o[i] for o in outs] for i, w in enumerate(WIDTHS)}


@pytest.mark.parametrize("width", WIDTHS)
def test_split_rms_norm_vjp_matches_the_reference(width, split_norms):
    """The split RMSNorm's output and VJP, over a last dim split across 2
    ranks, against ``jax.vjp`` of the reference's ``layers.rms_norm``."""
    x, scale, dy = _norm_inputs(width)
    y, vjp = jax.vjp(lambda a, s: ref_layers.rms_norm(a, s, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale))
    dx, dscale = vjp(jnp.asarray(dy))
    for o in split_norms[width]:
        np.testing.assert_allclose(o["y"], np.asarray(y), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o["dx"], np.asarray(dx), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o["dscale"], np.asarray(dscale),
                                   rtol=1e-5, atol=1e-5)


def test_chip_smoke_float64_mamba2_gradient_matches_the_port():
    """``chip_smoke.mamba2_f64_grads``, the float64 Mamba2 written apart
    against which path TS holds ``a_log`` and ``dt_bias`` on the card,
    equals the port's float32 gradient (plain versions, one microbatch,
    some weights zero) at Mamba2-2.7B's smoke config within 1e-4 relative
    L2 a leaf."""
    import importlib
    import sys
    from pathlib import Path

    import torch

    from repro_torch import configs
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn
    from repro_torch.tree import leaves_with_path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    cs = importlib.import_module("chip_smoke")
    cfg = dataclasses.replace(configs.get_smoke("mamba2_2p7b"),
                              param_dtype="float32", microbatches=1)
    state = init_train_state(cfg, AdamW(learning_rate=1e-4),
                             torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for k in ("tokens", "labels")}
    batch["weights"] = torch.ones((2, 64))
    batch["weights"][0, :5] = 0.0
    grads, _ = make_grads_fn(cfg)(state.params, batch)
    exact = dict(leaves_with_path(cs.mamba2_f64_grads(state.params, batch,
                                                      cfg)))
    for path, g in leaves_with_path(grads):
        assert cs.rel_l2(g, exact[path]) <= 1e-4, "/".join(path)
