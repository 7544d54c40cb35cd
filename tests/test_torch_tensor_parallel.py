"""Tensor parallelism on CPU ranks (gloo), held against the reference's
single-device functions.

The reference gets its tensor parallelism from GSPMD through its
``shard(...)`` annotations (heads, kv heads, ffn and vocabulary over
``model``); the port splits each rank's blocks explicitly
(``runtime/sharding.py``, ``models/layers.py``, ``models/transformer.py``).
Each smoke config (granite_8b, minicpm_2b with tied embeddings,
internvl2_26b with its vision prefix, whisper_tiny with cross attention,
olmoe_1b_7b with attention split and experts expert-parallel on the same
axis, and granite_8b with a vocabulary of 255 that the axis does not
divide) runs on a ``("pod", "data", "model")`` mesh of model size 2 and
4 under ``rules_for(..., model_axis=<model size>)``, its parameters the
reference's (``PRNGKey(0)``) carried onto each rank's blocks by
``convert.from_reference_params``: the prefill's logits within 1e-5,
the greedy tokens identical, the gradients within 1e-4 relative L2 a
leaf and the loss within 1e-5 (the bars of PRs 24 and 26).  At model
size 4 the smoke's 2 kv heads do not divide the axis: training and
prefill replicate them, so each rank's kv projections get a part of
their gradient (summed over ``model`` by the train step), and decode
splits the cache's positions (``kv_seq``: the distributed flash-decode);
internvl2_26b's training splits the sequence between blocks
(``shard_activation_seq``: Megatron-SP).  The production rules'
sequence layouts run beside them: MiniCPM-2B's prefill over sequence
blocks, Granite-8B's decode over a sequence-split cache and Mamba2's
mixer over its heads, and every production cell's rules cut a rank's
blocks.  A tie across vocabulary blocks goes to the lower index.  Every
spawn has its own timeout; one spawn a model size runs every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_split_ranks as split
from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.runtime import serve_loop as ref_serve
from repro.runtime import train_loop as ref_train
from repro_torch import configs
from repro_torch.launch import mesh, shardspecs
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES
from repro_torch.runtime.sharding import (Rules, axis_size, live_dims,
                                          local_shape, sharding_context)

TIMEOUT_S = 180.0
ARCHS = ("granite_8b", "minicpm_2b", "internvl2_26b", "whisper_tiny",
         "olmoe_1b_7b")
ODD_VOCAB = "granite_8b-vocab255"
B, S, STEPS, MAX_LEN = 4, 8, 4, 32


def _configs(tag: str):
    arch = tag.split("-")[0]
    rcfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    if tag == ODD_VOCAB:
        rcfg = dataclasses.replace(rcfg, vocab_size=255)
        cfg = dataclasses.replace(cfg, vocab_size=255)
    return rcfg, cfg


_REFS: dict = {}


def _reference(tag: str) -> dict:
    """The case's inputs (NumPy, from a seed) and the reference's prefill
    logits, greedy tokens, gradients and metrics."""
    if tag in _REFS:
        return _REFS[tag]
    rcfg, cfg = _configs(tag)
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(len(tag))
    prompt = rng.integers(0, cfg.vocab_size, (B, S))
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = (rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)),
             "weights": np.ones((B, S), np.float32), **extras}
    batch["weights"][0, 3:] = 0.0
    rextras = {k: jnp.asarray(v) for k, v in extras.items()}
    logits, _ = ref_serve.make_prefill_step(rcfg, MAX_LEN)(
        rparams, jnp.asarray(prompt), rextras)
    tokens = ref_serve.greedy_generate(rcfg, rparams, jnp.asarray(prompt),
                                       STEPS, MAX_LEN, rextras)
    out = {"cfg": cfg, "params": jax.tree_util.tree_map(np.asarray, rparams),
           "prompt": prompt, "extras": extras, "batch": batch,
           "logits": np.asarray(logits), "tokens": np.asarray(tokens)}
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, metrics), grads = jax.value_and_grad(
        ref_train.make_loss_fn(rcfg), has_aux=True)(rparams, rbatch)
    out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    _REFS[tag] = out
    return out


def _spawn(tags, model: int, layouts: dict | None = None) -> dict:
    """Each of ``tags`` under the smoke config's own rules, and each
    ``{tag: (arch, {kind: rules})}`` of ``layouts`` under the given
    rules (:func:`torch_split_ranks.layout_cases`), in one spawn."""
    cases, more = [], []
    for tag in tags:
        r = _reference(tag)
        cases.append((tag, r["cfg"], r["params"], r["prompt"], r["extras"],
                      STEPS, MAX_LEN, r["batch"]))
    for tag, (arch, rules) in (layouts or {}).items():
        r = _reference(arch)
        more.append((tag, r["cfg"], r["params"], r["prompt"], r["extras"],
                     STEPS, MAX_LEN, r["batch"], rules))
    outs = mesh.spawn(split.split_cases, model, "cpu", cases, (1, 1, model),
                      more, timeout_s=TIMEOUT_S)
    tags = tuple(tags) + tuple(layouts or ())
    return {tag: [o[i] for o in outs] for i, tag in enumerate(tags)}


def _production(arch: str, kind: str) -> Rules:
    name = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    return shardspecs.rules_for(configs.get(arch), SHAPES[name])


#: The production rules' layouts beside the smoke rules' cases: the
#: odd-head archs' sequence split (MiniCPM-2B's prefill), the sequence
#: split with heads whole on an arch whose heads divide the axis, the
#: distributed flash-decode (Granite-8B's decode) and a Mamba2 mixer
#: over its heads.
LAYOUTS = {
    "minicpm_2b-seq": ("minicpm_2b",
                       {"prefill": _production("minicpm_2b", "prefill")}),
    "granite_8b-inner_seq": ("granite_8b", {"prefill": Rules(
        seq=("model",), inner_seq=("model",), heads=None, kv_heads=None,
        ffn=None, vocab=None, embed_p=("data", "model"))}),
    "granite_8b-kv_seq": ("granite_8b",
                          {"decode": _production("granite_8b", "decode")}),
    "mamba2_2p7b-heads": ("mamba2_2p7b",
                          {"prefill": _production("mamba2_2p7b", "prefill"),
                           "decode": _production("mamba2_2p7b", "decode")}),
}


@pytest.fixture(scope="module")
def model2():
    return _spawn(ARCHS + (ODD_VOCAB,), 2, LAYOUTS)


@pytest.fixture(scope="module")
def model4():
    return _spawn(ARCHS, 4)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


def _check_case(tag: str, ranks: list, odd_kv: bool) -> None:
    """Every rank's prefill logits, greedy tokens, gradients and metrics
    against the reference's (``odd_kv``: the decode ran over a cache split
    over its positions; it is held alike)."""
    ref = _reference(tag)
    for res in ranks:
        np.testing.assert_allclose(res["prefill"]["logits"][:, 0],
                                   ref["logits"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res["decode"]["tokens"],
                                      ref["tokens"])
        grads = res["train"]["grads"]
        assert set(grads) == {"/".join(p) for p, _ in
                              split.leaves_with_path(
                                  tfm.param_specs(ref["cfg"]))}
        for path, g in grads.items():
            assert _rel_l2(g, _leaf(ref["grads"], path)) <= 1e-4, path
        for k in ("loss", "tokens", "aux_loss"):
            np.testing.assert_allclose(res["train"]["metrics"][k],
                                       ref["metrics"][k], rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("tag", ARCHS + (ODD_VOCAB,))
def test_model_axis_of_two_matches_the_reference(tag, model2):
    """Heads, kv heads, ffn, vocabulary (and OLMoE's experts) over 2
    ranks: every rank's whole results equal the reference's."""
    _check_case(tag, model2[tag], odd_kv=False)


@pytest.mark.parametrize("tag", ARCHS)
def test_model_axis_of_four_matches_the_reference(tag, model4):
    """Over 4 ranks the 2 kv heads stay whole (odd kv): prefill and the
    kv projections' partial-sum gradients hold, and so does decode over a
    cache split over its positions (``kv_seq``)."""
    _check_case(tag, model4[tag], odd_kv=True)


def test_split_blocks_are_the_ranks_heads():
    """``local_params`` cuts whole heads, keeps a dim the axis does not
    divide whole (vocabulary 255, kv heads 2 over 4), and raises for a
    ``heads`` block that is not whole heads."""
    _, cfg = _configs(ODD_VOCAB)
    stand = _Mesh((1, 1, 2), (0, 0, 1))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rules = shardspecs.rules_for(cfg, SHAPES["prefill_32k"], model_axis=2)
    local = shardspecs.local_params(params, cfg, stand, rules)
    hd = cfg.head_dim
    assert local["blocks"]["wq"].shape[-1] == cfg.n_heads // 2 * hd
    assert local["blocks"]["wk"].shape[-1] == cfg.n_kv_heads // 2 * hd
    assert torch.equal(local["blocks"]["wo"],
                       params["blocks"]["wo"][:, 2 * hd:4 * hd])
    assert local["embed"]["table"] is params["embed"]["table"]   # odd V
    four = _Mesh((1, 1, 4), (0, 0, 3))
    rules4 = shardspecs.rules_for(cfg, SHAPES["prefill_32k"], model_axis=4)
    local4 = shardspecs.local_params(params, cfg, four, rules4)
    assert local4["blocks"]["wk"] is params["blocks"]["wk"]     # odd kv
    wide = dataclasses.replace(cfg, n_heads=2, head_dim=32)
    with pytest.raises(ValueError, match="whole heads"):
        shardspecs.local_params(
            tfm.init_params(wide, torch.Generator().manual_seed(0), "cpu"),
            wide, four, Rules(batch=(), kv_heads=None))


class _Mesh:
    """A stand-in with a ``DeviceMesh``'s names, sizes and coordinate."""

    def __init__(self, sizes, coordinate):
        self.mesh_dim_names = split.AXES
        self._sizes, self._coordinate = sizes, coordinate

    def size(self, i=None):
        return self._sizes[i]

    def get_coordinate(self):
        return self._coordinate


def test_a_tie_across_vocabulary_blocks_goes_to_the_lower_index():
    """Greedy decoding over a vocabulary split over 2 ranks: equal maxima
    in both blocks, in one block, at a block's edges, and none tied."""
    ties = [(3, 11), (9, 12), (0, 15), (8,), (7, 8)]
    outs = mesh.spawn(split.vocab_tie, 2, "cpu", (1, 1, 2), 16, ties,
                      timeout_s=TIMEOUT_S)
    assert outs[0] == outs[1] == [3, 9, 0, 8, 7]


def test_checkpoint_recompute_splits_on_autograd_s_own_thread():
    """A CUDA backward runs on autograd's own thread, outside the
    caller's sharding context; a checkpointed layer's recompute must
    split and gather as its forward did.  The backward run on a new
    thread gives the same gradients as on the caller's."""
    r = _reference("granite_8b")
    outs = mesh.spawn(split.backward_off_thread, 2, "cpu", r["cfg"],
                      r["params"], r["batch"], (1, 1, 2),
                      timeout_s=TIMEOUT_S)
    assert outs == [True, True]


# ------------------------------------------------ the production layouts
def test_odd_heads_prefill_splits_the_sequence(model2):
    """MiniCPM-2B's 36 heads on a 16-way axis: its prefill rules split
    the sequence (``seq`` and ``inner_seq``) over ``model``, heads whole;
    each rank's block of the positions gives the reference's logits."""
    rules = LAYOUTS["minicpm_2b-seq"][1]["prefill"]
    assert rules.seq == ("model",) and rules.inner_seq == ("model",)
    for res in model2["minicpm_2b-seq"]:
        np.testing.assert_allclose(res["prefill"]["logits"][:, 0],
                                   _reference("minicpm_2b")["logits"],
                                   rtol=1e-5, atol=1e-5)


def test_inner_seq_runs_with_seq_and_alone_raises(model2):
    """The sequence inside attention and the MLP split over the dims that
    split it between blocks runs (the reference's logits); split alone
    (the activations between blocks whole), it is no layout of
    ``rules_for`` and raises ``ValueError`` naming it."""
    for res in model2["granite_8b-inner_seq"]:
        np.testing.assert_allclose(res["prefill"]["logits"][:, 0],
                                   _reference("granite_8b")["logits"],
                                   rtol=1e-5, atol=1e-5)
    cfg = configs.get_smoke("granite_8b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with sharding_context(_Mesh((1, 1, 2), (0, 0, 1)),
                          Rules(inner_seq=("model",))):
        with pytest.raises(ValueError, match="inner_seq over mesh dims"):
            tfm.forward(params, cfg,
                        tokens=torch.zeros((1, 4), dtype=torch.long))


def test_kv_seq_decode_matches_the_reference(model2):
    """Granite-8B's 8 kv heads on a 16-way axis: its decode rules split
    the cache's positions (the distributed flash-decode), as
    ``long_500k``'s do over ``("pod", "data")``; the greedy tokens are
    the reference's."""
    rules = LAYOUTS["granite_8b-kv_seq"][1]["decode"]
    assert rules.kv_seq == ("model",)
    assert shardspecs.rules_for(configs.get("granite_8b"),
                                SHAPES["long_500k"]).kv_seq == ("pod",
                                                                "data")
    for res in model2["granite_8b-kv_seq"]:
        np.testing.assert_array_equal(res["decode"]["tokens"],
                                      _reference("granite_8b")["tokens"])


def test_mamba_heads_over_model_match_the_reference(model2):
    """A Mamba2 mixer's heads over ``model`` (the ssm and hybrid
    families): prefill logits and greedy tokens (through
    ``relayout_decode_state`` too) the reference's."""
    rules = LAYOUTS["mamba2_2p7b-heads"][1]["prefill"]
    assert rules.heads == ("model",)
    ref = _reference("mamba2_2p7b")
    for res in model2["mamba2_2p7b-heads"]:
        np.testing.assert_allclose(res["prefill"]["logits"][:, 0],
                                   ref["logits"], rtol=1e-5, atol=1e-5)
        for kind in ("decode", "relayout"):
            np.testing.assert_array_equal(res[kind]["tokens"],
                                          ref["tokens"])


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_every_production_cell_builds_a_rank_s_blocks(arch):
    """Every shape of ``shapes_for`` at 256 and 512 chips: the production
    rules cut the smoke parameters into a rank's blocks of whole heads
    (``local_params``) and size its decode state
    (``decode_state_shardings``, ``init_decode_state``) on a model-size-2
    mesh, each block the whole leaf over its ranks."""
    from repro_torch.models.config import shapes_for
    cfg = configs.get_smoke(arch)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stand = _Mesh((1, 1, 2), (0, 0, 1))
    for shape in shapes_for(configs.get(arch)):
        for size in (256, 512):
            rules = shardspecs.rules_for(configs.get(arch), SHAPES[shape],
                                         mesh_size=size)
            specs = shardspecs.param_shardings(cfg, stand, rules)
            local = shardspecs.local_params(params, cfg, stand, rules)
            for path, t in split.leaves_with_path(local):
                whole = params
                spec = specs
                for key in path:
                    whole, spec = whole[key], spec[key]
                assert tuple(t.shape) == local_shape(whole.shape, spec,
                                                     stand), path
            meta = tfm._decode_state(cfg, 4, MAX_LEN, torch.device("meta"))
            state_specs = shardspecs.decode_state_shardings(cfg, stand,
                                                            rules, meta)
            with sharding_context(stand, rules):
                state = tfm.init_decode_state(cfg, 4, MAX_LEN, "cpu")
            for (path, t), (_, spec) in zip(
                    split.leaves_with_path(_tensors_of(state)),
                    split.leaves_with_path(_tensors_of(state_specs,
                                                       meta))):
                want = local_shape(_at(meta, path).shape, spec, stand)
                assert tuple(t.shape) == want, (shape, size, path)
            if cfg.family != "ssm":
                k = state["k"] if "k" in state else state["kv"]["k"]
                n = axis_size(stand, live_dims(stand, rules.mesh_axes(
                    "kv_seq", stand)))
                assert k.shape[2] == MAX_LEN // n
                assert n == (2 if rules.kv_seq == ("model",) else 1)


def _tensors_of(tree, like=None):
    """``tree``'s tensor leaves (or, with ``like``, the leaves of ``tree``
    where ``like`` holds a tensor) as a nested dict of path keys."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return {k: _tensors_of(tree[k], v) for k, v in like.items()
                if _tensors_of(tree[k], v) != {}}
    if isinstance(like, tuple):
        return {str(i): _tensors_of(t, v) for i, (t, v) in
                enumerate(zip(tree, like))}
    return tree if isinstance(like, torch.Tensor) else {}


def _at(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, tuple) else tree[key]
    return tree
