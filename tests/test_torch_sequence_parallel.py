"""The sequence layouts on CPU ranks (gloo), held against the reference's
single-device functions: Megatron-SP, the odd-head archs' sequence split
and the distributed flash-decode over a sequence-split KV cache.

The reference gets these layouts from GSPMD through its ``shard(...)``
annotations (``seq``, ``inner_seq``, ``kv_seq``); the port runs each
rank's block of the positions with explicit collectives
(``runtime/sharding.py``, ``models/layers.py``).  Each smoke config that
takes one of them in production (minicpm_2b and whisper_tiny: 36 and 6
heads on a 16-way axis, ``seq`` and ``inner_seq`` for training and
prefill, ``kv_seq`` for decode; internvl2_26b: Megatron-SP training with
its vision prefix, ``kv_seq`` decode; granite_8b: ``kv_seq`` decode after
a prefill with its kv heads whole) runs under the production rules
``rules_for(configs.get(arch), shape, mesh_size=256 or 512)`` bound on a
``("pod", "data", "model")`` mesh of model size 2 and 4, its parameters
the reference's (``PRNGKey(0)``) carried onto each rank's blocks: the
prefill's logits within 1e-5, the greedy tokens identical (decoded under
the decode rules, and after a prefill under the prefill rules carried
across by ``relayout_decode_state``; a 20-position cache, so that a rank's
block is empty at some steps and the cursor crosses a block boundary),
the gradients within 1e-4 relative L2 a leaf and the loss within 1e-5.
K6's log-sum-exp entry and the cross-rank combine are held against
``decode_attention_ref``.  One spawn a model size runs every case.
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
from repro_torch.kernels.decode_attention import (combine_over_ranks,
                                                  decode_attention,
                                                  decode_attention_lse)
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_ref)
from repro_torch.launch import mesh
from repro_torch.launch.shardspecs import rules_for
from repro_torch.models.config import SHAPES

TIMEOUT_S = 240.0
ARCHS = ("minicpm_2b", "whisper_tiny", "internvl2_26b", "granite_8b")
B, S, STEPS, MAX_LEN = 4, 8, 4, 20
#: The production cells each kind takes its rules from.
CELLS = {"prefill": ("prefill_32k", 256), "decode": ("decode_32k", 256),
         "train": ("train_4k", 512)}


def production_rules(arch: str, cells: dict = CELLS) -> dict:
    cfg = configs.get(arch)
    return {kind: rules_for(cfg, SHAPES[name], mesh_size=size)
            for kind, (name, size) in cells.items()}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return np.asarray(tree)


_REFS: dict = {}


def reference(arch: str, batch_size: int = B, **overrides) -> dict:
    """The case's inputs (NumPy, from a seed) and the reference's prefill
    logits, greedy tokens, gradients and metrics at the smoke config
    (with ``overrides`` of its fields in both packages)."""
    key = (arch, batch_size, tuple(sorted(overrides.items())))
    if key in _REFS:
        return _REFS[key]
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch), **overrides)
    cfg = dataclasses.replace(configs.get_smoke(arch), **overrides)
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(len(arch))
    prompt = rng.integers(0, cfg.vocab_size, (batch_size, S))
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = (rng.standard_normal(
            (batch_size, cfg.n_prefix_embeds, cfg.d_model)) * 0.1
        ).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = (rng.standard_normal(
            (batch_size, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, S)),
             "labels": rng.integers(0, cfg.vocab_size, (batch_size, S)),
             "weights": np.ones((batch_size, S), np.float32), **extras}
    batch["weights"][0, 3:] = 0.0
    rextras = {k: jnp.asarray(v) for k, v in extras.items()}
    logits, _ = ref_serve.make_prefill_step(rcfg, MAX_LEN)(
        rparams, jnp.asarray(prompt), rextras)
    tokens = ref_serve.greedy_generate(rcfg, rparams, jnp.asarray(prompt),
                                       STEPS, MAX_LEN, rextras)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, metrics), grads = jax.value_and_grad(
        ref_train.make_loss_fn(rcfg), has_aux=True)(rparams, rbatch)
    out = {"cfg": cfg, "params": jax.tree_util.tree_map(np.asarray, rparams),
           "prompt": prompt, "extras": extras, "batch": batch,
           "logits": np.asarray(logits), "tokens": np.asarray(tokens),
           "grads": jax.tree_util.tree_map(np.asarray, grads),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    _REFS[key] = out
    return out


def case(arch: str, rules: dict, tag=None, batch_size: int = B,
         **overrides) -> tuple:
    r = reference(arch, batch_size, **overrides)
    return (tag or arch, r["cfg"], r["params"], r["prompt"], r["extras"],
            STEPS, MAX_LEN, r["batch"], rules)


def spawn(cases: list, shape: tuple, *more: tuple) -> dict:
    """:func:`torch_split_ranks.layout_cases` of ``cases`` on a mesh of
    ``shape``, and of each further ``(shape, cases)`` of ``more`` (as many
    ranks), in one spawn: each case's results on every rank, by tag."""
    groups = [(shape, cases)] + list(more)
    outs = mesh.spawn(split.layout_groups, int(np.prod(shape)), "cpu",
                      groups, timeout_s=TIMEOUT_S)
    tags = [c[0] for _, cs in groups for c in cs]
    return {tag: [o[i] for o in outs] for i, tag in enumerate(tags)}


def check_prefill(ranks: list, ref: dict) -> None:
    for res in ranks:
        np.testing.assert_allclose(res["prefill"]["logits"][:, 0],
                                   ref["logits"], rtol=1e-5, atol=1e-5)


def check_decode(ranks: list, ref: dict) -> None:
    for res in ranks:
        for kind in ("decode", "relayout"):
            if kind in res:
                np.testing.assert_array_equal(res[kind]["tokens"],
                                              ref["tokens"])


def check_train(ranks: list, ref: dict) -> None:
    from repro_torch.models import transformer as tfm
    for res in ranks:
        grads = res["train"]["grads"]
        assert set(grads) == {"/".join(p) for p, _ in
                              split.leaves_with_path(
                                  tfm.param_specs(ref["cfg"]))}
        for path, g in grads.items():
            assert rel_l2(g, leaf(ref["grads"], path)) <= 1e-4, path
        for k in ("loss", "tokens"):
            np.testing.assert_allclose(res["train"]["metrics"][k],
                                       ref["metrics"][k], rtol=1e-5,
                                       atol=1e-7)


@pytest.fixture(scope="module")
def model2():
    return spawn([case(a, production_rules(a)) for a in ARCHS], (1, 1, 2))


@pytest.fixture(scope="module")
def model4():
    return spawn([case(a, production_rules(a)) for a in ARCHS], (1, 1, 4))


def test_the_production_rules_take_the_sequence_layouts():
    """What the cases run: ``seq`` and ``inner_seq`` (odd heads), ``seq``
    alone with heads over ``model`` (InternVL2's Megatron-SP), and
    ``kv_seq`` for every decode."""
    for arch in ("minicpm_2b", "whisper_tiny"):
        r = production_rules(arch)
        assert r["prefill"].seq == r["prefill"].inner_seq == ("model",)
        assert r["train"].seq == ("model",) and r["train"].heads is None
        assert r["decode"].kv_seq == ("model",)
    r = production_rules("internvl2_26b")
    assert r["train"].seq == ("model",) and r["train"].inner_seq is None
    assert r["train"].heads == ("model",)
    for arch in ("internvl2_26b", "granite_8b"):
        r = production_rules(arch)
        assert r["decode"].kv_seq == ("model",) and r["decode"].heads is None
        assert r["prefill"].kv_heads is None and r["prefill"].kv_seq is None


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


# ---------------------------------------------------------- K6's lse entry
def _cache(seed: int, b: int, s: int, hq: int, hkv: int, d: int):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hq, d, generator=g),
            torch.randn(b, s, hkv, d, generator=g),
            torch.randn(b, s, hkv, d, generator=g))


@pytest.mark.parametrize("d", [16, 64, 80])
def test_k6_lse_entry_matches_the_oracle(d):
    """The plain version of ``decode_attention_lse``: its output equal to
    ``decode_attention``'s, both to ``decode_attention_ref`` at 1e-6, and
    each row's log-sum-exp the logsumexp of its scaled scores; a row with
    no live position gives 0 and ``NEG_INF``, never NaN."""
    q, k, v = _cache(d, 4, 96, 8, 2, d)
    kv_len = torch.tensor([0, 1, 37, 96], dtype=torch.int32)
    out, lse = decode_attention_lse(q, k, v, kv_len, block_k=32)
    assert out.dtype == lse.dtype == torch.float32
    assert torch.isfinite(out).all() and not torch.isnan(lse).any()
    torch.testing.assert_close(out, decode_attention(q, k, v, kv_len,
                                                     block_k=32),
                               rtol=0, atol=0)
    torch.testing.assert_close(out[1:], decode_attention_ref(
        q, k, v, kv_len)[1:], rtol=1e-6, atol=1e-6)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert (lse[0] == NEG_INF).all()
    kg = k.repeat_interleave(4, dim=2)
    for row in (1, 2, 3):
        n = int(kv_len[row])
        sc = torch.einsum("hd,shd->hs", q[row], kg[row, :n]) / d ** 0.5
        torch.testing.assert_close(lse[row], torch.logsumexp(sc, -1),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_combine_over_ranks_is_the_whole_cache_s_decode(n):
    """A cache cut into ``n`` blocks, each decoded with its own ``kv_len``
    (empty blocks too), combined by log-sum-exp in rank order: the whole
    cache's ``decode_attention_ref`` at 1e-6."""
    q, k, v = _cache(n, 3, 64, 4, 4, 32)
    kv_len = torch.tensor([1, 33, 64], dtype=torch.int32)
    blk = 64 // n
    parts = [decode_attention_lse(
        q, k[:, r * blk:(r + 1) * blk], v[:, r * blk:(r + 1) * blk],
        torch.clamp(kv_len - r * blk, 0, blk).to(torch.int32))
        for r in range(n)]
    got = combine_over_ranks(torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]))
    torch.testing.assert_close(got, decode_attention_ref(q, k, v, kv_len),
                               rtol=1e-6, atol=1e-6)
