"""FSDP storage (ZeRO-3) on CPU ranks (gloo), alone and beside tensor
parallelism, held against the reference's single-device functions.

Every layout of ``rules_for`` stores parameters over ``data``
(``embed_p``): each rank keeps its block, each layer gathers its leaves
whole where it starts (inside the checkpoint) and reduce-scatters their
gradients (``runtime/sharding.py``'s ``gather_param``).  On a ``("pod",
"data", "model") = (1, 2, 2)`` mesh, granite_8b's smoke config takes 3
AdamW steps from the reference's initial state (``PRNGKey(0)``, carried
over by ``convert``) under the pure-DP ZeRO-3 rules (batch and storage
over all four ranks) and under the tensor-parallel rules (heads, ffn and
vocabulary over ``model``, storage over ``data``): the losses within 1e-5
of the reference's ``make_train_step`` and every parameter within 1e-4
relative L2 after them, the clip's ``global_norm`` the whole model's.
Then a sharded save (each rank its blocks) is byte-equal to a one-rank
save of the same state, restores into either layout, and an elastic
resize takes the ZeRO-3 state to one rank, whose next step is the
reference's.  Serving and one batch's gradients on the same mesh (batch
over ``data``, FSDP gathers, heads over ``model``) hold against the
reference for the dense (also with tied embeddings), the VLM (its
vision projection stored over ``data``) and the encoder-decoder smoke
configs.  Every spawn has its own timeout.
"""

import math

import jax
import numpy as np
import pytest

import torch_split_ranks as split
from repro import configs as ref_configs
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_loop
from repro_torch import configs
from repro_torch.convert import from_reference_train_state
from repro_torch.launch import mesh
from repro_torch.optim.adamw import global_norm
from test_torch_tensor_parallel import (MAX_LEN, STEPS, _check_case,
                                        _reference, _rel_l2)

TIMEOUT_S = 180.0
SHAPE = (1, 2, 2)
ARCH, LR, BATCH, SEQ = "granite_8b", 3e-3, 8, 16


def _batches(cfg) -> list:
    rng = np.random.default_rng(7)
    out = [{"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
            "weights": np.ones((BATCH, SEQ), np.float32)}
           for _ in range(3)]
    out[0]["weights"][:2, 5:] = 0.0      # a light shard
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's 3 steps from its initial state and a fourth on the
    first batch again: losses, gradient norms and the parameters after
    the third."""
    rcfg = ref_configs.get_smoke(ARCH)
    ropt = ref_adamw.AdamW(learning_rate=LR)
    rstate = ref_loop.init_train_state(jax.random.PRNGKey(0), rcfg, ropt)
    start = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), configs.get_smoke(ARCH),
        device="cpu")
    step = jax.jit(ref_loop.make_train_step(rcfg, ropt))
    batches = _batches(rcfg)
    losses, norms, params = [], [], None
    for b in batches + batches[:1]:
        rstate, m = step(rstate, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if len(losses) == 3:
            params = jax.tree_util.tree_map(np.asarray, rstate.params)
    return {"start": start, "batches": batches, "losses": losses,
            "norms": norms, "params": params}


@pytest.fixture(scope="module", params=["dp", "tp"])
def zero3(request, reference, tmp_path_factory):
    kind = request.param
    d = tmp_path_factory.mktemp(f"ckpt_{kind}")
    outs = mesh.spawn(split.zero3_steps, math.prod(SHAPE), "cpu",
                      configs.get_smoke(ARCH), reference["start"],
                      reference["batches"], SHAPE, kind, LR, str(d / "c"),
                      timeout_s=TIMEOUT_S)
    return kind, outs, d


def test_three_steps_match_the_reference(zero3, reference):
    """ZeRO-3 (``dp``: every leaf stored over ``("data", "model")``) and
    tensor parallelism with FSDP storage (``tp``): losses and gradient
    norms 1e-5, every parameter 1e-4 relative L2, on every rank."""
    kind, outs, _ = zero3
    cfg = configs.get_smoke(ARCH)
    for o in outs:
        np.testing.assert_allclose(o["losses"], reference["losses"][:3],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["norms"], reference["norms"][:3],
                                   rtol=1e-5)
        for path, p in o["whole"].items():
            want = reference["params"]
            for key in path.split("/"):
                want = want[key]
            assert _rel_l2(p, want) <= 1e-4, path
    # The blocks really are split: a quarter (dp) or a half of the
    # embedding's d_model, and a half of the heads' columns (tp).
    d = cfg.d_model
    blocks = outs[0]["blocks"]
    if kind == "dp":
        assert blocks["embed/table"] == (cfg.vocab_size, d // 4)
        assert blocks["blocks/wq"] == (cfg.n_layers, d // 4,
                                       cfg.n_heads * cfg.head_dim)
    else:
        assert blocks["embed/table"] == (cfg.vocab_size // 2, d // 2)
        assert blocks["blocks/wq"] == (cfg.n_layers, d // 2,
                                       cfg.n_heads * cfg.head_dim // 2)


def test_sharded_save_is_a_one_rank_save(zero3):
    """The ranks' blocks, saved by every rank with the specs, write the
    same bytes as one rank's save of the gathered state, and restore into
    the ZeRO-3 layout and the tensor-parallel one alike."""
    _, outs, d = zero3
    a = (d / "c" / "step_0000000001.npz").read_bytes()
    b = (d / "c" / "step_0000000002.npz").read_bytes()
    assert a == b
    assert all(o["restored_equal"] == [True, True] for o in outs)


def test_resize_from_zero3_to_one_rank(zero3, reference):
    """``ElasticController.resize(..., mesh=)``: the four ranks' blocks are
    gathered, rank 0 alone restores them whole, and its next step is the
    reference's fourth."""
    _, outs, _ = zero3
    cfg = configs.get_smoke(ARCH)
    assert [o["resized_shapes"] is None for o in outs] == [False, True,
                                                           True, True]
    assert outs[0]["resized_shapes"]["embed/table"] == (cfg.vocab_size,
                                                        cfg.d_model)
    np.testing.assert_allclose(outs[0]["after_resize"],
                               reference["losses"][3], rtol=1e-5)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_global_norm_of_blocks_is_the_whole_trees(kind, reference):
    """Each rank's blocks' squares, all-reduced over the dims that split
    each leaf (a replicated leaf counted once), give the whole tree's
    norm on every rank."""
    cfg = configs.get_smoke(ARCH)
    params = {g: {k: v.detach().numpy() for k, v in node.items()}
              for g, node in reference["start"].params.items()}
    got = mesh.spawn(split.norm_of_blocks, math.prod(SHAPE), "cpu", cfg,
                     params, SHAPE, kind, timeout_s=TIMEOUT_S)
    want = float(global_norm(reference["start"].params))
    assert got == [got[0]] * 4
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


#: OLMoE is not among them: over a batch split its expert-parallel
#: dispatch routes each data shard alone (capacity and drops per shard),
#: as the reference's ``shard_map`` does, which its single-device
#: functions do not.
SERVED = ("granite_8b", "minicpm_2b", "internvl2_26b", "whisper_tiny")


@pytest.fixture(scope="module")
def served():
    cases = []
    for tag in SERVED:
        r = _reference(tag)
        cases.append((tag, r["cfg"], r["params"], r["prompt"], r["extras"],
                      STEPS, MAX_LEN, r["batch"]))
    outs = mesh.spawn(split.split_cases, math.prod(SHAPE), "cpu", cases,
                      SHAPE, timeout_s=TIMEOUT_S)
    return {tag: [o[i] for o in outs] for i, tag in enumerate(SERVED)}


@pytest.mark.parametrize("tag", SERVED)
def test_serving_and_gradients_with_fsdp_storage(tag, served):
    """Batch over ``data``, parameters stored over ``data`` and gathered
    on use, heads, ffn and vocabulary over ``model``, the decode cache at
    each rank's rows and kv heads: prefill logits 1e-5, greedy tokens
    identical, gradients 1e-4 a leaf, loss 1e-5."""
    _check_case(tag, served[tag], odd_kv=False)
