"""Data-parallel training and the elastic resize on CPU ranks (gloo),
held against the reference and against one rank of the port.

Data parallelism (``runtime/train_loop.py``): each rank takes its shard
of each microbatch and the gradients are summed over the batch ranks,
the loss normalized by the global weight sum.  The reference's data
parallelism is GSPMD over one program, so its gradient is the whole
batch's: the ranks' gradients are held against the reference's gradient
of the whole batch at the same parameters (the reference's initial
state, carried over by ``convert.from_reference_train_state``; 1e-4
relative L2 a leaf, loss and tokens 1e-5, the bars of
``test_torch_train.py::test_train_step_matches_reference``) and against
the port's own single rank (1e-5), with ranks of unequal weight, with and
without microbatches, on a ``("pod",)`` and a ``("pod", "data")`` mesh.
OLMoE's smoke config at its capacity factor of 1.25 runs the dense MoE
dispatch under data parallelism (no expert axis): its capacity, drops
and aux loss must be the whole batch's, as the reference's are.

The elastic flow (``runtime/elastic.py``) is the reference's
``examples/elastic_training.py`` on ``granite_8b``'s smoke config: 2 pods
-> 1 (``dpm-poweroff``) -> 2 (``dpm-poweron``), then ``recover``; every
restored leaf equals the saved one bit for bit (the AdamW moments, the
step and the data cursor with it), every rank of the new mesh holds the
same bits, the 9 losses follow the reference's ``make_train_step`` on the
same whole batches from the same state within 1e-5 relative, and the
reference example's own assertions hold.  Every spawn has its own
timeout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import configs as ref_configs
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.optim import adamw as ref_adamw
from repro.runtime import train_loop as ref_loop
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import from_reference_train_state
from repro_torch.launch import mesh, shardspecs
from repro_torch.runtime.train_loop import make_grads_fn

TIMEOUT_S = 120.0
ARCH = "granite_8b"
STEPS, LR, BATCH, SEQ = 3, 3e-3, 8, 32


def _reference_start(arch: str, microbatches: int = 1, lr: float = LR):
    """The reference's config, AdamW, initial train state (PRNGKey 0), and
    the port's config and copy of that state on the CPU."""
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                               microbatches=microbatches)
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              microbatches=microbatches)
    ropt = ref_adamw.AdamW(learning_rate=lr)
    rstate = ref_loop.init_train_state(jax.random.PRNGKey(0), rcfg, ropt)
    state = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, device="cpu")
    return rcfg, ropt, rstate, cfg, state


def _ref_grads(rcfg, params, batch):
    """The reference's gradient of the whole batch
    (``train_loop.py:101-136``): one ``value_and_grad``, or the
    token-weighted sum over microbatches."""
    loss_fn = ref_loop.make_loss_fn(rcfg)
    k = max(rcfg.microbatches, 1)
    mbs = [{key: jnp.split(v, k)[i] for key, v in batch.items()}
           for i in range(k)]
    gsum, loss_sum, tok_sum = None, 0.0, 0.0
    for mb in mbs:
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, mb)
        tok = metrics["tokens"]
        scaled = jax.tree_util.tree_map(lambda g: g * tok, grads)
        gsum = scaled if gsum is None else jax.tree_util.tree_map(
            jnp.add, gsum, scaled)
        loss_sum += metrics["loss"] * tok
        tok_sum += tok
    tok = max(float(tok_sum), 1.0)
    return (jax.tree_util.tree_map(lambda g: g / tok, gsum),
            {"loss": float(loss_sum / tok), "tokens": float(tok_sum)})


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch,shape,axes,microbatches", [
    (ARCH, (2,), ("pod",), 1), (ARCH, (2, 2), ("pod", "data"), 2),
    ("olmoe_1b_7b", (2,), ("pod",), 1), ("olmoe_1b_7b", (2,), ("pod",), 2)],
    ids=["pod2", "pod2xdata2-mb2", "olmoe-pod2", "olmoe-pod2-mb2"])
def test_data_parallel_gradients_equal_one_rank(arch, shape, axes,
                                                microbatches):
    """Each rank's shard has its own loss weights (one rank's mostly
    zero): the summed gradient, normalized by the global weight sum,
    equals the reference's and one port rank's on the whole batch."""
    rcfg, _, rstate, cfg, state = _reference_start(arch, microbatches)
    n = int(np.prod(shape))
    rng = np.random.default_rng(n + microbatches)
    b = 4 * n // 2 * microbatches
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, SEQ)),
             "labels": rng.integers(0, cfg.vocab_size, (b, SEQ)),
             "weights": np.ones((b, SEQ), np.float32)}
    batch["weights"][:b // n // microbatches, 3:] = 0.0   # a light shard
    outs = mesh.spawn(ranks.data_parallel_grads, n, "cpu", cfg,
                      state.params, batch, shape, axes, timeout_s=TIMEOUT_S)
    rgrads, rm = _ref_grads(rcfg, rstate.params, {
        k: jnp.asarray(v, jnp.int32 if k != "weights" else jnp.float32)
        for k, v in batch.items()})
    want, wm = make_grads_fn(cfg)(state.params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for o in outs:
        assert o["grads"].keys() == {"/".join(p) for p, _ in
                                     ranks.leaves_with_path(want)}
        for p, g in ranks.leaves_with_path(want):
            got = o["grads"]["/".join(p)]
            assert _rel_l2(got, _ref_leaf(rgrads, p)) <= 1e-4, p
            np.testing.assert_allclose(got, g.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(g.abs().max()))
        np.testing.assert_array_equal(
            np.concatenate([v.ravel() for v in o["grads"].values()]),
            np.concatenate([v.ravel() for v in outs[0]["grads"].values()]))
        assert o["metrics"]["tokens"] == float(wm["tokens"]) == rm["tokens"]
        for want_loss in (float(wm["loss"]), rm["loss"]):
            np.testing.assert_allclose(o["metrics"]["loss"], want_loss,
                                       rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_elastic_resize_two_one_two_and_recover(world, tmp_path):
    rcfg, ropt, rstate, cfg, state = _reference_start(ARCH)
    outs = mesh.spawn(ranks.elastic, world, "cpu", cfg, state,
                      str(tmp_path), STEPS, LR, BATCH, SEQ,
                      timeout_s=TIMEOUT_S)
    lead = outs[0]
    assert lead["history"] == [
        (STEPS, 2, 1, "dpm-poweroff"), (2 * STEPS, 1, 2, "dpm-poweron"),
        (2 * STEPS, -1, 2, "failure")]
    assert lead["restored_equal"] == [True, True]
    assert lead["recovered_equal"] is True
    assert lead["recover_step"] == 2 * STEPS
    assert lead["cursors"] == [{"seed": 1, "step": STEPS},
                               {"seed": 1, "step": 2 * STEPS}]
    per_pod = world // 2
    for r, o in enumerate(outs):
        in_one_pod = r < per_pod
        # After 2 -> 1 only the first pod holds the state, after 1 -> 2
        # every rank, each the same bits.
        assert (o["digests"][0] is not None) == in_one_pod
        if in_one_pod:
            assert o["digests"][0] == lead["digests"][0]
        assert o["digests"][1] == lead["digests"][1]
        assert o["recovered_equal"] is True
        assert o["coordinate"] == (r // per_pod, r % per_pod)
    # The reference's train step, unresized, on the whole batches of the
    # same stream from the same state.
    step = jax.jit(ref_loop.make_train_step(rcfg, ropt))
    data = RefTokens(rcfg.vocab_size, SEQ, BATCH, seed=1)
    want = []
    for _ in range(3 * STEPS):
        b = data.next_batch()
        rstate, m = step(rstate, {"tokens": b.tokens, "labels": b.labels,
                                  "weights": b.weights})
        want.append(float(m["loss"]))
    got = [x for phase in lead["losses"] for x in phase]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    l1, l2, l3 = lead["losses"]
    assert l2[0] < l1[0], "training state survived the resize"
    assert l3[-1] < l1[0]


def test_restore_onto_a_meta_target_takes_the_device(tmp_path):
    """``Checkpointer.restore(..., device=)`` puts a meta target's leaves
    on the device, bf16 leaves through their int16 view bit for bit."""
    cfg, opt, state, _ = ranks._train_setup(ARCH, LR, BATCH, SEQ)
    state.params["final_norm"]["scale"] = (
        state.params["final_norm"]["scale"].detach().to(torch.bfloat16)
        .requires_grad_(True))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    from repro_torch.runtime.elastic import _abstract
    target = _abstract(state)
    assert target.params["embed"]["table"].device.type == "meta"
    back = ck.restore(3, target, device="cpu")
    assert ranks.digest(back) == ranks.digest(state)
    assert back.params["final_norm"]["scale"].dtype == torch.bfloat16
    abstract = shardspecs.abstract_train_state(cfg)
    abstract.step = 0
    again = ck.restore(3, abstract, device="cpu")
    assert again.step == state.step


class _Mesh:
    """A stand-in with a ``DeviceMesh``'s names, sizes and coordinate."""

    def __init__(self, names, sizes, coordinate):
        self.mesh_dim_names, self._sizes = names, sizes
        self._coordinate = coordinate

    def size(self, i):
        return self._sizes[i]

    def get_coordinate(self):
        return self._coordinate


def test_batch_split_takes_the_batch_axes_under_every_layout():
    """The split runs over the batch's mesh dims larger than 1, at this
    rank's row-major position (``pod`` the slowest).  A gradient spec that
    shards a leaf (FSDP storage, tensor parallelism) is taken: those
    gradients are reduced by ``grad_reductions``.  So is every sequence
    layout and a Mamba2 mixer's heads over ``model``: ``seq``,
    ``inner_seq`` or ``kv_seq`` over a mesh dim larger than 1 leave the
    batch's split as it is."""
    from repro_torch.runtime.sharding import Rules, sharding_context
    from repro_torch.runtime.train_loop import batch_split

    assert batch_split() is None
    m = _Mesh(("pod", "data", "model"), (2, 3, 2), (1, 2, 0))
    with sharding_context(m, Rules()):
        assert batch_split()[1:] == (("pod", "data"), 5, 6)
        for spec in ((("data",), None), (None, "model"), (None, None)):
            assert batch_split({"blocks": {"w": spec}})[1:] == (
                ("pod", "data"), 5, 6)
        assert batch_split(None, configs.get_smoke(ARCH))[3] == 6
        assert batch_split(None, configs.get_smoke("mamba2_2p7b"))[1:] == (
            ("pod", "data"), 5, 6)
    for name in ("seq", "inner_seq", "kv_seq"):
        with sharding_context(m, Rules(**{name: ("model",)})):
            assert batch_split()[1:] == (("pod", "data"), 5, 6)
    with sharding_context(m, Rules(seq=("model",), heads=None)):
        assert batch_split({"blocks": {"w": (None, None)}})[3] == 6
    one = _Mesh(("pod", "data", "model"), (2, 3, 1), (1, 2, 0))
    with sharding_context(one, Rules(seq=("model",), kv_seq=("model",))):
        assert batch_split(None, configs.get_smoke("zamba2_7b"))[3] == 6
    with sharding_context(_Mesh(("pod", "data"), (1, 1), (0, 0)), Rules()):
        assert batch_split() is None


def test_resize_and_restore_go_into_and_out_of_the_sequence_layouts(
        tmp_path):
    """MiniCPM-2B's smoke state on ``(1, 1, 2)`` under the tensor-parallel
    rules and under its production training rules (the sequence split
    over ``model``, FSDP storage over ``data`` and ``model``): a step
    under each gives one rank's loss (1e-5), a sharded save restores into
    either layout bit for bit, and an elastic resize to one rank and back
    lands in the other layout bit for bit."""
    import torch_split_ranks as split
    from repro_torch.models.config import SHAPES
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import make_train_step

    cfg, _, state, data = ranks._train_setup("minicpm_2b", LR, 4, 16)
    b = data.next_batch()
    seq = shardspecs.rules_for(configs.get("minicpm_2b"), SHAPES["train_4k"],
                               mesh_size=512)
    tp = shardspecs.rules_for(dataclasses.replace(cfg, parallelism="tp"),
                              SHAPES["train_4k"], model_axis=2, mesh_size=2)
    assert seq.seq == seq.inner_seq == ("model",) and tp.heads == ("model",)
    batch = {"tokens": b.tokens.numpy(), "labels": b.labels.numpy(),
             "weights": b.weights.numpy()}
    outs = mesh.spawn(split.layout_resize, 2, "cpu", cfg, state, batch,
                      (1, 1, 2), [("tp", tp), ("seq", seq)], str(tmp_path),
                      LR, timeout_s=TIMEOUT_S)
    _, metrics = make_train_step(cfg, AdamW(learning_rate=LR))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for o in outs:
        assert o["restored_equal"] == [True] * 4
        assert o["resized_equal"] == [True] * 2
        np.testing.assert_allclose(o["losses"], [float(metrics["loss"])] * 2,
                                   rtol=1e-5)
