"""The ``vlm`` family (InternVL2-26B's vision prefix): the port against the
JAX reference, on the CPU.

The reference's smoke parameters (``init_params(PRNGKey(0), ...)``) are
carried across with ``convert.from_reference_params``; the prompts, the
patch embeddings (float32, 0.1 a standard normal, as ``launch.inputs``
draws them) and the training batches are drawn with NumPy from a seed and
handed to both packages.  Attention runs on the plain versions of K4, K5
and K6 here.  Tolerances, all in float32: hidden states and logits 1e-5,
greedy tokens identical, the loss 1e-5 and each gradient leaf 1e-4
relative L2 (``tests/test_torch_train_families.py``'s bar).  The
reference's decode step rotates a prefixed prompt's new tokens by
positions short of their cache rows (ROADMAP fault F3); the port keeps
those positions, and a test pins the fault in both.
"""

import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import inputs as ref_inputs
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tfm
from repro.models.config import SHAPES as REF_SHAPES
from repro.runtime import serve_loop as ref_loop
from repro.runtime import train_loop as ref_train
from repro_torch import configs
from repro_torch.convert import from_reference_params
from repro_torch.launch import inputs, serve, train
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import leaves_with_path

ARCH = "internvl2_26b"
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _specs_tree(specs):
    """A spec tree as nested dicts of ``(shape, axes)`` tuples."""
    return {k: _specs_tree(v) if isinstance(v, dict)
            else (tuple(v[0]), tuple(v[1])) for k, v in specs.items()}


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg = ref_configs.get_smoke(ARCH)
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = configs.get_smoke(ARCH)
    params = from_reference_params(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


def _prefix(cfg, rng, b):
    ve = (rng.standard_normal((b, cfg.n_prefix_embeds, cfg.d_model))
          * 0.1).astype(np.float32)
    return jnp.asarray(ve), torch.from_numpy(ve)


# --------------------------------------------------------- specs and init
@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_param_specs_equal_the_references(smoke_cfg):
    """Every leaf's shape and logical axes, ``vision_proj`` included, at
    the full and the smoke config."""
    get = "get_smoke" if smoke_cfg else "get"
    rcfg, cfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    assert (_specs_tree(tfm.param_specs(cfg))
            == _specs_tree(ref_tfm.param_specs(rcfg)))
    assert tfm.param_specs(cfg)["vision_proj"]["w"][0] == (cfg.d_model,
                                                          cfg.d_model)


def test_init_params_draws_the_vision_projection(smoke):
    """``init_params`` follows the specs: ``vision_proj`` a truncated normal
    of std ``1 / sqrt(d_model)``, and ``from_reference_params`` carries
    the reference's projection across bit for bit."""
    _, rparams, cfg, params = smoke
    own = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = own["vision_proj"]["w"]
    assert w.shape == (cfg.d_model, cfg.d_model)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model)
    assert sum(p.numel() for grp in own.values() for p in grp.values()) == (
        cfg.param_count() + cfg.d_model ** 2 + (2 * cfg.n_layers + 1)
        * cfg.d_model)
    np.testing.assert_array_equal(params["vision_proj"]["w"].numpy(),
                                  np.asarray(rparams["vision_proj"]["w"]))


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("with_prefix", [False, True])
def test_hidden_states_match_reference(smoke, with_prefix):
    """``decoder_forward`` with and without the patch prefix: every
    position's hidden state (the prefix's too) within 1e-5."""
    rcfg, rparams, cfg, params = smoke
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    rkw, kw = {}, {}
    if with_prefix:
        rkw["vision_embeds"], kw["vision_embeds"] = _prefix(cfg, rng, 2)
    want = ref_tfm.forward(rparams, rcfg, tokens=jnp.asarray(tokens),
                           **rkw).hidden
    with torch.no_grad():
        got = tfm.forward(params, cfg, tokens=torch.from_numpy(tokens),
                          **kw).hidden
    assert got.shape == (2, 12 + (cfg.n_prefix_embeds if with_prefix else 0),
                         cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decoder_module_takes_the_prefix(smoke):
    """``DecoderLM(..)(tokens, vision_embeds=...)`` is ``forward``."""
    _, _, cfg, params = smoke
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
    _, ve = _prefix(cfg, rng, 2)
    with torch.no_grad():
        got = tfm.DecoderLM(cfg, params)(tokens, vision_embeds=ve).hidden
        want = tfm.forward(params, cfg, tokens=tokens,
                           vision_embeds=ve).hidden
    assert torch.equal(got, want)


def test_prefill_writes_the_prefix_into_the_cache(smoke):
    """A prefixed prefill fills ``P + S`` cache rows and advances the
    cursor by as many; the state's ``pos`` is the text length."""
    _, _, cfg, params = smoke
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    _, ve = _prefix(cfg, rng, 2)
    with torch.no_grad():
        _, state = serve_loop.make_prefill_step(cfg, 32)(
            params, tokens, {"vision_embeds": ve})
    p = cfg.n_prefix_embeds
    assert state["cache"]["cursor"] == p + 6
    assert state["pos"].tolist() == [6, 6]
    k = state["cache"]["k"]
    assert bool((k[:, :, :p + 6] != 0).any(-1).any(-1).all())
    assert bool((k[:, :, p + 6:] == 0).all())


def _ref_generate(rcfg, rparams, prompt, steps, max_len, extras,
                  forced=None):
    prefill = ref_loop.make_prefill_step(rcfg, max_len)
    decode = jax.jit(ref_loop.make_decode_step(rcfg))
    logits, state = prefill(rparams, jnp.asarray(prompt), extras)
    out, seen = [jnp.argmax(logits, -1)], [logits]
    for i in range(steps - 1):
        fed = out[-1] if forced is None else jnp.asarray(forced[:, i])
        logits, state = decode(rparams, state, fed)
        out.append(jnp.argmax(logits, -1))
        seen.append(logits)
    return np.asarray(jnp.stack(out, 1)), np.asarray(jnp.stack(seen, 1))


def test_greedy_tokens_and_teacher_forced_logits_match_reference(smoke):
    """Prefill with the patch prefix and decode steps through
    ``generate``: greedy tokens identical, and with the reference's tokens
    fed back to both, every step's logits within 1e-5."""
    rcfg, rparams, cfg, params = smoke
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, (3, 7))
    rve, ve = _prefix(cfg, rng, 3)
    ref_tokens, ref_logits = _ref_generate(rcfg, rparams, prompt, 6, 48,
                                           {"vision_embeds": rve})
    with torch.no_grad():
        tokens, logits = serve_loop.generate(
            cfg, params, torch.from_numpy(prompt), 6, 48,
            forced=torch.from_numpy(ref_tokens.copy()),
            extras={"vision_embeds": ve})
        free = serve_loop.greedy_generate(cfg, params, prompt, 6, 48,
                                          extras={"vision_embeds": ve},
                                          device="cpu")
    np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL)
    np.testing.assert_array_equal(free.numpy(), ref_tokens)


def _decode_against_full(tfm_forward, unembed, prefill, decode, params, cfg,
                         tokens, ve, shift):
    """The decode step's logits for ``tokens[:, -1]`` after a prefill of
    the rest, and the full forward's last-position logits; ``shift`` is
    added to the state's ``pos`` before the step."""
    logits, state = prefill(params, tokens[:, :-1], {"vision_embeds": ve})
    state = dict(state, pos=state["pos"] + shift)
    step_logits, _ = decode(params, state, tokens[:, -1])
    full = tfm_forward(params, cfg, tokens=tokens, vision_embeds=ve).hidden
    return _np(step_logits), _np(full[:, -1] @ unembed(params, cfg))


def test_vlm_decode_positions_reproduce_fault_f3(smoke):
    """ROADMAP fault F3, pinned in both packages: after a prefixed
    prefill, ``pos`` is the text length while the cache cursor counts the
    prefix, so the decode step's logits differ from the full forward's
    (by about 0.5 on logits of about 3); shifted by ``n_prefix_embeds``
    they agree.  The port's decode step equals the reference's, fault
    and all."""
    rcfg, rparams, cfg, params = smoke
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7))
    rve, ve = _prefix(cfg, rng, 2)
    p = cfg.n_prefix_embeds
    ref_args = (ref_tfm.forward, ref_tfm.unembed_weight,
                ref_loop.make_prefill_step(rcfg, 32),
                ref_loop.make_decode_step(rcfg), rparams, rcfg,
                jnp.asarray(tokens), rve)
    port_args = (tfm.forward, tfm.unembed_weight,
                 serve_loop.make_prefill_step(cfg, 32),
                 serve_loop.make_decode_step(cfg), params, cfg,
                 torch.from_numpy(tokens), ve)
    ref_step, ref_full = _decode_against_full(*ref_args, shift=0)
    ref_fixed, _ = _decode_against_full(*ref_args, shift=p)
    with torch.no_grad():
        step, full = _decode_against_full(*port_args, shift=0)
        fixed, _ = _decode_against_full(*port_args, shift=p)
    assert np.abs(ref_step - ref_full).max() > 0.1
    assert np.abs(ref_fixed - ref_full).max() < 1e-5
    assert np.abs(step - full).max() > 0.1
    assert np.abs(fixed - full).max() < 1e-5
    np.testing.assert_allclose(step, ref_step, **TOL)
    np.testing.assert_allclose(full, ref_full, **TOL)


# --------------------------------------------------------------- training
def _batch(cfg, rng, b=4, s=20):
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    weights = np.ones((b, s), np.float32)
    weights[b // 2 + 1:] = 0.0
    weights[0, s - 5:] = 0.0
    rve, ve = _prefix(cfg, rng, b)
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32),
             "weights": jnp.asarray(weights), "vision_embeds": rve},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "weights": torch.from_numpy(weights), "vision_embeds": ve})


def _ref_grads(rcfg, params, batch):
    grad_fn = jax.jit(jax.value_and_grad(ref_train.make_loss_fn(rcfg),
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


def _params(rcfg, cfg, seed=0):
    rparams = ref_tfm.init_params(jax.random.PRNGKey(seed), rcfg)
    params = from_reference_params(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    for p in (t for grp in params.values() for t in grp.values()):
        p.requires_grad_(True)
    return rparams, params


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_grads_match_reference(microbatches):
    """``make_grads_fn`` on prefixed batches (text positions scored only)
    against ``jax.value_and_grad`` of the reference's loss: loss within
    1e-5, every leaf (``vision_proj`` too) within 1e-4 relative L2; the
    patch embeddings split along the batch with the tokens."""
    rcfg = dataclasses.replace(ref_configs.get_smoke(ARCH),
                               microbatches=microbatches)
    cfg = dataclasses.replace(configs.get_smoke(ARCH),
                              microbatches=microbatches)
    rparams, params = _params(rcfg, cfg)
    rbatch, batch = _batch(cfg, np.random.default_rng(microbatches))
    rgrads, rmetrics = _ref_grads(rcfg, rparams, rbatch)
    grads, metrics = train_loop.make_grads_fn(cfg)(params, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=1e-5)
    assert float(metrics["tokens"]) == float(rmetrics["tokens"])
    paths = 0
    for path, g in leaves_with_path(grads):
        assert _rel_l2(g, _ref_leaf(rgrads, path)) <= 1e-4, path
        paths += 1
    assert paths == len(jax.tree_util.tree_leaves(rgrads))
    assert float(grads["vision_proj"]["w"].abs().max()) > 0


def test_text_only_batch_trains_as_the_dense_decoder(smoke):
    """Without ``vision_embeds`` the loss scores every position, as the
    reference's does (its drivers train a VLM on text only)."""
    rcfg, rparams, cfg, params = smoke
    rbatch, batch = _batch(cfg, np.random.default_rng(9))
    del rbatch["vision_embeds"], batch["vision_embeds"]
    _, rmetrics = ref_train.make_loss_fn(rcfg)(rparams, rbatch)
    with torch.no_grad():
        _, metrics = train_loop.make_loss_fn(cfg)(params, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=1e-5)
    assert set(train_loop.TRAINED) == {c.family for c in
                                       configs.all_configs().values()}


def test_text_only_grads_zero_the_vision_projection_alone(smoke):
    """A text-only batch gives ``vision_proj`` a zero gradient, as
    ``jax.grad`` does, and every other leaf the reference's gradient; a
    leaf the loss does not reach in another family stays autograd's
    error."""
    rcfg, cfg = smoke[0], smoke[2]
    rparams, params = _params(rcfg, cfg)
    rbatch, batch = _batch(cfg, np.random.default_rng(10))
    del rbatch["vision_embeds"], batch["vision_embeds"]
    rgrads, _ = _ref_grads(rcfg, rparams, rbatch)
    grads, _ = train_loop.make_grads_fn(cfg)(params, batch)
    assert list(grads) == list(params)
    assert not grads["vision_proj"]["w"].any()
    assert not _np(rgrads["vision_proj"]["w"]).any()
    for path, g in leaves_with_path(grads):
        if path[0] != "vision_proj":
            assert _rel_l2(g, _ref_leaf(rgrads, path)) <= 1e-4, path
    dense = dataclasses.replace(cfg, family="dense")
    with pytest.raises(RuntimeError, match="not have been used"):
        train_loop.make_grads_fn(dense)(params, batch)


# ------------------------------------------------------------------ inputs
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_the_references(shape):
    """``launch.inputs``' meta-device stand-ins have the reference's
    shapes and dtypes at every cell of the config: the batch, the
    prefill's tokens and patch embeddings (text ``seq_len -
    n_prefix_embeds`` long), the decode state's caches and positions and
    the decode step's tokens; and they allocate nothing."""
    rcfg, cfg = ref_configs.get(ARCH), configs.get(ARCH)
    rs, s = REF_SHAPES[shape], SHAPES[shape]

    def same(spec, ref):
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(ref.shape)
        assert str(spec.dtype).split(".")[-1] == str(ref.dtype)

    batch, rbatch = (inputs.train_batch_specs(cfg, s),
                     ref_inputs.train_batch_specs(rcfg, rs))
    assert set(batch) == set(rbatch)
    for k in batch:
        same(batch[k], rbatch[k])
    (tok, extras), (rtok, rextras) = (inputs.prefill_specs(cfg, s),
                                      ref_inputs.prefill_specs(rcfg, rs))
    same(tok, rtok)
    assert set(extras) == set(rextras) == {"vision_embeds"}
    same(extras["vision_embeds"], rextras["vision_embeds"])
    state = inputs.decode_state_specs(cfg, s)
    rstate = ref_inputs.decode_state_specs(rcfg, rs)
    for k in ("k", "v"):
        same(state["cache"][k], rstate["cache"][k])
    same(state["pos"], rstate["pos"])
    same(inputs.decode_token_specs(s), ref_inputs.decode_token_specs(rs))


def test_draw_makes_the_stand_ins_real():
    """``draw`` gives a float stand-in 0.1 a standard normal, from the
    generator's seed."""
    cfg = configs.get_smoke(ARCH)
    batch = inputs.train_batch_specs(cfg, SHAPES["train_4k"])
    ve = inputs.draw(batch["vision_embeds"], torch.Generator().manual_seed(0))
    again = inputs.draw(batch["vision_embeds"],
                        torch.Generator().manual_seed(0))
    assert ve.shape == (256, cfg.n_prefix_embeds, cfg.d_model)
    assert ve.dtype == torch.float32 and torch.equal(ve, again)
    assert abs(float(ve.std()) - 0.1) < 0.01


# ----------------------------------------------------------------- drivers
def test_serve_driver_serves_text_only_as_the_reference_does():
    """``launch.serve`` on the smoke VLM runs the text alone, as the
    reference's driver does, and routes and rebalances as it does."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "8",
            "--decode-steps", "4", "--prompt-len", "6"]
    buf, old = io.StringIO(), sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            ref_serve.main()
    finally:
        sys.argv = old
    report = serve.main(argv + ["--device", "cpu"])
    assert report.tokens == 8 * 4
    lines = buf.getvalue().splitlines()
    assert lines[0].split("W): ")[-1] == str(report.routing)


def test_train_driver_trains_the_vlm_on_text(tmp_path):
    """``launch.train`` on the smoke VLM runs its steps on text batches."""
    report = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "2", "--global-batch", "2",
                         "--seq-len", "16", "--checkpoint-every", "0",
                         "--checkpoint-dir", str(tmp_path)])
    assert len(report.losses) == 2 and np.isfinite(report.losses).all()


def test_reference_decode_state_specs_cursor_shape_differs_only_in_kind():
    """The port keeps the cache cursor a host ``int`` where the reference
    keeps an int32 per layer (``transformer._make_cache``)."""
    s = SHAPES["decode_32k"]
    state = inputs.decode_state_specs(configs.get(ARCH), s)
    rstate = ref_inputs.decode_state_specs(ref_configs.get(ARCH),
                                           REF_SHAPES["decode_32k"])
    assert state["cache"]["cursor"] == 0
    assert rstate["cache"]["cursor"].shape == (configs.get(ARCH).n_layers,)
