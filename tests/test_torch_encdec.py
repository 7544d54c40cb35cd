"""The ``encdec`` family (Whisper-tiny's encoder and cross attention): the
port against the JAX reference, on the CPU.

The reference's smoke parameters are carried across with
``convert.from_reference_params``; the prompts, the frame embeddings
(float32, 0.1 a standard normal, as the reference's tests draw them) and
the training batches are drawn with NumPy from a seed and handed to both
packages.  The encoder's self attention and the cross attention run on
K4's plain version (non-causal; over 20 frames its last key block is
ragged), a one-token step's cross attention on K6's, and training's on
K5's.  Tolerances, all in float32: hidden states and logits 1e-5, greedy
tokens identical, the loss 1e-5 and each gradient leaf 1e-4 relative L2;
K4 and K5 against the reference's Pallas kernels at the reference's
kernel tolerance.  The reference's drivers pass no frames (ROADMAP fault
F4): a test pins its ``KeyError`` and the port's named error.
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
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.launch import inputs as ref_inputs
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train_driver
from repro.models import transformer as ref_tfm
from repro.models.config import SHAPES as REF_SHAPES
from repro.runtime import serve_loop as ref_loop
from repro.runtime import train_loop as ref_train
from repro_torch import configs
from repro_torch.convert import from_reference_params
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import inputs, serve, train
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES
from repro_torch.runtime import serve_loop, train_loop
from repro_torch.tree import leaves_with_path

ARCH = "whisper_tiny"
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
    return {k: _specs_tree(v) if isinstance(v, dict)
            else (tuple(v[0]), tuple(v[1])) for k, v in specs.items()}


def _cfgs(enc_seq=None, microbatches=None):
    rcfg, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    change = {}
    if enc_seq is not None:
        change["enc_seq"] = enc_seq
    if microbatches is not None:
        change["microbatches"] = microbatches
    return (dataclasses.replace(rcfg, **change),
            dataclasses.replace(cfg, **change))


def _params(rcfg, cfg, grad=False):
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    params = from_reference_params(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    if grad:
        for p in (t for grp in params.values() for t in grp.values()):
            p.requires_grad_(True)
    return rparams, params


@pytest.fixture(scope="module")
def smoke():
    rcfg, cfg = _cfgs()
    return (rcfg, cfg) + _params(rcfg, cfg)


def _frames(cfg, rng, b):
    fr = (rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
          * 0.1).astype(np.float32)
    return jnp.asarray(fr), torch.from_numpy(fr)


# --------------------------------------------------------- specs and init
@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_param_specs_equal_the_references(smoke_cfg):
    """The encoder blocks, the decoder blocks with ``ln_cross`` and the
    ``cross_`` weights, and ``enc_norm``: every leaf's shape and logical
    axes, at the full and the smoke config."""
    get = "get_smoke" if smoke_cfg else "get"
    rcfg, cfg = getattr(ref_configs, get)(ARCH), getattr(configs, get)(ARCH)
    specs = tfm.param_specs(cfg)
    assert _specs_tree(specs) == _specs_tree(ref_tfm.param_specs(rcfg))
    assert {"enc_blocks", "dec_blocks", "enc_norm"} <= set(specs)
    assert specs["dec_blocks"]["cross_wq"][0] == (cfg.n_layers, cfg.d_model,
                                                  cfg.d_model)


def test_init_params_and_conversion_cover_every_leaf(smoke):
    """``init_params`` draws each spec's leaf; ``from_reference_params``
    carries the reference's tree across unchanged, bit for bit."""
    rcfg, cfg, rparams, params = smoke
    own = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for grp in own.values() for p in grp.values())
    norms = (2 * cfg.enc_layers + 3 * cfg.n_layers + 2) * cfg.d_model
    assert n == cfg.param_count() + norms
    for path, t in leaves_with_path(params):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(_ref_leaf(rparams, path)))


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("enc_seq", [16, 20])
def test_hidden_states_match_reference(enc_seq):
    """``encdec_forward`` at the smoke's 16 frames and at 20 (the plain
    versions' 64-key blocks then end ragged): hidden states within 1e-5;
    given ``enc_out`` it skips the encoder and gives the same."""
    rcfg, cfg = _cfgs(enc_seq)
    rparams, params = _params(rcfg, cfg)
    rng = np.random.default_rng(enc_seq)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    rfr, fr = _frames(cfg, rng, 2)
    want = ref_tfm.forward(rparams, rcfg, tokens=jnp.asarray(tokens),
                           frames=rfr).hidden
    with torch.no_grad():
        got = tfm.forward(params, cfg, tokens=torch.from_numpy(tokens),
                          frames=fr).hidden
        enc = tfm.encode(params, fr, cfg)
        again = tfm.forward(params, cfg, tokens=torch.from_numpy(tokens),
                            enc_out=enc).hidden
        module = tfm.DecoderLM(cfg, params)(torch.from_numpy(tokens),
                                            frames=fr).hidden
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert torch.equal(got, again) and torch.equal(got, module)


def test_cross_attention_matches_reference(smoke):
    """``layers.attention`` with ``cross_kv``: only q projected, no RoPE,
    every query against every key (K4 over 5 rows, K6 for one), against
    the reference's ``attention(..., cross_kv=...)``."""
    rcfg, cfg, rparams, params = smoke
    from repro.models import layers as ref_layers
    rng = np.random.default_rng(1)
    blk = {k[len("cross_"):]: v[0] for k, v in params["dec_blocks"].items()
           if k.startswith("cross_")}
    rblk = {k: jnp.asarray(v.numpy()) for k, v in blk.items()}
    kv = [rng.standard_normal((2, 20, cfg.n_kv_heads, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    for s in (5, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        want, _ = ref_layers.attention(rblk, jnp.asarray(x), rcfg,
                                       cross_kv=tuple(map(jnp.asarray, kv)))
        before = (fa_ops.flash_attention.launches,
                  da_ops.decode_attention.launches)
        got, cache = layers.attention(blk, torch.from_numpy(x), cfg,
                                      cross_kv=tuple(map(torch.from_numpy,
                                                         kv)))
        assert cache is None
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        assert (fa_ops.flash_attention.launches,
                da_ops.decode_attention.launches) == before


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


@pytest.mark.parametrize("enc_seq", [16, 20])
def test_greedy_tokens_and_teacher_forced_logits_match_reference(enc_seq):
    """Prefill with frames, then decode steps that re-run the encoder over
    the state's frames: greedy tokens identical, and with the reference's
    tokens fed back, every step's logits within 1e-5."""
    rcfg, cfg = _cfgs(enc_seq)
    rparams, params = _params(rcfg, cfg)
    rng = np.random.default_rng(6 + enc_seq)
    prompt = rng.integers(0, cfg.vocab_size, (3, 4))
    rfr, fr = _frames(cfg, rng, 3)
    ref_tokens, ref_logits = _ref_generate(rcfg, rparams, prompt, 6, 32,
                                           {"frames": rfr})
    with torch.no_grad():
        _, logits = serve_loop.generate(
            cfg, params, torch.from_numpy(prompt), 6, 32,
            forced=torch.from_numpy(ref_tokens.copy()),
            extras={"frames": fr})
        free = serve_loop.greedy_generate(cfg, params, prompt, 6, 32,
                                          extras={"frames": fr},
                                          device="cpu")
    np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL)
    np.testing.assert_array_equal(free.numpy(), ref_tokens)


def test_decode_state_keeps_the_frames(smoke):
    """The prefill's state carries ``enc_frames``; ``pos`` starts at the
    prompt's length and the cache cursor with it."""
    rcfg, cfg, rparams, params = smoke
    rng = np.random.default_rng(8)
    _, fr = _frames(cfg, rng, 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
    with torch.no_grad():
        _, state = serve_loop.make_prefill_step(cfg, 16)(
            params, tokens, {"frames": fr})
    assert state["enc_frames"] is fr
    assert state["pos"].tolist() == [5, 5] and state["cache"]["cursor"] == 5


# --------------------------------------------------------------- training
def _batch(cfg, rng, b=4, s=12):
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    weights = np.ones((b, s), np.float32)
    weights[b // 2 + 1:] = 0.0
    weights[0, s - 3:] = 0.0
    rfr, fr = _frames(cfg, rng, b)
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32),
             "weights": jnp.asarray(weights), "frames": rfr},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "weights": torch.from_numpy(weights), "frames": fr})


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


@pytest.mark.parametrize("microbatches,enc_seq", [(1, 16), (2, 16),
                                                  (1, 20)])
def test_grads_match_reference(microbatches, enc_seq):
    """``make_grads_fn`` on batches with frames (split along the batch
    with the tokens) against ``jax.value_and_grad`` of the reference's
    loss: loss within 1e-5, every leaf (the encoder's, ``enc_norm`` and
    the cross weights too) within 1e-4 relative L2."""
    rcfg, cfg = _cfgs(enc_seq, microbatches)
    rparams, params = _params(rcfg, cfg, grad=True)
    rbatch, batch = _batch(cfg, np.random.default_rng(microbatches))
    rgrads, rmetrics = _ref_grads(rcfg, rparams, rbatch)
    grads, metrics = train_loop.make_grads_fn(cfg)(params, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=1e-5)
    paths = 0
    for path, g in leaves_with_path(grads):
        assert _rel_l2(g, _ref_leaf(rgrads, path)) <= 1e-4, path
        paths += 1
    assert paths == len(jax.tree_util.tree_leaves(rgrads))


def test_train_step_matches_reference():
    """Three ``make_train_step`` steps against the reference's jitted step
    from the same state (remat on, as the config has it): loss within 1e-5
    and the gradients' norm within 1e-4 each step, every parameter within
    1e-4 relative L2 after the three."""
    from repro.optim import adamw as ref_adamw
    from repro.optim import schedule as ref_schedule
    from repro_torch.convert import from_reference_train_state
    from repro_torch.optim import adamw, schedule

    rcfg, cfg = (dataclasses.replace(c, remat="full") for c in _cfgs())
    sched = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    ropt = ref_adamw.AdamW(learning_rate=ref_schedule.cosine_schedule(
        **sched))
    opt = adamw.AdamW(learning_rate=schedule.cosine_schedule(**sched))
    rstate = ref_train.init_train_state(jax.random.PRNGKey(0), rcfg, ropt)
    state = from_reference_train_state(
        jax.tree_util.tree_map(np.asarray, rstate), cfg, device="cpu")
    rstep = jax.jit(ref_train.make_train_step(rcfg, ropt))
    step = train_loop.make_train_step(cfg, opt)
    rng = np.random.default_rng(7)
    for _ in range(3):
        rbatch, batch = _batch(cfg, rng)
        rstate, rmetrics = rstep(rstate, rbatch)
        state, metrics = step(state, batch)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(rmetrics["grad_norm"]), rtol=1e-4)
    for path, p in leaves_with_path(state.params):
        assert _rel_l2(p, _ref_leaf(rstate.params, path)) <= 1e-4, path


# ------------------------------------------------- K4 and K5 non-causal
def test_k4_and_k5_plain_match_pallas_non_causal_ragged():
    """K4's plain version (the forward, ``causal=False``) and K5's (the
    Function's backward) at 24 query rows over 150 keys of head dim 64 --
    a cross attention's shape, no multiple of any block -- against the
    reference's Pallas kernels in interpret mode (the forward kernel with
    64-row blocks, the custom VJP with 32)."""
    rng = np.random.default_rng(150)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((2, 24, 4, 64), (2, 150, 2, 64), (2, 150, 2, 64),
               (2, 24, 4, 64))]
    jq, jk, jv, jct = map(jnp.asarray, arrays)
    tq, tk, tv, tct = (torch.from_numpy(a.copy()) for a in arrays)
    p_out, p_lse = flash_attention_kernel(jq, jk, jv, causal=False,
                                          block_q=64, block_k=64,
                                          interpret=True)

    def loss(q, k, v):
        out = pallas_flash(q, k, v, causal=False, block_q=32, block_k=32)
        return jnp.sum(out * jct)

    g_pallas = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out, lse = fa_ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(out), _np(p_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(p_lse), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(out, (tq, tk, tv), tct)
    for name, a, p in zip(("dq", "dk", "dv"), got, g_pallas):
        np.testing.assert_allclose(_np(a), _np(p), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------------ inputs
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_the_references(shape):
    """``launch.inputs``' meta-device stand-ins against the reference's at
    every cell: the batch and the prefill's frames ``(B, 1500, 384)``
    float32, the decode state's caches, positions and ``enc_frames``."""
    rcfg, cfg = ref_configs.get(ARCH), configs.get(ARCH)
    rs, s = REF_SHAPES[shape], SHAPES[shape]

    def same(spec, ref):
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(ref.shape)
        assert str(spec.dtype).split(".")[-1] == str(ref.dtype)

    batch = inputs.train_batch_specs(cfg, s)
    rbatch = ref_inputs.train_batch_specs(rcfg, rs)
    assert set(batch) == set(rbatch)
    for k in batch:
        same(batch[k], rbatch[k])
    (tok, extras), (rtok, rextras) = (inputs.prefill_specs(cfg, s),
                                      ref_inputs.prefill_specs(rcfg, rs))
    same(tok, rtok)
    assert set(extras) == set(rextras) == {"frames"}
    same(extras["frames"], rextras["frames"])
    state = inputs.decode_state_specs(cfg, s)
    rstate = ref_inputs.decode_state_specs(rcfg, rs)
    for k in ("k", "v"):
        same(state["cache"][k], rstate["cache"][k])
    same(state["pos"], rstate["pos"])
    same(state["enc_frames"], rstate["enc_frames"])


# ---------------------------------------------- the drivers: fault F4
def _ref_main(main, argv):
    buf, old = io.StringIO(), sys.argv
    sys.argv = ["driver"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = old


def test_serve_driver_without_frames_fails_as_the_reference_does():
    """ROADMAP fault F4: ``launch.serve --arch whisper_tiny --smoke`` passes
    no frames.  The reference's driver stops in its prefill with
    ``KeyError: 'frames'``; the port's raises a ``ValueError`` that names
    the missing frames and the fault."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "4",
            "--decode-steps", "2"]
    with pytest.raises(KeyError, match="frames"):
        _ref_main(ref_serve.main, argv)
    with pytest.raises(ValueError, match="frames.*F4"):
        serve.main(argv + ["--device", "cpu"])


def test_train_driver_without_frames_fails_as_the_reference_does(tmp_path):
    """The same fault in ``launch.train``: the reference's first step reads
    ``batch["frames"]`` and raises ``KeyError``; the port's loss raises
    its ``ValueError``."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--global-batch",
            "2", "--seq-len", "8", "--checkpoint-every", "0"]
    with pytest.raises(KeyError, match="frames"):
        _ref_main(ref_train_driver.main,
                  argv + ["--checkpoint-dir", str(tmp_path / "ref")])
    with pytest.raises(ValueError, match="frames.*F4"):
        train.main(argv + ["--device", "cpu", "--checkpoint-dir",
                           str(tmp_path / "port")])
