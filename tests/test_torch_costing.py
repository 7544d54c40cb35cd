"""The port's cost counter (``launch/costing.py``) against the reference's
``repro.launch.costing``, on the CPU.

The reference walks a jaxpr; the port counts the aten and ``c10d`` ops a
function dispatches on ``meta`` stand-ins.  The first six tests are the
twins of ``tests/test_costing.py``: an exact product, a loop's trips, the
recompute of a checkpoint, collective bytes with the all-reduce's wire
factor on a fake process group, dtype-true collective bytes (the port has
no ``f32_as_bf16`` artefact to undo) and one rank's share of a split
product.

Then each family's train, prefill and decode step at smoke width, the
port's count against the reference's ``jaxpr_cost`` of the same step on
the same shapes.  Their products are equal wherever both plain routes run
the same products; where they do not, :func:`_product_difference` states
the difference from the shapes, term by term:

  * the port's streamed cross-entropy recomputes each chunk's logits in
    its backward: one more ``tokens x d_model x vocab`` product a train
    step;
  * K5's plain backward recomputes the scores from the log-sum-exp: one
    more ``Sq x Skv x head_dim`` product a head and an attention
    application a train step (no block is skipped at these lengths: the
    causal skip, which the reference's XLA attention does not make, is
    :func:`test_k5_plain_backward_skips_masked_blocks`'s);
  * K8b's plain backward recomputes the intra-chunk scores: one more
    ``Q x Q x N`` product a chunk, head and SSM layer a train step;
  * the reference combines an MoE token's top-k expert outputs by a
    product, the port by a weighted sum: one fewer ``tokens x top_k x
    d_model`` product a MoE layer and pass (three passes a train step);
  * the reference's SSM decode step writes the state's update as an outer
    product, the port as a broadcast multiply: one fewer ``H x P x N``
    product a row and SSM layer.

The totals agree within 10% (FLOPs) and 25% (bytes): the elementwise ops
are not the same ops on the two sides (the port's in-place optimizer
writes, its own mask and cast chains, the reference's scan carries), and
each side's byte model charges each elementwise output once.  The
reference's ``repro.launch.dryrun`` is not imported here: it forces 512
host devices when it is imported.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as ref_configs
from repro.launch import inputs as ref_inputs
from repro.launch import shardspecs as ref_specs
from repro.launch.costing import jaxpr_cost
from repro.models import transformer as ref_tfm
from repro.models.config import ShapeConfig as RefShape
from repro.optim.adamw import AdamW as RefAdamW
from repro.runtime.serve_loop import make_decode_step as ref_decode
from repro.runtime.serve_loop import make_prefill_step as ref_prefill
from repro.runtime.train_loop import make_train_step as ref_train
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import costing, dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime import sharding


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


# ------------------------------------------------------ the reference's six
def test_product_flops_and_bytes_are_exact():
    c = costing.cost_of(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32
    assert c["bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_a_loop_counts_every_trip():
    def seven(x):
        for _ in range(7):
            x = x @ x
        return x
    one = costing.cost_of(lambda x: x @ x, _meta(16, 16))
    assert costing.cost_of(seven, _meta(16, 16))["flops"] == \
        7 * one["flops"] == 7 * 2 * 16 * 16 * 16


def test_checkpoint_recompute_is_counted():
    def layer(x, w):
        return torch.tanh(x @ w)

    def grad(fn):
        def g(x, w):
            return torch.autograd.grad(fn(x, w).sum(), w)[0]
        return g

    def remat(x, w):
        return torch.utils.checkpoint.checkpoint(layer, x, w,
                                                 use_reentrant=False)
    args = (_meta(32, 32), _meta(32, 32, grad=True))
    plain = costing.cost_of(grad(layer), *args)
    again = costing.cost_of(grad(remat), *args)
    assert again["flops"] > plain["flops"]
    # The recompute is the forward's product.
    assert again["flops"] - plain["flops"] >= 2 * 32 * 32 * 32


@pytest.fixture
def fake_group():
    """This process as rank 0 of a fake process group of 8, torn down
    after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield make_host_mesh((8,), ("data",))
    finally:
        dist.destroy_process_group()
        dryrun._forget_meshes()


def test_collective_bytes_take_the_wire_factor(fake_group):
    def run(x, y):
        sharding.all_gather(x, fake_group, "data")        # 8 x 2 values
        for _ in range(5):
            sharding.all_reduce(y, fake_group, ("data",))
    c = costing.count(run, _meta(2), _meta(8))
    coll = c.collective_bytes()
    assert coll["all-gather"] == 16 * 4 == 64
    assert coll["all-reduce"] == 5 * 32 * 2
    assert coll["total"] == 64 + 320


def test_collective_bytes_are_the_dtype_it_runs_in(fake_group):
    def gather(x):
        sharding.all_gather(x, fake_group, "data")
    f32 = costing.count(gather, _meta(2)).collectives["all-gather"]
    bf16 = costing.count(gather, _meta(2, dtype=torch.bfloat16)
                         ).collectives["all-gather"]
    assert (f32, bf16) == (64, 32)


def test_a_rank_s_split_product_times_the_world_is_the_whole(fake_group):
    whole = costing.cost_of(lambda a, b: a @ b, _meta(64, 128),
                            _meta(128, 32))
    mesh = fake_group

    def rank_rows(a, b):
        rows = sharding.local_shard(a, ("data", None), mesh)
        return rows @ b
    local = costing.cost_of(rank_rows, _meta(64, 128), _meta(128, 32))
    assert local["flops"] * dist.get_world_size() == whole["flops"]


# ------------------------------------------------------------ the plain K5
def test_k5_plain_backward_skips_masked_blocks():
    """At 256 causal positions (4 key blocks of 64) K5's plain backward
    runs its five products over the query rows from each key block's
    start: ``sum_j (S - 64 j)`` rows, where the reference's XLA attention
    differentiates every block in full."""
    b, s, h, d = 2, 256, 4, 16
    q = _meta(b, s, h, d, grad=True)
    kv = _meta(b, s, h, d, grad=True)

    def fwd_bwd(q, k, v):
        out, _ = fa_ops.flash_attention(q, k, v)
        return torch.autograd.grad(out.sum(), (q, k, v))
    c = costing.count(fwd_bwd, q, kv, kv)
    blk = fa_ops.BLOCK_K
    assert blk == fa_ops.BLOCK_Q == 64
    per_row_key = 2 * b * h * d
    forward = 2 * per_row_key * s * s             # scores and P @ V
    backward = 5 * per_row_key * blk * sum(s - j * blk
                                           for j in range(s // blk))
    assert c.product_flops == forward + backward


# --------------------------------------------------- the families' steps
FAMILIES = {"dense": "granite_8b", "moe": "olmoe_1b_7b",
            "ssm": "mamba2_2p7b", "hybrid": "zamba2_7b",
            "vlm": "internvl2_26b", "encdec": "whisper_tiny"}
SEQ, BATCH = 32, 2
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


def _ref_products(jaxpr, mult=1) -> float:
    """The dot FLOPs of a jaxpr, walked as ``jaxpr_cost`` walks it."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            a, b = eqn.invars[0].aval, eqn.invars[1].aval
            (lc, _), (lb, _) = eqn.params["dimension_numbers"]
            batch = int(np.prod([a.shape[i] for i in lb])) if lb else 1
            k = int(np.prod([a.shape[i] for i in lc])) if lc else 1
            m, n = a.size // (batch * k), b.size // (batch * k)
            total += 2 * batch * m * n * k * mult
        elif prim == "scan":
            total += _ref_products(eqn.params["jaxpr"],
                                   mult * eqn.params["length"])
        elif prim == "while":
            total += _ref_products(eqn.params["body_jaxpr"], mult)
        elif prim == "cond":
            total += max(_ref_products(br, mult)
                         for br in eqn.params["branches"])
        elif "jaxpr" in eqn.params:
            total += _ref_products(eqn.params["jaxpr"], mult)
        elif "call_jaxpr" in eqn.params:
            total += _ref_products(eqn.params["call_jaxpr"], mult)
    return total


def _reference(arch: str, kind: str):
    cfg = ref_configs.get_smoke(arch)
    shape = RefShape(SHAPE_NAMES[kind], kind, SEQ, BATCH)
    if kind == "train":
        step = ref_train(cfg, RefAdamW(state_dtype=cfg.optimizer_state_dtype))
        args = (ref_specs.abstract_train_state(cfg),
                ref_inputs.train_batch_specs(cfg, shape))
    elif kind == "prefill":
        step = ref_prefill(cfg, max_len=SEQ)
        tokens, extras = ref_inputs.prefill_specs(cfg, shape)
        args = (ref_tfm.abstract_params(cfg), tokens, extras)
    else:
        step = ref_decode(cfg)
        args = (ref_tfm.abstract_params(cfg),
                ref_inputs.decode_state_specs(cfg, shape),
                ref_inputs.decode_token_specs(shape))
    jpr = jax.make_jaxpr(step)(*args)
    return cfg, jaxpr_cost(jpr), _ref_products(jpr)


def _product_difference(cfg, kind: str) -> int:
    """The port's product FLOPs less the reference's, from the shapes (the
    module docstring's terms)."""
    b, s, d = BATCH, SEQ, cfg.d_model
    diff = 0
    if kind == "train":
        text = s - cfg.n_prefix_embeds if cfg.family == "vlm" else s
        diff += 2 * b * text * d * cfg.vocab_size          # xent's logits
        per_key = 2 * b * cfg.n_heads * cfg.head_dim       # K5's scores
        if cfg.family == "encdec":
            e = cfg.enc_seq
            diff += per_key * (cfg.enc_layers * e * e
                               + cfg.n_layers * (s * s + s * e))
        elif cfg.attn_layers:
            diff += per_key * s * s * cfg.attn_layers
        if cfg.ssm_layers:                                  # K8b's scores
            q = cfg.ssm_chunk
            chunks = math.ceil(s / q)
            diff += (2 * b * cfg.n_ssm_heads * chunks * q * q * cfg.ssm_state
                     * cfg.ssm_layers)
    if cfg.family == "moe":
        tokens = b * (1 if kind == "decode" else s)
        passes = 3 if kind == "train" else 1
        diff -= 2 * tokens * cfg.moe_top_k * d * cfg.n_layers * passes
    if kind == "decode" and cfg.ssm_layers:
        diff -= (2 * b * cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                 * cfg.ssm_layers)
    return diff


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_family_s_step_counts_as_the_reference_s(family, kind):
    arch = FAMILIES[family]
    ref_cfg, ref, ref_products = _reference(arch, kind)
    cfg = configs.get_smoke(arch)
    run = dryrun.run_step(cfg, ShapeConfig(SHAPE_NAMES[kind], kind, SEQ,
                                           BATCH))
    port = run["cost"]
    assert port.product_flops - ref_products == \
        _product_difference(cfg, kind)
    assert cfg.flops_per_token(SEQ) == ref_cfg.flops_per_token(SEQ)
    assert port.flops == pytest.approx(ref["flops"], rel=0.10)
    assert port.bytes == pytest.approx(ref["bytes"], rel=0.25)
    # Nothing launched: the kernels' wrappers took their plain branches.
    assert fa_ops.flash_attention.launches == 0


def test_stand_ins_keep_shapes_dtypes_and_grads():
    state = dataclasses.make_dataclass("S", ["w", "step"])(
        torch.zeros(3, 4, requires_grad=True), 5)
    out = costing.stand_ins({"s": state, "t": (torch.zeros(2, dtype=torch.int32),)})
    assert out["s"].w.device.type == "meta" and out["s"].w.requires_grad
    assert out["s"].step == 5
    assert out["t"][0].dtype == torch.int32
    assert tuple(out["s"].w.shape) == (3, 4)


# ------------------------------------------- the wrappers' meta branches
def _like(got, want):
    """``got`` (meta) has ``want``'s (CPU) shapes and dtypes, leaf by
    leaf."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _on(device, *tensors, grad=False):
    return tuple(t.detach().to(device).requires_grad_(grad) for t in tensors)


def _grads(fn, inputs):
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out.float().sum(), inputs)


def test_meta_tensors_take_k4_and_k5_plain_branches():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 16, generator=g)
    kv = torch.randn(2, 24, 2, 16, generator=g)
    cpu = _on("cpu", q, kv, kv, grad=True)
    meta = _on("meta", q, kv, kv, grad=True)
    _like(fa_ops.flash_attention(*meta), fa_ops.flash_attention(*cpu))
    _like(_grads(fa_ops.flash_attention, meta),
          _grads(fa_ops.flash_attention, cpu))
    assert fa_ops.flash_attention.launches == 0
    assert fa_ops.flash_attention_bwd.launches == 0


def test_meta_tensors_take_k6_plain_branch():
    from repro_torch.kernels.decode_attention import ops as da_ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    kv = torch.randn(2, 40, 2, 16, generator=g)
    kv_len = torch.tensor([7, 40], dtype=torch.int32)
    for fn in (da_ops.decode_attention, da_ops.decode_attention_lse):
        _like(fn(*_on("meta", q, kv, kv), kv_len.to("meta")),
              fn(q, kv, kv, kv_len))
    assert da_ops.decode_attention.launches == 0


def test_meta_tensors_take_k7_plain_branches():
    from repro_torch.kernels.moe_gmm import ops as mg_ops
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 8, generator=g)
    w = torch.randn(4, 8, 12, generator=g)
    cpu, meta = _on("cpu", x, w, grad=True), _on("meta", x, w, grad=True)
    _like(mg_ops.grouped_matmul(*meta), mg_ops.grouped_matmul(*cpu))
    _like(_grads(mg_ops.grouped_matmul, meta),
          _grads(mg_ops.grouped_matmul, cpu))
    assert mg_ops.grouped_matmul.launches == 0


def test_meta_tensors_take_k8_and_k8b_plain_branches():
    from repro_torch.kernels.ssd_scan import ops as ss_ops
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 20, 3, 4, 5
    args = (torch.randn(b, l, h, p, generator=g),
            torch.rand(b, l, h, generator=g),
            torch.randn(h, generator=g),
            torch.randn(b, l, h, n, generator=g),
            torch.randn(b, l, h, n, generator=g))

    def scan(*a):
        return ss_ops.ssd_scan(*a, chunk=8)
    cpu, meta = _on("cpu", *args, grad=True), _on("meta", *args, grad=True)
    _like(scan(*meta), scan(*cpu))
    _like(_grads(scan, meta), _grads(scan, cpu))
    assert ss_ops.ssd_scan.launches == 0
    assert ss_ops.ssd_chunk_bwd.launches == 0


def test_meta_is_a_device_the_entry_points_take():
    from repro_torch.backend import PLAIN_DEVICES, resolve_device
    assert PLAIN_DEVICES == ("cpu", "meta")
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
