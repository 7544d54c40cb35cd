"""Rank functions for the split-layer tests (``tests/test_torch_tensor_parallel.py``
and ``tests/test_torch_fsdp.py``): tensor parallelism and FSDP storage
on CPU ranks under gloo.

Each runs inside a rank that :func:`repro_torch.launch.mesh.spawn`
started, on a ``("pod", "data", "model")`` mesh, takes NumPy arrays,
plain values and the port's own trees, and returns NumPy arrays of whole
tensors (gathered from the ranks' blocks): the tests hold them against
the reference's single-device functions in their own process.  It
imports neither JAX nor the reference.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, whole_state
from repro_torch.convert import from_reference_params
from repro_torch.launch import mesh, shardspecs
from repro_torch.models.config import SHAPES
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.runtime import serve_loop, sharding
from repro_torch.runtime.sharding import gather_whole, sharding_context
from repro_torch.runtime.train_loop import (make_grads_fn, make_loss_fn,
                                            make_train_step)
from repro_torch.tree import leaves, leaves_with_path

AXES = ("pod", "data", "model")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _rules(cfg, kind: str, shape: tuple):
    """``rules_for`` at the mesh's model size (``kind``: ``prefill``,
    ``decode``, ``tp`` training or ``dp`` training)."""
    name = {"prefill": "prefill_32k", "decode": "decode_32k",
            "tp": "train_4k", "dp": "train_4k"}[kind]
    if kind == "tp":
        cfg = dataclasses.replace(cfg, parallelism="tp")
    return shardspecs.rules_for(cfg, SHAPES[name], model_axis=shape[2],
                                mesh_size=math.prod(shape))


def _whole_grads(cfg, grads: dict, m, rules) -> dict:
    specs = shardspecs.param_shardings(cfg, m, rules)
    flat = dict(leaves_with_path(specs))
    return {"/".join(p): _np(gather_whole(g, flat[p], m))
            for p, g in leaves_with_path(grads)}


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def split_cases(cases: list, shape: tuple, layouts: tuple = ()) -> list:
    """For each case ``(tag, cfg, params, prompt, extras, steps, max_len,
    batch)`` (``params`` the reference's as NumPy arrays, ``batch`` None
    to skip training): the prefill's logits under the prefill rules, the
    greedy tokens and teacher-forced logits under the decode rules, and
    the gradients and metrics of ``batch`` under the tensor-parallel
    training rules, each whole; then :func:`layout_cases` of
    ``layouts``.  Every rank returns its own results."""
    m = mesh.make_host_mesh(shape, AXES)
    out = []
    for tag, cfg, params, prompt, extras, steps, max_len, batch in cases:
        res = {"tag": tag}
        prompt_t, extras_t = torch.from_numpy(prompt), _tensors(extras)
        for kind in ("prefill", "decode"):
            rules = _rules(cfg, kind, shape)
            with sharding_context(m, rules):
                local = from_reference_params(params, cfg, "cpu", m, rules)
                tokens, logits = serve_loop.generate(
                    cfg, local, prompt_t, 1 if kind == "prefill" else steps,
                    max_len, extras=extras_t)
            res[kind] = {"tokens": tokens.numpy(), "logits": _np(logits)}
        if batch is not None:
            rules = _rules(cfg, "tp", shape)
            with sharding_context(m, rules):
                local = from_reference_params(params, cfg, "cpu", m, rules)
                for p in leaves(local):
                    p.requires_grad_(True)
                grads, metrics = make_grads_fn(cfg)(local, _tensors(batch))
                res["train"] = {
                    "grads": _whole_grads(cfg, grads, m, rules),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
        out.append(res)
    return out + layout_cases(list(layouts), shape)


def vocab_tie(shape: tuple, vocab: int, ties: list) -> list:
    """:func:`sharding.vocab_argmax` over a vocabulary split across the
    ``model`` ranks: each rank's block of whole logit rows that hold
    their maximum at every index of ``ties[i]``."""
    m = mesh.make_host_mesh(shape, AXES)
    rules = sharding.Rules(batch=(), vocab=("model",))
    whole = torch.zeros(len(ties), vocab)
    for i, where in enumerate(ties):
        whole[i, list(where)] = 1.0
    with sharding_context(m, rules):
        local = sharding.local_shard(whole, (None, "model"), m)
        return sharding.vocab_argmax(local, vocab).tolist()


def backward_off_thread(cfg, params: dict, batch: dict, shape: tuple
                        ) -> bool:
    """The tensor-parallel gradients of ``batch`` with every layer
    checkpointed, the backward run on this thread and then on a new one
    (which starts outside the sharding context, as autograd's own thread
    does in a CUDA backward): equal bit for bit."""
    import threading

    m = mesh.make_host_mesh(shape, AXES)
    rules = _rules(cfg, "tp", shape)
    cfg = dataclasses.replace(cfg, remat="full")
    runs = []
    for off_thread in (False, True):
        with sharding_context(m, rules):
            local = from_reference_params(params, cfg, "cpu", m, rules)
            for p in leaves(local):
                p.requires_grad_(True)
            loss, _ = make_loss_fn(cfg)(local, _tensors(batch))
        out = []

        def backward():
            out.extend(torch.autograd.grad(loss, leaves(local)))
        if off_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        runs.append(out)
    return len(runs[1]) == len(runs[0]) and all(
        torch.equal(a, b) for a, b in zip(*runs))


def norm_of_blocks(cfg, params: dict, shape: tuple, kind: str) -> float:
    """:func:`global_norm` of a rank's blocks of ``params`` under the
    ``kind`` rules, summed over the ranks as the train step sums it."""
    from repro_torch.runtime.train_loop import _norm_dims
    m = mesh.make_host_mesh(shape, AXES)
    rules = _rules(cfg, kind, shape)
    with sharding_context(m, rules):
        local = from_reference_params(params, cfg, "cpu", m, rules)
        return float(global_norm(local, _norm_dims(cfg, None)))


def zero3_steps(cfg, state, batches: list, shape: tuple, kind: str,
                lr: float, ckpt_dir: str) -> dict:
    """``len(batches)`` AdamW steps from the whole ``state`` (the port's,
    carried over from the reference) with each rank storing its blocks
    under the ``kind`` rules; then a sharded save (every rank calls,
    rank 0 writes whole leaves), a one-rank save of the gathered state
    beside it, a restore into this layout and into the tensor-parallel
    one, and an elastic resize from this mesh to one rank that steps
    once more.  Returns the losses, the gradient norms, the stepped
    state whole, and the checks."""
    from repro_torch.runtime.elastic import ElasticController

    m = mesh.make_host_mesh(shape, AXES)
    rules = _rules(cfg, kind, shape)
    opt = AdamW(learning_rate=lr)
    local = shardspecs.local_train_state(state, cfg, m, rules)
    specs = shardspecs.train_state_shardings(cfg, m, rules)
    blocks = {"/".join(p): tuple(t.shape)
              for p, t in leaves_with_path(local.params)}
    step = make_train_step(cfg, opt, grad_shardings=specs.params)
    losses, norms = [], []
    with sharding_context(m, rules):
        for b in batches:
            local, metrics = step(local, _tensors(b))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    whole = whole_state(local, specs, m)
    ck = Checkpointer(ckpt_dir, keep=10)
    ck.save(1, local, {"from": "blocks"}, shardings=specs, mesh=m)
    if sharding.rank() == 0:
        ck.save(2, whole, {"from": "blocks"})
    sharding.barrier()
    target = shardspecs.abstract_train_state(cfg)
    target.step = 0
    same = []
    for other in ("dp", "tp"):
        orules = _rules(cfg, other, shape)
        ospecs = shardspecs.train_state_shardings(cfg, m, orules)
        back = ck.restore(1, target, device="cpu", shardings=ospecs, mesh=m)
        want = shardspecs.local_train_state(whole, cfg, m, orules)
        same.append(all(torch.equal(a, b) for a, b in zip(
            leaves(back.params) + leaves(back.opt_state.m),
            leaves(want.params) + leaves(want.opt_state.m))))

    def make_mesh(n):
        return mesh.make_host_mesh((1, n, 1) if n == 1 else shape, AXES)

    def make_shardings(mm, _):
        r = rules if mm.size() == m.size() else _rules(cfg, kind, (1, 1, 1))
        return shardspecs.train_state_shardings(cfg, mm, r)

    ctl = ElasticController(Checkpointer(ckpt_dir + "_elastic"), make_mesh,
                            make_shardings)
    new_mesh, one = ctl.resize(local, 3, math.prod(shape), 1,
                               "dpm-poweroff", mesh=m)
    after = None
    if one is not None:
        with sharding_context(new_mesh, _rules(cfg, kind, (1, 1, 1))):
            one, metrics = make_train_step(cfg, opt)(one,
                                                     _tensors(batches[0]))
        after = float(metrics["loss"])
    return {"losses": losses, "norms": norms, "blocks": blocks,
            "whole": {"/".join(p): _np(t) for p, t in
                      leaves_with_path(whole.params)},
            "restored_equal": same, "after_resize": after,
            "resized_shapes": None if one is None else {
                "/".join(p): tuple(t.shape)
                for p, t in leaves_with_path(one.params)}}


def layout_groups(groups: list) -> list:
    """:func:`layout_cases` of each ``(shape, cases)`` of ``groups`` (one
    mesh each, the same ranks), their results in one list."""
    return [r for shape, cases in groups for r in layout_cases(cases, shape)]


def layout_cases(cases: list, shape: tuple, axes: tuple = AXES) -> list:
    """For each case ``(tag, cfg, params, prompt, extras, steps, max_len,
    batch, rules)`` (``rules``: ``{kind: Rules}`` for any of ``prefill``,
    ``decode`` and ``train``, the production layouts of ``rules_for``),
    each whole on every rank: the prefill's logits under ``prefill``; the
    greedy tokens and their logits under ``decode``; with both, the
    prefill under ``prefill`` and the decode steps under ``decode`` (the
    state carried by ``relayout_decode_state``, the ``relayout`` entry);
    and the gradients and metrics of ``batch`` under ``train``."""
    m = mesh.make_host_mesh(shape, axes)
    out = []
    for tag, cfg, params, prompt, extras, steps, max_len, batch, rules in \
            cases:
        res = {"tag": tag}
        prompt_t, extras_t = torch.from_numpy(prompt), _tensors(extras)
        for kind, n in (("prefill", 1), ("decode", steps)):
            if kind not in rules:
                continue
            with sharding_context(m, rules[kind]):
                local = from_reference_params(params, cfg, "cpu", m,
                                              rules[kind])
                tokens, logits = serve_loop.generate(
                    cfg, local, prompt_t, n, max_len, extras=extras_t)
            res[kind] = {"tokens": tokens.numpy(), "logits": _np(logits)}
        if "prefill" in rules and "decode" in rules:
            with sharding_context(m, rules["decode"]):
                dec = from_reference_params(params, cfg, "cpu", m,
                                            rules["decode"])
            with sharding_context(m, rules["prefill"]):
                local = from_reference_params(params, cfg, "cpu", m,
                                              rules["prefill"])
                tokens, logits = serve_loop.generate(
                    cfg, local, prompt_t, steps, max_len, extras=extras_t,
                    decode_layout=(rules["decode"], dec))
            res["relayout"] = {"tokens": tokens.numpy(),
                               "logits": _np(logits)}
        if "train" in rules:
            with sharding_context(m, rules["train"]):
                local = from_reference_params(params, cfg, "cpu", m,
                                              rules["train"])
                for p in leaves(local):
                    p.requires_grad_(True)
                grads, metrics = make_grads_fn(cfg)(local, _tensors(batch))
                res["train"] = {
                    "grads": _whole_grads(cfg, grads, m, rules["train"]),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
        out.append(res)
    return out


def split_norms(shape: tuple, cases: list) -> list:
    """:func:`split_norm` of each ``(x, scale, dy)`` of ``cases``."""
    m = mesh.make_host_mesh(shape, AXES)
    return [split_norm(m, *c) for c in cases]


def split_norm(m, x: np.ndarray, scale: np.ndarray, dy: np.ndarray
               ) -> dict:
    """:func:`repro_torch.models.layers.split_rms_norm` over the last dim
    split across the ``model`` ranks of mesh ``m``: each rank's block of
    ``x`` and ``scale``, its output and VJP gathered whole."""
    from repro_torch.models.layers import split_rms_norm
    spec = (None,) * (x.ndim - 1) + ("model",)
    xs = sharding.local_shard(torch.from_numpy(x), spec, m)
    ss = sharding.local_shard(torch.from_numpy(scale), ("model",), m)
    gs = sharding.local_shard(torch.from_numpy(dy), spec, m)
    xs.requires_grad_(True)
    ss.requires_grad_(True)
    y = split_rms_norm(xs, ss, 1e-5, m, ("model",), x.shape[-1])
    dx, dscale = torch.autograd.grad(y, (xs, ss), gs)
    return {"y": _np(gather_whole(y, spec, m)),
            "dx": _np(gather_whole(dx, spec, m)),
            "dscale": _np(gather_whole(dscale, ("model",), m))}


def layout_resize(cfg, state, batch: dict, shape: tuple, layouts: list,
                  ckpt_dir: str, lr: float) -> dict:
    """For each ``(name, rules)`` of ``layouts``: the whole train ``state``
    cut into this rank's blocks under ``rules``, one AdamW step (its
    loss), a sharded save, a restore into every layout (each leaf equal
    bit for bit to the saved state's blocks there), and an elastic resize
    to one rank and back onto the mesh under the next layout (the state
    equal bit for bit to the saved one's blocks there)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.runtime.elastic import ElasticController

    m = mesh.make_host_mesh(shape, AXES)
    opt = AdamW(learning_rate=lr)
    target = shardspecs.abstract_train_state(cfg)
    target.step = 0
    ck = Checkpointer(ckpt_dir, keep=10)
    out = {"losses": [], "restored_equal": [], "resized_equal": []}

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(
            leaves(a.params) + leaves(a.opt_state.m),
            leaves(b.params) + leaves(b.opt_state.m)))
    for i, (name, rules) in enumerate(layouts):
        specs = shardspecs.train_state_shardings(cfg, m, rules)
        # The step updates the tensors in place: a copy a layout.
        local = shardspecs.local_train_state(copy.deepcopy(state), cfg, m,
                                             rules)
        with sharding_context(m, rules):
            local, metrics = make_train_step(
                cfg, opt, grad_shardings=specs.params)(local,
                                                       _tensors(batch))
        out["losses"].append(float(metrics["loss"]))
        whole = whole_state(local, specs, m)
        ck.save(i + 1, local, {"layout": name}, shardings=specs, mesh=m)
        sharding.barrier()
        for _, other in layouts:
            back = ck.restore(i + 1, target, device="cpu",
                              shardings=shardspecs.train_state_shardings(
                                  cfg, m, other), mesh=m)
            out["restored_equal"].append(equal(back, shardspecs
                                               .local_train_state(
                                                   whole, cfg, m, other)))
        nxt = layouts[(i + 1) % len(layouts)][1]
        current = [rules]

        def make_mesh(n):
            return mesh.make_host_mesh((1, n, 1) if n == 1 else shape, AXES)

        def make_shardings(mm, _):
            r = current[0] if mm.size() == m.size() else sharding.Rules()
            return shardspecs.train_state_shardings(cfg, mm, r)
        ctl = ElasticController(Checkpointer(f"{ckpt_dir}_elastic{i}"),
                                make_mesh, make_shardings)
        one_mesh, one = ctl.resize(local, 10 + i, 2, 1, "dpm-poweroff",
                                   mesh=m)
        current[0] = nxt
        _, again = ctl.resize(one, 20 + i, 1, 2, "dpm-poweron",
                              mesh=None if one is None else one_mesh)
        out["resized_equal"].append(equal(
            again, shardspecs.local_train_state(whole, cfg, m, nxt)))
    return out
