"""Rank functions for the mesh tests (``tests/test_torch_mesh.py``,
``test_torch_sharded_sweep.py``, ``test_torch_moe_ep.py``,
``test_torch_elastic.py``).

Each runs inside a rank that :func:`repro_torch.launch.mesh.spawn`
started on the CPU, takes and returns NumPy arrays and plain values, and
imports neither JAX nor the reference: the tests compute the reference's
side in their own process.  A module of its own, so that a rank imports
only PyTorch and the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import mesh
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import Rules, sharding_context
from repro_torch.tree import leaves_with_path

#: The per-cell fields the sweep tests hold bitwise.
CELL_FIELDS = ("cap_changes", "vmotions", "power_ons", "power_offs",
               "energy_j", "cpu_payload_mhz_s", "cpu_satisfaction")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------- sweep
def sweep(specs, policies, n_devices=None, exact: bool = False,
          poison: bool = False) -> dict:
    """``run_sweep(engine="batch")`` (``run_sweep_batched`` when
    ``exact``) of the grid on this rank: the per-cell fields, the bucket
    records' ``n_devices`` and each bucket's final states.  ``poison``
    fills the padding's copies of the leading cells with absurd demand
    and budgets (ROADMAP trap T3): their results are dropped, and nothing
    of theirs may reach the kept cells."""
    from repro_torch.sim import batch, sweep as sw

    if poison:
        plain = batch.pad_cells

        def poisoned(arrays, pad):
            out = plain(arrays, pad)
            if pad:
                for key, scale in (("cpu_vals", 1e6), ("mem_vals", 1e6),
                                   ("budget", 1e-3)):
                    out[key] = out[key].copy()
                    out[key][-pad:] *= scale
            return out
        batch.pad_cells = poisoned
    try:
        if exact:
            res = sw.run_sweep_batched(specs, policies, device="cpu",
                                       n_devices=n_devices)
        else:
            res = sw.run_sweep(specs, policies, engine="batch",
                               device="cpu", n_devices=n_devices)
    finally:
        if poison:
            batch.pad_cells = plain
    cells = {(name, p): tuple(getattr(r, f) for f in CELL_FIELDS)
             for name, by_p in res.items() for p, r in by_p.items()}
    finals = [(b["result"].final_caps, b["result"].final_on,
               b["result"].final_occ) for b in sw.LAST_BATCH_INFO]
    return {"cells": cells, "order": [(n, list(by)) for n, by in res.items()],
            "n_devices": [b["n_devices"] for b in sw.LAST_BATCH_INFO],
            "finals": finals}


def batched(specs, policies, n_devices, keep_timeseries: bool) -> dict:
    """One ``BatchedSimulator`` over the grid's cells: its result's arrays
    (the per-tick series too when kept) and the cell counts K2's plan was
    sized for."""
    from repro_torch.sim import sweep as sw
    from repro_torch.sim.batch import BatchedSimulator

    from repro_torch.core import kernels

    cells, _ = sw.build_batch_cells(specs, policies)
    planned, real = set(), kernels.balance_caps

    def recording(*args, plan_cells=None, **kwargs):
        planned.add(plan_cells)
        return real(*args, plan_cells=plan_cells, **kwargs)
    kernels.balance_caps = recording
    try:
        res = BatchedSimulator(cells, device="cpu", n_devices=n_devices,
                               keep_timeseries=keep_timeseries).run()
    finally:
        kernels.balance_caps = real
    out = {f: getattr(res, f) for f in (
        "energy_j", "cpu_payload_mhz_s", "cap_changes", "final_caps",
        "final_on", "final_occ", "n_devices")}
    out["plan_cells"] = planned
    if keep_timeseries:
        out["timeseries"] = res.timeseries
        out["folded"] = res.reduced_timeseries()
    return out


# --------------------------------------------------------------------- moe
def moe_ep(cfg, params: dict, x: np.ndarray, probe: np.ndarray,
           shape: tuple, dense: bool = False) -> dict:
    """One MoE layer on a ``("data", "model")`` mesh of ``shape``: this
    rank's batch shard (over ``data``) through the expert-parallel
    dispatch (experts over ``model``), or through the dense one on the
    whole weights when ``dense``.  Returns the rank's output, aux loss,
    the aux loss's gradient in the router, and the gradients of ``sum(y *
    probe)`` in its x shard and its own leaves."""
    from repro_torch.models import moe

    m = mesh.make_host_mesh(shape, ("data", "model"))
    di, mi = m.get_coordinate()
    b = x.shape[0] // shape[0]
    xs = torch.from_numpy(x[di * b:(di + 1) * b]).requires_grad_(True)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    own = full if dense else moe.expert_shard(full, cfg, mi, shape[1])
    own = {k: v.clone().requires_grad_(True) for k, v in own.items()}
    if dense:
        y, aux = moe._moe_ffn_dense(own, xs, cfg)
    else:
        with sharding_context(m, Rules(batch=("data",), expert=("model",))):
            y, aux = moe.moe_ffn(own, xs, cfg)
    aux_router, = torch.autograd.grad(aux, own["router"], retain_graph=True)
    loss = (y * torch.from_numpy(probe[di * b:(di + 1) * b])).sum()
    grads = torch.autograd.grad(loss, [xs] + list(own.values()))
    return {"y": _np(y), "aux": float(aux.detach()), "coord": (di, mi),
            "aux_router": _np(aux_router),
            "grads": {k: _np(g) for k, g in zip(["x"] + list(own), grads)}}


def moe_pairs(cfg, params: dict, x: np.ndarray, shape: tuple) -> dict:
    """One MoE layer's forward under ``torch.profiler`` on a ``("data",
    "model")`` mesh of ``shape`` (experts over ``model`` where it has more
    than one rank, else the dense dispatch over ``data``): this rank's
    coordinate, its shard's expert ids and its MoE counters."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe
    from repro_torch.runtime import tracing

    m = mesh.make_host_mesh(shape, ("data", "model"))
    di, mi = m.get_coordinate()
    b = x.shape[0] // shape[0]
    xs = torch.from_numpy(x[di * b:(di + 1) * b])
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    own = moe.expert_shard(full, cfg, mi, shape[1]) if shape[1] > 1 \
        else full
    _, ids, _ = moe._route(own, xs.reshape(-1, cfg.d_model), cfg)
    with sharding_context(m, Rules(batch=("data",), expert=("model",))), \
            profile(activities=[ProfilerActivity.CPU]):
        moe.moe_ffn(own, xs, cfg)
    return {"coord": (di, mi), "ids": _np(ids),
            "counters": tracing.collect().counters}


def moe_ep_deterministic(cfg, params: dict, x: np.ndarray) -> bool:
    """Two backward passes of the expert-parallel dispatch on a (1, n)
    mesh under deterministic algorithms, every gradient equal bit for
    bit."""
    from repro_torch.models import moe

    torch.use_deterministic_algorithms(True)
    m = mesh.make_host_mesh((1, sharding.world_size()), ("data", "model"))
    _, mi = m.get_coordinate()
    runs = []
    for _ in range(2):
        own = {k: v.clone().requires_grad_(True) for k, v in
               moe.expert_shard({k: torch.from_numpy(v) for k, v in
                                 params.items()}, cfg, mi,
                                sharding.world_size()).items()}
        xs = torch.from_numpy(x).requires_grad_(True)
        with sharding_context(m, Rules(batch=("data",), expert=("model",))):
            y, aux = moe.moe_ffn(own, xs, cfg)
        runs.append(torch.autograd.grad(y.square().sum() + aux,
                                        [xs] + list(own.values())))
    return all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------- compress
def cross_pod_mean(gs: np.ndarray) -> np.ndarray:
    """``compressed_cross_pod_mean`` of rank r's ``gs[r]`` over a
    ``("pod",)`` mesh of every rank."""
    from repro_torch.optim.compress import compressed_cross_pod_mean

    m = mesh.make_host_mesh((sharding.world_size(),), ("pod",))
    return _np(compressed_cross_pod_mean(
        torch.from_numpy(gs[sharding.rank()]), m))


# -------------------------------------------------------------- training
def _train_setup(arch: str, lr: float, batch: int, seq: int):
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import init_train_state

    cfg = configs.get_smoke(arch)
    opt = AdamW(learning_rate=lr)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=1,
                           device="cpu")
    return cfg, opt, state, data


def digest(tree) -> str:
    """A hash of every leaf's path, dtype, shape and bytes."""
    import hashlib

    from repro_torch.checkpoint.checkpointer import _flatten

    h = hashlib.sha256()
    for path, leaf in sorted(_flatten(tree).items()):
        h.update(path.encode())
        if isinstance(leaf, int):
            h.update(str(leaf).encode())
        else:
            t = leaf.detach().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _batch(b) -> dict:
    return {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}


#: Data parallelism over ``("pod", "data")`` and nothing sharded: the rules
#: of the reference's ``examples/elastic_training.py`` (replicated
#: parameters, batch-sharded data), no expert axis.
DP_RULES = Rules(batch=("pod", "data"), heads=None, kv_heads=None,
                 ffn=None, vocab=None, expert=None, fsdp=None,
                 embed_p=None)


def data_parallel_grads(cfg, params: dict, batch: dict, shape: tuple,
                        axes: tuple) -> dict:
    """The gradients and metrics of ``batch`` (NumPy arrays, the whole
    batch: each rank takes its shard) at ``params`` under data
    parallelism over a mesh of ``shape`` with :data:`DP_RULES`."""
    from repro_torch.runtime.train_loop import make_grads_fn

    m = mesh.make_host_mesh(shape, axes)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with sharding_context(m, DP_RULES):
        grads, metrics = make_grads_fn(cfg)(params, b)
    return {"grads": {"/".join(p): _np(g) for p, g in
                      leaves_with_path(grads)},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def elastic(cfg, state, ckpt_dir: str, steps: int, lr: float, batch: int,
            seq: int) -> dict:
    """The reference example's flow on CPU ranks from ``state``: ``steps``
    steps on a ``("pod", "data") = (2, world / 2)`` mesh, resize 2 -> 1
    pods (``dpm-poweroff``) and ``steps`` steps, resize 1 -> 2
    (``dpm-poweron``) and ``steps`` steps; then ``recover`` onto 2 pods.
    Returns the losses (rank 0's), whether each restored leaf equals the
    saved one bit for bit, the data cursor and the resize history."""
    from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import shardspecs
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.elastic import ElasticController
    from repro_torch.runtime.train_loop import make_train_step

    opt = AdamW(learning_rate=lr)
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=1, device="cpu")
    per_pod = sharding.world_size() // 2
    rules = DP_RULES

    def make_mesh(n_pods):
        return mesh.make_host_mesh((n_pods, per_pod), ("pod", "data"))

    def make_shardings(m, target):
        return shardspecs.train_state_shardings(cfg, m, rules)

    ctl = ElasticController(Checkpointer(ckpt_dir), make_mesh,
                            make_shardings)
    step_fn = make_train_step(
        cfg, opt, grad_shardings=shardspecs.param_shardings(
            cfg, mesh.make_host_mesh((2, per_pod), ("pod", "data")),
            rules))
    m = make_mesh(2)
    losses, restored_equal, cursors = [], [], []

    def run(m, state):
        out = []
        for _ in range(steps):
            b = _batch(data.next_batch())
            if state is None:        # outside the mesh: no work
                continue
            with sharding_context(m, rules):
                state, metrics = step_fn(state, b)
            out.append(float(metrics["loss"]))
        return state, out

    def same(old, new):
        if old is None or new is None:
            return None
        a, b = _flatten(old), _flatten(new)
        return sorted(a) == sorted(b) and all(
            (a[k] == b[k]) if isinstance(a[k], int)
            else torch.equal(a[k].view(-1).view(torch.uint8),
                             b[k].view(-1).view(torch.uint8)) for k in a)

    digests = []
    for to_pods, reason in ((1, "dpm-poweroff"), (2, "dpm-poweron")):
        state, out = run(m, state)
        losses.append(out)
        before = state
        m, state = ctl.resize(state, data.step, 2 if to_pods == 1 else 1,
                              to_pods, reason, {"data": data.state_dict()})
        restored_equal.append(same(before, state))
        digests.append(None if state is None else digest(state))
        cursors.append(ctl.checkpointer.metadata(
            ctl.checkpointer.latest_step())["data"])
    state, out = run(m, state)
    losses.append(out)
    target = shardspecs.abstract_train_state(cfg)
    target.step = 0
    rm, rstate, rstep = ctl.recover(target, 2)
    return {"losses": losses, "restored_equal": restored_equal,
            "digests": digests,
            "recovered_equal": same(before, rstate)
            if sharding.rank() == 0 else rstate is not None,
            "recover_step": rstep, "cursors": cursors,
            "history": [(e.step, e.from_pods, e.to_pods, e.reason)
                        for e in ctl.history],
            "coordinate": None if rm.get_coordinate() is None
            else tuple(rm.get_coordinate())}


# ------------------------------------------------------------------ meshes
def meshes() -> dict:
    """The mesh functions and collectives on four ranks: a (2, 2) mesh's
    coordinates, sums and gathers along each dim, each rank's block of a
    (4, 2) tensor under four specs, a cells mesh over three ranks (the
    fourth outside it), and the mesh functions' errors."""
    m = mesh.make_host_mesh((2, 2), ("pod", "data"))
    r = float(sharding.rank())
    out = {"rank": sharding.rank(), "device": str(sharding.rank_device()),
           "coord": tuple(m.get_coordinate()),
           "pos": sharding.dims_coordinate(m, ("pod", "data")),
           "size": sharding.dims_size(m, ("pod", "data"))}
    for dims in (("pod",), ("data",), ("pod", "data")):
        out[f"sum {dims}"] = float(sharding.all_reduce(torch.tensor([r]), m,
                                                   dims))
    out["gather pod"] = _np(sharding.all_gather(
        torch.tensor([sharding.rank()], dtype=torch.int8), m, "pod"))
    from repro_torch.runtime.sharding import local_shard
    whole = torch.arange(8.0).reshape(4, 2)
    out["blocks"] = [_np(local_shard(whole, spec, m)) for spec in (
        (("pod", "data"), None), (None, "data"), ("data", None), ())]
    cells = mesh.make_cells_mesh(3)
    out["cells"] = (None if cells.get_coordinate() is None
                    else tuple(cells.get_coordinate()))
    errors = []
    for build in (lambda: mesh.make_cells_mesh(5),
                  lambda: mesh.make_production_mesh(),
                  lambda: mesh.make_pod_mesh(2),
                  lambda: mesh.make_host_mesh((4, 2))):
        try:
            build()
        except ValueError as exc:
            errors.append(str(exc))
    out["errors"] = errors
    out["objects"] = sharding.all_gather_objects({"r": sharding.rank()})
    return out


def raise_on(rank: int) -> int:
    """Raise ``ValueError`` on ``rank``; the others return theirs."""
    if sharding.rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return sharding.rank()


def sleep_for(seconds: float) -> None:
    import time
    time.sleep(seconds)


def build_once(src_dir: str, lib_path: str, record: str) -> bool:
    """Every rank at once asks a kernel library whose file is missing to
    be built, with ``build`` replaced by a slow stand-in that records the
    call and writes the file; returns whether this rank built it."""
    import time
    from pathlib import Path

    from repro_torch.kernels._build import KernelLibrary

    lib = KernelLibrary("lock_test", Path(src_dir), bind=None,
                        error_fn="none")
    lib.lib_path = Path(lib_path)

    def build():
        with open(record, "a") as f:
            f.write(f"{sharding.rank()}\n")
        time.sleep(0.5)
        lib.lib_path.write_bytes(b"built")
        return 0.5, ""
    lib.build = build
    sharding.barrier()
    return lib.ensure_built()
