"""The port's device mesh (``launch/mesh.py``), its logical-axis rules
(``runtime/sharding.py``), the shardings of every step's inputs
(``launch/shardspecs.py``) and the int8 cross-pod mean, held against the
JAX package's on the CPU.

Rules, specs and shardings are pure functions of the mesh's axis names
and sizes, so the reference's run on an ``AbstractMesh`` of the
production 16 x 16 and 2 x 16 x 16 meshes with no devices, and the
port's on a ``MeshAxes`` of the same.  The mesh functions, collectives and
``compressed_cross_pod_mean`` run on CPU ranks under gloo (each spawn
with its own timeout, killing its ranks when it runs out); the
reference's cross-pod mean runs inside ``shard_map`` in a subprocess
with forced host devices, as ``repro/launch/dryrun.py`` sets them.  The
kernel build's file lock is held by two ranks asking for one library at
once.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate, Shard

import torch_mesh_ranks as ranks
from repro import configs as ref_configs
from repro.launch import inputs as ref_inputs
from repro.launch import shardspecs as ref_specs
from repro.models.config import SHAPES as REF_SHAPES
from repro.runtime import sharding as ref_sharding
from repro_torch import configs
from repro_torch.launch import inputs, mesh, shardspecs
from repro_torch.models.config import SHAPES
from repro_torch.runtime import sharding
from repro_torch.tree import leaves_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TIMEOUT_S = 60.0


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), sharding.MeshAxes(names, shape)


def _flat(tree, prefix=""):
    """``path -> spec`` of a tree of specs (the reference's
    ``NamedSharding`` leaves as their ``PartitionSpec`` tuples)."""
    if isinstance(tree, NamedSharding):
        return {prefix: tuple(tree.spec)}
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    elif hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if v is not None:
                out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and tree and isinstance(
            tree[0], (dict, NamedSharding)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree)}


def _flat_like(specs, like, prefix=""):
    """``path -> spec`` of the port's spec tree, walked along ``like``
    (the tree it was made from: a spec tuple is a leaf there)."""
    if isinstance(like, (dict, tuple)):
        items = like.items() if isinstance(like, dict) else enumerate(like)
        out = {}
        for k, v in items:
            out.update(_flat_like(specs[k], v, f"{prefix}/{k}"))
        return out
    return {prefix: specs}


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("name", sorted(MESHES))
def test_rules_and_logical_specs_match_the_references(name):
    """Every logical name's mesh axes, under the default rules and under
    every (arch x shape) specialization, and ``logical_spec`` inside a
    bound context."""
    amesh, pmesh = _meshes(name)
    logical = [f.name for f in dataclasses.fields(sharding.Rules)] + [None]
    for arch in ref_configs.ARCHS:
        for shape in REF_SHAPES:
            rr = ref_specs.rules_for(ref_configs.get(arch),
                                     REF_SHAPES[shape])
            pr = shardspecs.rules_for(configs.get(arch), SHAPES[shape])
            assert dataclasses.asdict(rr) == dataclasses.asdict(pr)
            for n in logical:
                assert pr.mesh_axes(n, pmesh) == rr.mesh_axes(n, amesh), n
    assert sharding.logical_spec("batch") is None
    # The reference's context enters the mesh, which an AbstractMesh
    # cannot: bind its context variable alone.
    token = ref_sharding._CTX.set((amesh, ref_sharding.Rules()))
    try:
        with sharding.sharding_context(pmesh, sharding.Rules()):
            for n in logical:
                assert (sharding.logical_spec(n, None)
                        == tuple(ref_sharding.logical_spec(n, None)))
            assert sharding.current_context() == (pmesh, sharding.Rules())
    finally:
        ref_sharding._CTX.reset(token)
    assert sharding.current_context() is None


def test_to_placements_lists_mesh_dims_not_tensor_dims():
    """A spec lists mesh axes a tensor dim, placements tensor dims a mesh
    dim: ``batch = ("pod", "data")`` shards tensor dim 0 over two mesh
    dims, an axis absent from the spec is replicated."""
    m = sharding.MeshAxes(("pod", "data", "model"), (2, 2, 2))
    assert sharding.to_placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements((None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.to_placements((), m) == (Replicate(),) * 3
    x = torch.ones(3)
    with sharding.sharding_context(m, sharding.Rules()):
        assert sharding.shard(x, "batch") is x     # a plain tensor
    assert sharding.shard(x, "batch") is x


# ------------------------------------------------------------- shardspecs
@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_shardspecs_match_the_references(arch, name):
    """Parameters, optimizer and train state, the batch, and the decode
    state at every shape of the arch, spec for spec; ``dp_applicable`` and
    ``effective_config`` too; the abstract train state's shapes and
    dtypes."""
    amesh, pmesh = _meshes(name)
    rcfg, cfg = ref_configs.get(arch), configs.get(arch)
    size = int(np.prod(MESHES[name][0]))
    for shape in REF_SHAPES:
        rs, s = REF_SHAPES[shape], SHAPES[shape]
        assert (shardspecs.dp_applicable(cfg, s, size)
                == ref_specs.dp_applicable(rcfg, rs, size))
        assert (shardspecs.effective_config(cfg, s, size).microbatches
                == ref_specs.effective_config(rcfg, rs, size).microbatches)
        rr, pr = ref_specs.rules_for(rcfg, rs), shardspecs.rules_for(cfg, s)
        assert (_flat(shardspecs.train_state_shardings(cfg, pmesh, pr))
                == _flat(ref_specs.train_state_shardings(rcfg, amesh, rr)))
        rb = ref_specs.batch_shardings(
            rcfg, amesh, rr, ref_inputs.train_batch_specs(rcfg, rs))
        pb = shardspecs.batch_shardings(
            cfg, pmesh, pr, inputs.train_batch_specs(cfg, s))
        assert pb == {k: tuple(v.spec) for k, v in rb.items()}
        if rs.kind == "decode":
            want = _flat(ref_specs.decode_state_shardings(
                rcfg, amesh, rr, ref_inputs.decode_state_specs(rcfg, rs)))
            state = inputs.decode_state_specs(cfg, s)
            got = _flat_like(shardspecs.decode_state_shardings(
                cfg, pmesh, pr, state), state)
            # The port's cursor is one host int (the reference's an int32
            # a layer): replicated in both.
            for key in [k for k in got if k.endswith("/cursor")]:
                assert got.pop(key) == want.pop(key) == ()
            assert got == want
    assert shardspecs.replicated(pmesh) == tuple(
        ref_specs.replicated(amesh).spec)
    abstract = shardspecs.abstract_train_state(cfg)
    ref_abs = ref_specs.abstract_train_state(rcfg)
    want = {"/".join(k.key for k in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_leaves_with_path(ref_abs.params)}
    got = dict(leaves_with_path(abstract.params))
    assert {"/".join(p): tuple(t.shape) for p, t in got.items()} == want
    assert all(t.device.type == "meta" for t in got.values())
    assert str(abstract.opt_state.m["embed"]["table"].dtype).endswith(
        rcfg.optimizer_state_dtype)


# ----------------------------------------------------------------- meshes
def test_backend_rule(monkeypatch):
    """CPU ranks run gloo; on the card, nccl when each rank owns a card
    and gloo when ranks share one; asked for the card with none, raise."""
    assert mesh.backend_for("cpu", 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.backend_for("cuda", 4) == "nccl"
    assert mesh.backend_for("cuda", 1) == "nccl"
    assert mesh.backend_for("cuda", 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.backend_for("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.spawn(ranks.raise_on, 2, "cuda", -1, timeout_s=TIMEOUT_S)
    with pytest.raises(ValueError):
        mesh.backend_for("tpu", 1)


def test_meshes_and_collectives_on_four_ranks():
    outs = mesh.spawn(ranks.meshes, 4, "cpu", timeout_s=TIMEOUT_S)
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    assert all(o["device"] == "cpu" for o in outs)
    assert [o["coord"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [o["pos"] for o in outs] == [0, 1, 2, 3]
    assert all(o["size"] == 4 for o in outs)
    # Sums over pod pair ranks {0, 2} and {1, 3}; over data {0, 1}, {2, 3}.
    assert [o["sum ('pod',)"] for o in outs] == [2.0, 4.0, 2.0, 4.0]
    assert [o["sum ('data',)"] for o in outs] == [1.0, 1.0, 5.0, 5.0]
    assert all(o["sum ('pod', 'data')"] == 6.0 for o in outs)
    assert [list(o["gather pod"]) for o in outs] == [[0, 2], [1, 3],
                                                     [0, 2], [1, 3]]
    whole = np.arange(8.0).reshape(4, 2)
    for r, o in enumerate(outs):
        pod, data = divmod(r, 2)
        want = [whole[r:r + 1], whole[:, data:data + 1],
                whole[2 * data:2 * data + 2], whole]
        for got, w in zip(o["blocks"], want):
            np.testing.assert_array_equal(got, w)
    assert [o["cells"] for o in outs] == [(0,), (1,), (2,), None]
    for o in outs:
        assert len(o["errors"]) == 4, o["errors"]
        assert o["objects"] == [{"r": r} for r in range(4)]
    assert sharding.world_size() == 1 and sharding.rank() == 0
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_cells_mesh()


def test_spawn_raises_a_ranks_exception_in_the_caller():
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as info:
        mesh.spawn(ranks.raise_on, 2, "cpu", 1, timeout_s=TIMEOUT_S)
    assert any("raised on rank 1 of 2 (gloo)" in n
               for n in info.value.__notes__)
    assert mesh.spawn(ranks.raise_on, 2, "cpu", -1,
                      timeout_s=TIMEOUT_S) == [0, 1]


def test_spawn_kills_its_ranks_when_the_timeout_runs_out():
    import multiprocessing

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 3 s"):
        mesh.spawn(ranks.sleep_for, 2, "cpu", 120.0, timeout_s=3.0)
    assert time.monotonic() - t0 < 30.0
    assert not multiprocessing.active_children()


# --------------------------------------------------------- cross-pod mean
REF_CROSS_POD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.optim.compress import compressed_cross_pod_mean

    out = {}
    for pods in (2, 4):
        gs = np.load(sys.argv[1] + f"/g{pods}.npy")
        mesh = jax.make_mesh((pods,), ("pod",),
                             devices=jax.devices()[:pods])
        fn = shard_map(lambda g: compressed_cross_pod_mean(g[0])[None],
                       mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                       check_rep=False)
        np.save(sys.argv[1] + f"/ref{pods}.npy", np.asarray(fn(gs)))
    print("CROSS_POD_OK")
""")


@pytest.fixture(scope="module")
def cross_pod_inputs(tmp_path_factory):
    """Each pod's gradient (4 x 33 float32, scales apart), and the
    reference's mean on every pod, from one subprocess."""
    work = tmp_path_factory.mktemp("cross_pod")
    rng = np.random.default_rng(7)
    gs = {p: (rng.standard_normal((p, 4, 33))
              * np.logspace(-3, 1, p)[:, None, None]).astype(np.float32)
          for p in (2, 4)}
    for p, g in gs.items():
        np.save(work / f"g{p}.npy", g)
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", REF_CROSS_POD, str(work)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=src,
                                  JAX_PLATFORMS="cpu"))
    assert "CROSS_POD_OK" in out.stdout, out.stderr[-2000:]
    return {p: (gs[p], np.load(work / f"ref{p}.npy")) for p in gs}


@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_cross_pod_mean_matches_the_reference(pods,
                                                         cross_pod_inputs):
    """The int8 all-gather over pods and the local mean: every pod's
    result equal to the reference's ``shard_map`` bit for bit, the same
    on every pod, and within one quantization step of the exact mean."""
    gs, ref = cross_pod_inputs[pods]
    outs = mesh.spawn(ranks.cross_pod_mean, pods, "cpu", gs,
                      timeout_s=TIMEOUT_S)
    for r, got in enumerate(outs):
        np.testing.assert_array_equal(got, ref[r])
        np.testing.assert_array_equal(got, outs[0])
    step = np.abs(gs).max(axis=(1, 2)).mean() / 127.0
    assert np.abs(outs[0] - gs.mean(0)).max() <= step


# --------------------------------------------------------------- build lock
def test_ranks_building_one_library_at_once_build_it_once(tmp_path):
    """Two ranks find a library missing at the same moment: the file lock
    lets the first build it and the second find it built, so exactly one
    build runs."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// stand-in\n")
    lib, record = tmp_path / "build" / "liblock_test.so", tmp_path / "calls"
    built = mesh.spawn(ranks.build_once, 2, "cpu", str(src), str(lib),
                       str(record), timeout_s=TIMEOUT_S)
    assert sorted(built) == [False, True]
    assert len(record.read_text().split()) == 1
    assert lib.read_bytes() == b"built"
