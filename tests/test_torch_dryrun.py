"""The port's dry run (``launch/dryrun.py``) on the CPU.

* The reference's roofline arithmetic (``score_tile_bytes``,
  ``_kernel_adjusted``) is copied as it is: bitwise equal to the
  reference's for all 64 cells, the reference run in a subprocess (its
  ``repro.launch.dryrun`` forces 512 host devices when it is imported) with
  its HBM rate set to the port's H100 one.
* The cheapest cells at production width run end to end on both meshes
  (Whisper-tiny's three shapes and MiniCPM-2B's ``decode_32k``, five
  processes of :func:`repro_torch.launch.dryrun.run_cells`): each is
  ``ok`` with every key of the reference's JSON but
  ``xla_cost_analysis``, and each rank's argument bytes equal the
  reference's per-device shard shapes (``NamedSharding.shard_shape`` on an
  ``AbstractMesh``), less the counters the port keeps on the host.
* The depth shortcut (two depths, extrapolated) equals the full count at
  two depths for every family, the layout runs on a fake 256-rank group
  included.
* Every module of the reference has a twin in the port.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.launch import inputs as ref_inputs
from repro.launch import shardspecs as ref_specs
from repro.models import transformer as ref_tfm
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.config import shapes_for as ref_shapes_for
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES, ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _all_cells():
    return [(arch, shape, multi) for arch in ref_configs.ARCHS
            for shape in ref_shapes_for(ref_configs.get(arch))
            for multi in (False, True)]


def test_the_cells_are_the_reference_s():
    got = list(dryrun.cells("both"))
    assert len(got) == 64
    assert sorted(got) == sorted(_all_cells())
    assert list(dryrun.cells("single")) == [c for c in got if not c[2]]


# ------------------------------------------------------- the formulas
_REF_FORMULAS = textwrap.dedent("""
    import json, sys
    from repro import configs
    from repro.launch import dryrun as d
    from repro.models.config import SHAPES
    d.HBM_BW = float(sys.argv[1])
    out = {}
    for arch, shape, multi, n, args in json.loads(sys.stdin.read()):
        cfg, sh = configs.get(arch), SHAPES[shape]
        out[f"{arch}/{shape}/{multi}"] = [
            d.score_tile_bytes(cfg, sh, n),
            [d._kernel_adjusted(cfg, sh, n, *a) for a in args]]
    print(json.dumps(out))
""")


def test_roofline_formulas_are_the_reference_s_bitwise():
    todo = []
    for i, (arch, shape, multi) in enumerate(_all_cells()):
        n = 512 if multi else 256
        tile = dryrun.score_tile_bytes(configs.get(arch), SHAPES[shape], n)
        # Bytes above, at and below the score tiles; each term dominant.
        args = [(tile * 3.0 + i, 1e-3, 2e-3), (tile * 1.05, 5.0, 1e-6),
                (tile * 0.5 + 1.0, 1e-9, 7.0), (0.0, 0.0, 0.0)]
        todo.append((arch, shape, multi, n, args))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_FORMULAS,
                          repr(dryrun.HBM_BW)], input=json.dumps(todo),
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    for arch, shape, multi, n, args in todo:
        cfg, sh = configs.get(arch), SHAPES[shape]
        tile, adjusted = ref[f"{arch}/{shape}/{multi}"]
        assert dryrun.score_tile_bytes(cfg, sh, n) == tile
        for a, want in zip(args, adjusted):
            assert dryrun._kernel_adjusted(cfg, sh, n, *a) == want


def test_roofline_constants_are_an_h100_s():
    assert dryrun.PEAK_FLOPS == 989e12
    assert dryrun.HBM_BW == 3.35e12
    assert dryrun.NET_BW == 50e9


# ------------------------------------------------- cells end to end
END_TO_END = [[("whisper_tiny", "train_4k", False)],
              [("whisper_tiny", "train_4k", True)],
              [("whisper_tiny", "prefill_32k", False)],
              [("whisper_tiny", "prefill_32k", True)],
              [("whisper_tiny", "decode_32k", False),
               ("whisper_tiny", "decode_32k", True),
               ("minicpm_2b", "decode_32k", False),
               ("minicpm_2b", "decode_32k", True)]]

#: The reference's JSON keys, less the compiler's own count.
REF_KEYS = {"cell", "arch", "shape", "mesh", "ok", "n_chips", "lower_s",
            "compile_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device",
            "collective_bytes_raw_f32_legalized", "memory", "roofline",
            "roofline_kernel_path", "model_flops_global",
            "useful_flops_ratio", "wall_s"}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The end-to-end cells' results, one process a group."""
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(END_TO_END),
                                                mp_context=ctx) as pool:
        runs = [pool.submit(dryrun.run_cells, group, out, True)
                for group in END_TO_END]
        results = [r for run in runs for r in run.result(timeout=600)]
    return {(r["arch"], r["shape"], r["mesh"] == "pod2x16x16"): r
            for r in results}


def test_cheapest_cells_run_on_both_meshes(cells):
    assert len(cells) == 8
    for (arch, shape, multi), r in cells.items():
        assert r["ok"], (r["cell"], r.get("error"), r.get("traceback"))
        assert REF_KEYS <= set(r), REF_KEYS - set(r)
        assert "xla_cost_analysis" not in r
        assert r["n_chips"] == (512 if multi else 256)
        assert r["cell"] == (f"{arch}__{shape}__"
                             f"{'pod2x16x16' if multi else 'pod16x16'}")
        assert r["collective_bytes_raw_f32_legalized"] == \
            r["collective_bytes_per_device"]
        roof = r["roofline"]
        assert roof["t_compute_s"] == pytest.approx(
            r["flops_per_device"] / dryrun.PEAK_FLOPS)
        assert roof["t_memory_s"] == pytest.approx(
            r["bytes_per_device"] / dryrun.HBM_BW)
        assert roof["t_collective_s"] == pytest.approx(
            r["collective_bytes_per_device"]["total"] / dryrun.NET_BW)
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert set(r["memory"]) >= {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes"}
        assert r["last_rank"]["rank"] == r["n_chips"] - 1
        # Every rank's blocks are even: the last rank's are rank 0's size.
        assert r["last_rank"]["argument_bytes"] == \
            r["memory"]["argument_bytes"]
    # The global count is the same step on both meshes (Whisper keeps its
    # config on both), split over twice the chips.
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        one, two = (cells[("whisper_tiny", shape, m)] for m in (False, True))
        assert one["flops_per_device"] == 2 * two["flops_per_device"]
    train = cells[("whisper_tiny", "train_4k", False)]
    assert train["useful_flops_ratio"] == pytest.approx(
        train["model_flops_global"] / (train["flops_per_device"] * 256))
    # The train step updates its state in place: its outputs alias it.
    assert 0 < train["memory"]["alias_bytes"] <= \
        train["memory"]["output_bytes"]


def _shard_bytes(tree, shardings) -> int:
    """The bytes of each leaf's per-device shard, less the decode caches'
    cursors (the port keeps one host int)."""
    total = 0
    for (path, leaf), sh in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves(shardings)):
        if path and getattr(path[-1], "key", None) == "cursor":
            continue
        total += int(np.prod(sh.shard_shape(leaf.shape))) * \
            leaf.dtype.itemsize
    return total


def _ref_argument_bytes(arch: str, shape_name: str, multi: bool) -> int:
    n = 512 if multi else 256
    mesh = AbstractMesh(*MESHES[multi])
    shape = REF_SHAPES[shape_name]
    cfg = ref_configs.get(arch)
    rules = ref_specs.rules_for(cfg, shape, mesh_size=n)
    cfg = ref_specs.effective_config(cfg, shape, n)
    if shape.kind == "train":
        # The step counter is a host int in the port.
        state = dataclasses.replace(ref_specs.abstract_train_state(cfg),
                                    step=None)
        batch = ref_inputs.train_batch_specs(cfg, shape)
        sh = dataclasses.replace(
            ref_specs.train_state_shardings(cfg, mesh, rules), step=None)
        parts = [(state, sh),
                 (batch, ref_specs.batch_shardings(cfg, mesh, rules, batch))]
    else:
        state = ref_inputs.decode_state_specs(cfg, shape)
        tokens = ref_inputs.decode_token_specs(shape)
        parts = [(ref_tfm.abstract_params(cfg),
                  ref_specs.param_shardings(cfg, mesh, rules)),
                 (state, ref_specs.decode_state_shardings(cfg, mesh, rules,
                                                          state)),
                 (tokens, ref_specs.batch_shardings(
                     cfg, mesh, rules, {"last_tokens": None})["last_tokens"])]
    return sum(_shard_bytes(t, s) for t, s in parts)


@pytest.mark.parametrize("cell", [("whisper_tiny", "train_4k"),
                                  ("minicpm_2b", "decode_32k")])
@pytest.mark.parametrize("multi", [False, True])
def test_argument_bytes_are_the_reference_s_shards(cells, cell, multi):
    got = cells[cell + (multi,)]["memory"]["argument_bytes"]
    assert got == _ref_argument_bytes(*cell, multi)


# ---------------------------------------------------- the depth shortcut
#: Per family: the architecture, the two depths and the smoke config's
#: changes (MoE with heads the model axis splits, as OLMoE's do: odd
#: heads would put its layers under a sequence split, which no production
#: rule gives a MoE model).
SHORTCUT = {"dense": ("granite_8b", (6, 7), {"microbatches": 2}),
            "moe": ("olmoe_1b_7b", (6, 7),
                    {"n_heads": 16, "n_kv_heads": 16, "head_dim": 4}),
            "ssm": ("mamba2_2p7b", (6, 7), {}),
            "hybrid": ("zamba2_7b", (9, 10), {}),
            "vlm": ("internvl2_26b", (6, 7), {}),
            "encdec": ("whisper_tiny", (6, 7), {})}


@pytest.mark.parametrize("family", list(SHORTCUT))
def test_the_depth_shortcut_is_the_full_count(family):
    """A train step at smoke width with remat on, globally and on rank 0
    of a fake 256-rank group: each count taken at :func:`dryrun.depths`
    and extrapolated equals the full depth's, at two depths (a hybrid's
    with and without a remainder after its last shared block).  The
    working set's peak is an estimate and is not held."""
    arch, targets, changes = SHORTCUT[family]
    shape = ShapeConfig("train_4k", "train", 16, 512)
    for n in targets:
        cfg = dataclasses.replace(configs.get_smoke(arch), remat="full",
                                  **changes)
        cfg = dryrun.at_depth(cfg, n)
        assert dryrun.depths(cfg) is not None
        cut = dryrun.cell_counts(cfg, shape, False, ranks=(0,))
        whole = dryrun.cell_counts(cfg, shape, False, shortcut=False,
                                   ranks=(0,))
        for key in ("global", 0):
            a = {k: v for k, v in cut[key].items() if k != "temp_bytes"}
            b = {k: v for k, v in whole[key].items() if k != "temp_bytes"}
            assert a == pytest.approx(b, rel=1e-12, abs=0), (n, key)
        assert whole[0]["flops"] > 0 and whole["global"]["flops"] > 0


# ---------------------------------------------------------- the twins
def test_every_reference_module_has_a_twin():
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if not (port / p.relative_to(ref)).exists()]
    assert missing == []
