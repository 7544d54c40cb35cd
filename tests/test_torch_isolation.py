"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fallback from the GPU to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.manager import CloudPowerCapManager
from repro_torch.kernels.powercap import ops
from repro_torch.sim import experiments, sweep
from repro_torch.sim.batch import BatchedSimulator
from repro_torch.sim.cluster import Simulator
from repro_torch.sim.engine import VectorSimulator

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py"))


def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_sources_import_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _foreign(n)], names


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    modules = sorted(".".join(("repro_torch",) + p.relative_to(PORT)
                              .with_suffix("").parts).replace(".__init__", "")
                     for p in SOURCES)
    assert "repro_torch.sim.engine" in modules
    code = ("import sys\n"
            f"import {', '.join(modules)}\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={"PYTHONPATH": str(PORT.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")


def test_entry_points_default_to_the_gpu(no_gpu):
    specs = sweep.scenario_families(sizes=(3,), spikes=("flat",),
                                    heterogeneous=(False,), duration_s=60.0)
    cells, _ = sweep.build_batch_cells(specs, ("cpc",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedSimulator(cells)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(specs, ("cpc",), engine="batch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(specs, ("cpc",), engine="vector")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(specs, ("cpc",), engine="legacy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(specs, ("cpc",), engine="batch",
                        on_unsupported="fallback")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep_batched(specs, ("cpc",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiments.run_policy("headroom", "cpc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiments.run_all("standby", engine="vector")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CloudPowerCapManager()
    snap, traces, cfg = sweep.build_sweep(specs[0], "cpc")
    for engine in (VectorSimulator, Simulator):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine(snap, sweep._sweep_manager("cpc", "cpu"), traces, cfg)
    x = np.ones((1, 2, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.waterfill_dense(x[..., 0], x, x, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.waterfill_segmented(x[0, 0], x[0, 0], x[0, 0], x[0, 0],
                                [0, 1, 1], 3)
    for engine in ("batch", "vector", "legacy"):
        assert sweep.run_sweep(specs, ("cpc",), engine=engine,
                               device="cpu")[specs[0].name]
    assert sweep.run_sweep_batched(specs, ("cpc",), device="cpu")
    assert sweep.run_sweep(specs, ("cpc",), engine="batch",
                           on_unsupported="fallback", device="cpu")


def test_serving_entry_points_default_to_the_gpu(no_gpu):
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import greedy_generate

    cfg = configs.get_smoke("granite_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg, torch.Generator().manual_seed(0))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(cfg, params, np.zeros((1, 4), np.int64), 2, 8)
    assert greedy_generate(cfg, params, np.zeros((1, 4), np.int64), 2, 8,
                           device="cpu").shape == (1, 2)
    # A CPU tensor runs the kernels' plain versions and counts no launch.
    q = torch.zeros(1, 3, 4, 16)
    kv = torch.zeros(1, 3, 2, 16)
    fa_ops.flash_attention(q, kv, kv)
    da_ops.decode_attention(q[:, 0], kv, kv, torch.ones(1, dtype=torch.int32))
    assert fa_ops.flash_attention.launches == 0
    assert da_ops.decode_attention.launches == 0


def test_training_entry_points_default_to_the_gpu(no_gpu, tmp_path):
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.power_integration import StragglerMitigator
    from repro_torch.runtime.train_loop import init_train_state

    cfg = configs.get_smoke("minicpm_2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--checkpoint-dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, AdamW(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticTokens(vocab_size=256, seq_len=8, global_batch=2
                        ).next_batch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StragglerMitigator()
    batch = SyntheticTokens(vocab_size=256, seq_len=8, global_batch=2,
                            device="cpu").next_batch()
    assert batch.tokens.device.type == "cpu"
    # A CPU tensor through the differentiable op runs the plain forward and
    # backward and counts no K4 or K5 launch.
    q = torch.zeros(1, 3, 4, 16, requires_grad=True)
    kv = torch.zeros(1, 3, 2, 16, requires_grad=True)
    out, _ = fa_ops.flash_attention(q, kv, kv)
    out.sum().backward()
    assert q.grad is not None and kv.grad is not None
    assert fa_ops.flash_attention.launches == 0
    assert fa_ops.flash_attention_bwd.launches == 0
