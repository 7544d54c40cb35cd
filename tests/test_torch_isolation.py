"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fallback from the GPU to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.powercap import ops
from repro_torch.sim import sweep
from repro_torch.sim.batch import BatchedSimulator

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
    code = ("import sys\n"
            "import repro_torch.sim.batch, repro_torch.sim.sweep, "
            "repro_torch.convert\n"
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
    x = np.ones((1, 2, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.waterfill_dense(x[..., 0], x, x, x)
    assert sweep.run_sweep(specs, ("cpc",), device="cpu")[specs[0].name]
