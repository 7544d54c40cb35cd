"""No module of the benchmark imports ``jax``, ``jaxlib``, ``flax``, the
JAX package ``repro`` or ``benchmarks``, and the reference imports nothing
of ``repro_torch``: top-level names compared whole (``repro_torch`` begins
with ``repro``)."""

import ast

import smoke_root
import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(p for p in smoke_root.HERE.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(smoke_root.HERE))
                              for p in MODULES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (smoke_root.HERE / "reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})
    assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                        "torch"}


def test_the_walk_finds_a_forbidden_name(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                   "import repro_torch\nfrom benchmarks import run\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "repro",
                                                  "benchmarks"}
