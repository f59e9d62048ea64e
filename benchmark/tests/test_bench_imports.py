"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "anemoi_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"anemoi_tpu_torch", "torch", "benchmark"}


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import anemoi_tpu_torch.ff\nfrom anemoi_tpu.ff import golden\nimport jax.numpy as jnp\n")
    assert _imports(f) == {"anemoi_tpu_torch", "anemoi_tpu", "jax"}
