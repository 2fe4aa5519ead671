"""The import rules of the benchmark, by walking every module's imports.

Nothing under `cardbench/` imports JAX, jaxlib, flax or the JAX package
`renderih_tpu`; nothing under `cardbench/reference/` imports the program
`renderih_tpu_torch` either. Top-level names are compared whole: the port's
name begins with the JAX package's, so a prefix test would be wrong. Nothing
reads the old JAX benchmark's files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "renderih_tpu"}
OLD_BENCHMARK = ("bench.py", "bench_suite.py", "BENCH_", "MULTICHIP_", "BASELINE_MEASURED")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX_SIDE | {"renderih_tpu_torch", "cardbench"})


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_old_benchmark_not_read(path):
    text = path.read_text()
    if path.name == Path(__file__).name:
        return
    assert not any(name in text for name in OLD_BENCHMARK)


def test_whole_names_not_prefixes(tmp_path):
    """The port's imports pass the rule; a JAX package import fails it."""
    port = tmp_path / "port.py"
    port.write_text("import renderih_tpu_torch.serve\nfrom renderih_tpu_torch import config\n")
    assert not top_level_imports(port) & JAX_SIDE
    jax_side = tmp_path / "jax_side.py"
    jax_side.write_text("from renderih_tpu.models import model\n")
    assert top_level_imports(jax_side) & JAX_SIDE == {"renderih_tpu"}
