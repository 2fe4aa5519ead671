"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from renderih_tpu_torch.config import Config
from renderih_tpu_torch.serve import InferenceEngine, resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "renderih_tpu"}


def _port_files():
    return sorted((ROOT / "renderih_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files if _imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, renderih_tpu_torch.serve, renderih_tpu_torch.utils.weights; "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_engine_without_device_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(Config())


def test_cpu_must_be_asked_for():
    assert resolve_device("cpu").type == "cpu"
