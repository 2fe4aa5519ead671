"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from renderih_tpu_torch.apps import demo, eval_interhand
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.eval import evaluator
from renderih_tpu_torch import serve_http
from renderih_tpu_torch.serve import InferenceEngine, resolve_device
from renderih_tpu_torch.tools import compute_maskiou, synth_gen, validate_bf16_decoder

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "renderih_tpu", "cv2", "PIL"}


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
    code = ("import sys, renderih_tpu_torch.serve, renderih_tpu_torch.utils.weights, "
            "renderih_tpu_torch.tools.synth_gen, renderih_tpu_torch.optimize, "
            "renderih_tpu_torch.render.renderer, renderih_tpu_torch.render.backgrounds, "
            "renderih_tpu_torch.apps.train, renderih_tpu_torch.train.trainer, "
            "renderih_tpu_torch.eval.evaluator, renderih_tpu_torch.apps.eval_interhand, "
            "renderih_tpu_torch.serve_http, renderih_tpu_torch.losses.mano_loss, "
            "renderih_tpu_torch.apps.eval_singlehand, renderih_tpu_torch.apps.eval_tzionas, "
            "renderih_tpu_torch.data.image_io, renderih_tpu_torch.data.native_reader, "
            "renderih_tpu_torch.mano.ik, renderih_tpu_torch.tools.pack_data, "
            "renderih_tpu_torch.tools.convert_assets, "
            "renderih_tpu_torch.tools.dataset_gen.interhand_gen, "
            "renderih_tpu_torch.tools.dataset_gen.handdict_gen, "
            "renderih_tpu_torch.tools.dataset_gen.tzionas_gen, "
            "renderih_tpu_torch.tools.dataset_gen.other_datasets_gen, "
            "renderih_tpu_torch.render.pathtrace, renderih_tpu_torch.apps.demo, "
            "renderih_tpu_torch.tools.compute_maskiou, "
            "renderih_tpu_torch.tools.validate_bf16_decoder, "
            "renderih_tpu_torch.tools.summarize_run; "
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


def test_synth_gen_without_device_runs_on_the_card_or_raises(tmp_path):
    if torch.cuda.is_available():
        assert synth_gen.build_parser().parse_args(["--out", "x"]).device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synth_gen.main(["--out", str(tmp_path / "out"), "--n", "1"])
        assert not (tmp_path / "out").exists()


def test_eval_without_device_runs_on_the_card_or_raises(tmp_path, monkeypatch):
    """`evaluate_packed` (device=None) and `apps.eval_interhand` (no
    --device) run on the card; without one they raise before any work."""
    if torch.cuda.is_available():
        assert eval_interhand.build_parser().parse_args([]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluator.evaluate_packed(Config(), torch.nn.Linear(1, 1), None, [0])
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_interhand.main(["--synthetic"])
    assert not list(tmp_path.iterdir())


def test_serve_http_without_device_runs_on_the_card_or_raises():
    """`python -m renderih_tpu_torch.serve_http` (no --device) serves from
    the card; without one it raises before binding a port."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--host", "127.0.0.1", "--port", "0"])


def test_serve_http_decoder_bf16_without_device_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--host", "127.0.0.1", "--port", "0", "--decoder_bf16"])


def test_rendering_apps_without_device_run_on_the_card_or_raise(tmp_path):
    """`apps.demo`, `tools.compute_maskiou` and `tools.validate_bf16_decoder`
    (no --device) run on the card; without one they raise before any
    output is written."""
    parsers = {"demo": demo.build_parser().parse_args([]),
               "maskiou": compute_maskiou.build_parser().parse_args(["--data", "d", "--out", "o"]),
               "bf16": validate_bf16_decoder.build_parser().parse_args([])}
    if torch.cuda.is_available():
        assert all(a.device == "cuda" for a in parsers.values())
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--img_path", str(tmp_path), "--save_path", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_maskiou.main(["--data", str(tmp_path), "--out", str(tmp_path / "iou.npy")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_bf16_decoder.main(["--steps", "1"])
    assert not list(tmp_path.iterdir())
