"""The port's synthetic-data generator on the CPU (`--device cpu`: the
plain versions), with the contact/SDF refinement, read back by the JAX
package's packed-dataset reader."""

import numpy as np
import pytest
import torch

from renderih_tpu.data.interhand import LABEL_KEYS as JAX_LABEL_KEYS
from renderih_tpu.data.interhand import PackedInterHand, _label_shape
from renderih_tpu.ops.projection import orthographic_project as jax_project
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS
from renderih_tpu_torch.kernels import sdf
from renderih_tpu_torch.tools import synth_gen


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        n_launches = sdf.launches.value
        result = synth_gen.main(["--out", str(out), "--n", "2", "--batch", "2", "--optimize",
                                 "--opt_iters", "4", "--seed", "3", "--device", "cpu"])
        assert sdf.launches.value == n_launches  # the CPU takes the plain version
    finally:
        torch.set_num_threads(prev)
    return out, result


def test_output_loads_with_the_jax_reader(generated):
    out, result = generated
    assert LABEL_KEYS == JAX_LABEL_KEYS and IMG_SIZE == 256
    data = PackedInterHand.load(str(out), "train", use_native=False)
    assert len(data) == 2 and result["n"] == 2 and result["device"] == "cpu"
    batch = data.batch(np.arange(2))
    assert batch["img_u8"].shape == (2, 256, 256, 3) and batch["img_u8"].dtype == np.uint8
    assert batch["img_u8"].std() > 5  # a rendered scene, not a blank
    for key in LABEL_KEYS:
        assert batch[key].shape == (2,) + _label_shape(key), key
        assert np.isfinite(batch[key]).all(), key
    np.testing.assert_array_equal(batch["pose_left"][:, :3], 0.0)
    assert result["refined_samples_per_s"] > 0 and result["images_per_s"] > 0


def test_2d_labels_are_the_sampled_camera_projection(generated):
    out, result = generated
    labels = dict(np.load(out / "train_labels.npz"))
    cam = result["camera"]
    for side in ("left", "right"):
        for kind in ("v", "j"):
            want = np.asarray(jax_project(cam["scale"], cam[f"trans_{side}"],
                                          labels[f"{kind}3d_{side}"], 256))
            np.testing.assert_allclose(labels[f"{kind}2d_{side}"], want, atol=1e-3)
    # the left hand is centred on its joint 9 (middle MCP)
    np.testing.assert_allclose(labels["j3d_left"][:, 9], 0.0, atol=1e-6)


def test_prior_gan_refines_with_the_shipped_discriminator(tmp_path, monkeypatch):
    """`--prior gan`: the refinement's prior is the trained discriminator's
    energy on the port's copy of the artifact (the JAX tool's default)."""
    made = []
    real = synth_gen.make_gan_pose_prior
    monkeypatch.setattr(synth_gen, "make_gan_pose_prior",
                        lambda params, device: made.append(params) or real(params, device))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = synth_gen.main(["--out", str(tmp_path), "--n", "1", "--batch", "1",
                                 "--optimize", "--opt_iters", "4", "--prior", "gan",
                                 "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    assert len(made) == 1 and made[0]["gfc"]["kernel"].shape == (480, 128)
    labels = dict(np.load(tmp_path / "train_labels.npz"))
    assert all(np.isfinite(v).all() for v in labels.values())
    assert result["refined_samples_per_s"] > 0


@pytest.mark.parametrize("flag", [["--backgrounds", "bg_dir"], ["--renderer", "pathtrace"]])
def test_unported_options_raise(tmp_path, monkeypatch, flag):
    """The two options that raised until the rendering extras were ported
    now run: one sample each on the CPU (the path tracer at 64², one sample
    a pixel, no bounce; tests/test_torch_pathtrace.py runs it at 256² and
    holds it, and tests/test_torch_backgrounds.py the corpus, against the
    JAX package)."""
    if flag[0] == "--backgrounds":
        bg_dir = tmp_path / "bg_dir"
        bg_dir.mkdir()
        rng = np.random.default_rng(0)
        from renderih_tpu_torch.data.image_io import imwrite

        imwrite(bg_dir / "a.png", rng.integers(0, 256, (300, 200, 3), np.uint8))
        flag = ["--backgrounds", str(bg_dir)]
    else:
        flag = flag + ["--spp", "1", "--bounces", "0"]
        monkeypatch.setattr(synth_gen, "IMG_SIZE", 64)
    size = synth_gen.IMG_SIZE
    out = tmp_path / "out"
    result = synth_gen.main(["--out", str(out), "--n", "1", "--batch", "1", "--device", "cpu",
                             *flag])
    img = np.memmap(out / "train_images.u8", np.uint8, "r", shape=(1, size, size, 3))
    assert result["n"] == 1 and img.std() > 5
