"""The port's background corpus (`renderih_tpu_torch/render/backgrounds.py:
BackgroundCorpus`, cv2-free) against the JAX package's, which loads with
cv2: the image stack bit for bit, and sampling on JAX's own draws."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.render.backgrounds import BackgroundCorpus as JaxCorpus
from renderih_tpu.render.backgrounds import random_background as jax_random_background
from renderih_tpu_torch.render.backgrounds import BackgroundCorpus, random_background

_CODEC = os.path.join(os.path.dirname(__file__), "data", "torch_codec")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """PNG, JPEG (4:2:0 and grey) and BMP (24-bit from cv2, 8-bit palette,
    32-bit top-down) files of several sizes, landscape and portrait, below
    and above the corpus size (every INTER_AREA regime at 64: 128 -> 64 the
    integer path, 100 and 75 the area tables, 40 and 17 upscaling), one
    upper-case suffix, one file of another suffix and one unreadable file."""
    cv = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("bg")
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:150, 0:200]
    smooth = np.clip(np.stack([128 + 100 * np.sin(x / 9.0 + k) * np.cos(y / 13.0) for k in
                               range(3)], -1), 0, 255).astype(np.uint8)
    files = {"a.png": rng.integers(0, 256, (100, 130, 3), np.uint8),
             "b.jpg": smooth, "c.JPEG": rng.integers(0, 256, (128, 128, 3), np.uint8),
             "d.bmp": rng.integers(0, 256, (75, 60, 3), np.uint8),
             "e.png": rng.integers(0, 256, (40, 40, 3), np.uint8),
             "f.jpg": smooth[:57, :93, 0]}
    for name, img in files.items():
        assert cv.imwrite(str(d / name), img)
    for name in ("bmp8_palette_21x30.bmp", "bmp32_topdown_17x9.bmp"):
        shutil.copy(os.path.join(_CODEC, name), d / name)
    (d / "broken.jpg").write_text("not an image")
    (d / "notes.txt").write_text("skipped by its suffix")
    return d


def test_corpus_stack_equals_jax_bit_for_bit(corpus_dir):
    corpus, jax_corpus = BackgroundCorpus(str(corpus_dir), size=64), JaxCorpus(str(corpus_dir), 64)
    assert corpus.images.shape == (8, 64, 64, 3) and corpus.images.dtype == torch.float32
    assert np.array_equal(corpus.images.numpy(), np.asarray(jax_corpus.images))
    limited = BackgroundCorpus(str(corpus_dir), size=32, limit=3)
    assert np.array_equal(limited.images.numpy(), np.asarray(JaxCorpus(str(corpus_dir), 32, 3).images))


def test_corpus_refusals_match_jax(tmp_path, corpus_dir):
    with pytest.raises(ValueError, match="no background images"):
        BackgroundCorpus(str(tmp_path))
    (tmp_path / "x.png").write_text("junk")
    with pytest.raises(ValueError, match="no readable background images"):
        BackgroundCorpus(str(tmp_path))
    corpus = BackgroundCorpus(str(corpus_dir), size=64)
    with pytest.raises(ValueError, match="corpus of 64"):
        random_background(torch.Generator().manual_seed(0), 2, 32, corpus=corpus)


def test_sample_equals_jax_on_its_draws(corpus_dir):
    """Feed the draws `BackgroundCorpus.sample(key, bs)` makes from its key
    (index, flip, gain) to the port's transform."""
    corpus, jax_corpus = BackgroundCorpus(str(corpus_dir), size=64), JaxCorpus(str(corpus_dir), 64)
    key, bs = jax.random.PRNGKey(4), 16
    k_idx, k_flip, k_gain = jax.random.split(key, 3)
    idx = jax.random.randint(k_idx, (bs,), 0, jax_corpus.images.shape[0])
    flip = jax.random.bernoulli(k_flip, 0.5, (bs,))
    gain = jax.random.uniform(k_gain, (bs, 1, 1, 1), minval=0.7, maxval=1.2)
    got = corpus.transform(torch.from_numpy(np.asarray(idx)).long(),
                           torch.from_numpy(np.asarray(flip)), torch.from_numpy(np.asarray(gain)))
    want = np.asarray(jax_random_background(key, bs, 64, corpus=jax_corpus))
    assert 0 < np.asarray(flip).sum() < bs
    assert np.abs(got.numpy() - want).max() <= 1e-7


def test_background_corpus_samples_real_images(tmp_path):
    """The JAX test's check: a corpus of three PNGs; every sample is one of
    them, mirrored or not, times a near-constant gain."""
    from renderih_tpu_torch.data.image_io import imwrite

    rng = np.random.default_rng(0)
    for i in range(3):
        imwrite(tmp_path / f"bg{i}.png", rng.integers(0, 255, (40 + 10 * i, 70, 3), np.uint8))
    corpus = BackgroundCorpus(str(tmp_path), size=32)
    assert corpus.images.shape == (3, 32, 32, 3)
    b = random_background(torch.Generator().manual_seed(1), 8, 32, corpus=corpus).numpy()
    assert b.shape == (8, 32, 32, 3) and b.min() >= 0.0 and b.max() <= 1.0 + 1e-6
    imgs = corpus.images.numpy()
    cands = np.concatenate([imgs, imgs[:, :, ::-1]], axis=0)
    for s in b:
        ratios = [np.std((s / np.maximum(c, 1e-3))[c > 0.05]) for c in cands]
        assert min(ratios) < 0.05
