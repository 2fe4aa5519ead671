"""The port's image reader and resamplers (`renderih_tpu_torch/data/
image_io.py`, C++ in `csrc/host_codec.cpp`) against cv2, bit for bit.

cv2 is imported only here (and skipped without it, as the JAX tests do);
the port itself never imports it. The committed fixtures of
`tests/data/torch_codec/` hold cv2's decode, so they are checked without
cv2 too.
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from renderih_tpu_torch.data.image_io import (
    imread_rgb,
    resize_bilinear_u8,
    rodrigues_np,
    warp_affine_u8,
)
from renderih_tpu_torch.kernels import _build

_CODEC = os.path.join(os.path.dirname(__file__), "data", "torch_codec")
_SIZES = [(256, 256), (480, 640), (37, 53)]
_FORMATS = ["jpg420", "jpg444", "jpg422", "jpggray", "jpgrst", "png", "pnggray", "pngrgba"]


@pytest.fixture(scope="module")
def cv():
    return pytest.importorskip("cv2")


def _smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + k) * np.cos(y / 23.0 - k) for k in range(3)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(cv, path, img, fmt):
    q, sf = cv.IMWRITE_JPEG_QUALITY, cv.IMWRITE_JPEG_SAMPLING_FACTOR
    params = {
        "jpg420": [q, 95], "jpg444": [q, 95, sf, cv.IMWRITE_JPEG_SAMPLING_FACTOR_444],
        "jpg422": [q, 90, sf, cv.IMWRITE_JPEG_SAMPLING_FACTOR_422], "jpggray": [q, 95],
        "jpgrst": [q, 95, cv.IMWRITE_JPEG_RST_INTERVAL, 2],
    }.get(fmt, [])
    if fmt in ("jpggray", "pnggray"):
        img = img[..., 0]
    elif fmt == "pngrgba":
        img = np.concatenate([img, img[..., :1] // 2], -1)
    assert cv.imwrite(str(path), img, params)


@pytest.mark.parametrize("fmt", _FORMATS)
@pytest.mark.parametrize("size", _SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_imread_rgb_equals_cv2(cv, tmp_path, kind, size, fmt):
    """JPEG (4:2:0, 4:4:4, 4:2:2, grey, restart markers; noise at q95 is the
    entropy coder's worst case) and PNG (RGB, grey, RGBA: libpng's adaptive
    filters, Paeth rows included), each equal to cv2's decode."""
    rng = np.random.default_rng(zlib.crc32(repr((kind, size, fmt)).encode()))
    img = rng.integers(0, 255, size + (3,), np.uint8) if kind == "noise" else _smooth(*size)
    path = tmp_path / ("img." + fmt[:3])
    _write(cv, path, img, fmt)
    want = cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB)
    got = imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_imread_rgb_applies_exif_orientation(cv, tmp_path, orientation):
    """cv.imread turns a JPEG by its EXIF orientation; so does imread_rgb."""
    rng = np.random.default_rng(orientation)
    ok, buf = cv.imencode(".jpg", rng.integers(0, 255, (40, 64, 3), np.uint8))
    e = "<" if orientation % 2 else ">"
    tiff = ((b"II" if e == "<" else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "HHHIHHI", 1, 0x112, 3, 1, orientation, 0, 0))
    seg = b"Exif\0\0" + tiff
    buf = buf.tobytes()
    path = tmp_path / "exif.jpg"
    path.write_bytes(buf[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + buf[2:])
    want = cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB)
    assert np.array_equal(imread_rgb(path), want)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_CODEC, "*.jpg"))),
                         ids=os.path.basename)
def test_committed_fixtures_equal_stored_cv2_decode(path):
    """The fixtures chip_smoke.py decodes on the card machine (no cv2)."""
    assert np.array_equal(imread_rgb(path), np.load(path[:-4] + ".npz")["rgb"])


def test_imread_rgb_refuses_what_it_cannot_read(cv, tmp_path):
    """Progressive JPEG: ValueError naming the file; a missing or non-image
    file: FileNotFoundError naming it (where cv.imread returns None)."""
    prog = tmp_path / "prog.jpg"
    assert cv.imwrite(str(prog), np.zeros((16, 16, 3), np.uint8), [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="prog.jpg.*progressive"):
        imread_rgb(prog)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        imread_rgb(tmp_path / "missing.png")
    (tmp_path / "text.jpg").write_text("not an image")
    with pytest.raises(FileNotFoundError, match="text.jpg"):
        imread_rgb(tmp_path / "text.jpg")


@pytest.mark.parametrize("shape", [(480, 640, 3), (300, 200, 3), (512, 512, 3), (120, 100, 3),
                                   (37, 53, 3), (480, 640)], ids=str)
def test_resize_bilinear_equals_cv2(cv, shape):
    """cv.resize(INTER_LINEAR) to 256² (the tools' one size; 512² takes
    cv2's INTER_AREA 2x path) and to odd sizes."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 255, shape, np.uint8)
    for size in ((256, 256), (37, 53), (300, 7)):
        assert np.array_equal(resize_bilinear_u8(img, size), cv.resize(img, size)), size


def _fixture_crops():
    """Crop matrices as the tools make them (`cut_img_matrix` of two hands'
    2D points on the fixtures' 512x334 and 480x640 images, ratios 0.8 and
    0.7), then random rotations, shears and far-outside crops to odd sizes.
    test_torch_data_tools.py checks every crop of the real fixtures too."""
    from renderih_tpu_torch.tools.dataset_gen.interhand_gen import cut_img_matrix

    rng = np.random.default_rng(0)
    out = []
    for (h, w), ratio in (((334, 512), 0.8), ((480, 640), 0.8), ((480, 640), 0.7)):
        for _ in range(4):
            c = rng.uniform([0.3 * w, 0.3 * h], [0.7 * w, 0.7 * h])
            pts = [c + rng.normal(0, rng.uniform(5, 80), (21, 2)) for _ in range(2)]
            out.append(((h, w), cut_img_matrix(pts, radio=ratio), (256, 256)))
    for _ in range(16):  # rotations, shears, far-outside crops, odd widths
        h, w = rng.integers(20, 500, 2)
        s, a = rng.uniform(0.2, 3.0), rng.uniform(-3.2, 3.2)
        M = np.array([[s * np.cos(a), -s * np.sin(a) * rng.uniform(0.5, 1.5), rng.uniform(-400, 400)],
                      [s * np.sin(a), s * np.cos(a), rng.uniform(-400, 400)]])
        out.append(((h, w), M, (int(rng.integers(1, 120)), int(rng.integers(1, 120)))))
    return out


@pytest.mark.parametrize("channels", [3, 1])
def test_warp_affine_equals_cv2(cv, channels):
    rng = np.random.default_rng(channels)
    for (h, w), M, size in _fixture_crops():
        img = rng.integers(0, 255, (h, w, channels) if channels == 3 else (h, w), np.uint8)
        got = warp_affine_u8(img, M, size)
        assert np.array_equal(got, cv.warpAffine(img, M, dsize=size)), (h, w, M, size)


def test_rodrigues_np_equals_cv2(cv):
    """Within 1e-6 of cv.Rodrigues, near 0 and pi and off-orthogonal too."""
    rng = np.random.default_rng(0)
    for k in range(400):
        aa = rng.normal(size=3) * (1e-7, 1e-3, 0.5, 1.5, 3.0)[k % 5]
        if k % 40 == 0:
            aa = aa / np.linalg.norm(aa) * np.pi
        R = cv.Rodrigues(aa)[0] + (rng.normal(size=(3, 3)) * 1e-3 if k % 7 == 0 else 0)
        R = R.astype(np.float32) if k % 2 else R
        want = cv.Rodrigues(np.asarray(R, np.float64))[0].reshape(3)
        np.testing.assert_allclose(rodrigues_np(R), want, atol=1e-6)


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """No Python fallback: a compiler that does not exist raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no-such-g"):
        resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), (2, 2))
