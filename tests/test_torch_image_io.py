"""The port's image reader, writer and resamplers (`renderih_tpu_torch/
data/image_io.py`, C++ in `csrc/host_codec.cpp`) against cv2, bit for bit.

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
    ImageUnreadableError,
    encode_jpeg,
    imread_rgb,
    imwrite,
    resize_area_u8,
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


# (source side, destination side): the fast integer path (512, 768 -> 256;
# 96 -> 48), the area tables (300, 257, 333 -> ...), upscaling (100 -> 256,
# 37 -> 64) and an equal size (a copy)
_AREA_CASES = [(512, 256), (768, 256), (96, 48), (300, 256), (257, 64), (333, 256),
               (100, 256), (37, 64), (256, 256)]


@pytest.mark.parametrize("channels", [3, 1, 4])
@pytest.mark.parametrize("case", _AREA_CASES, ids=lambda c: f"{c[0]}to{c[1]}")
def test_resize_area_equals_cv2(cv, case, channels):
    """cv.resize(INTER_AREA) in each of its regimes, noise and smooth
    images, square (BackgroundCorpus's crops) and not."""
    s, d = case
    rng = np.random.default_rng(s * 7 + d + channels)
    shape = (s, s) if channels == 1 else (s, s, channels)
    smooth = _smooth(s, s)[..., :1].repeat(4, -1)[..., :channels].reshape(shape)
    for img in (rng.integers(0, 256, shape, np.uint8), smooth):
        assert np.array_equal(resize_area_u8(img, (d, d)),
                              cv.resize(img, (d, d), interpolation=cv.INTER_AREA))
    img = rng.integers(0, 256, (s, s + 13) + shape[2:], np.uint8)
    for size in ((d, d + 5), (max(1, d // 3), d)):
        assert np.array_equal(resize_area_u8(img, size),
                              cv.resize(img, size, interpolation=cv.INTER_AREA)), size


def _bmp_bytes(img_bgr: np.ndarray, bpp: int, top_down: bool, palette=None) -> bytes:
    """An uncompressed BMP (BITMAPINFOHEADER): 8-bit indices into `palette`
    ((n, 4) BGRA), or 24-/32-bit BGR(A) pixels."""
    h, w = img_bgr.shape[:2]
    pitch = (w * bpp // 8 + 3) & ~3
    rows = img_bgr if top_down else img_bgr[::-1]
    body = np.zeros((h, pitch), np.uint8)
    body[:, :w * bpp // 8] = rows.reshape(h, -1)
    pal = b"" if palette is None else palette.astype(np.uint8).tobytes()
    offset = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, body.size,
                       2835, 2835, 0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset) + info + pal
            + body.tobytes())


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("bpp", [8, 24, 32])
def test_bmp_decode_equals_cv2(cv, tmp_path, bpp, top_down):
    """BMP 8-bit palette (a full and a short palette), 24- and 32-bit, both
    row orders, odd widths (row padding): imread_rgb equals cv.imread."""
    rng = np.random.default_rng(bpp + top_down)
    for h, w in ((37, 53), (16, 3), (1, 1)):
        if bpp == 8:
            for n in (256, 17):
                palette = rng.integers(0, 256, (n, 4), np.uint8)
                idx = rng.integers(0, n, (h, w, 1), np.uint8)
                path = tmp_path / f"p{n}_{h}x{w}.bmp"
                path.write_bytes(_bmp_bytes(idx, 8, top_down, palette))
                want = cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB)
                assert np.array_equal(imread_rgb(path), want), (n, h, w)
        else:
            img = rng.integers(0, 256, (h, w, bpp // 8), np.uint8)
            path = tmp_path / f"c{h}x{w}.bmp"
            path.write_bytes(_bmp_bytes(img, bpp, top_down))
            want = cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB)
            assert np.array_equal(imread_rgb(path), want), (h, w)


def test_bmp_written_by_cv2_and_refused_variants(cv, tmp_path):
    """cv.imwrite's own BMPs (24-bit colour, 8-bit grey palette) read back
    as cv.imread reads them; a compressed or 16-bit BMP raises ValueError,
    a file of no known format ImageUnreadableError (cv.imread: None)."""
    rng = np.random.default_rng(5)
    for img in (rng.integers(0, 256, (45, 31, 3), np.uint8), rng.integers(0, 256, (20, 9), np.uint8)):
        path = tmp_path / "cv.bmp"
        assert cv.imwrite(str(path), img)
        assert np.array_equal(imread_rgb(path), cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB))
    data = bytearray(_bmp_bytes(rng.integers(0, 256, (4, 4, 3), np.uint8), 24, False))
    for field, value in ((30, 1), (28, 16)):  # compression RLE8; 16 bits a pixel
        bad = bytearray(data)
        struct.pack_into("<I" if field == 30 else "<H", bad, field, value)
        (tmp_path / "bad.bmp").write_bytes(bytes(bad))
        with pytest.raises(ValueError, match="bad.bmp"):
            imread_rgb(tmp_path / "bad.bmp")
    (tmp_path / "junk.bmp").write_bytes(b"\x00" * 64)
    assert cv.imread(str(tmp_path / "junk.bmp")) is None
    with pytest.raises(ImageUnreadableError, match="junk.bmp"):
        imread_rgb(tmp_path / "junk.bmp")


def test_png_round_trip(cv, tmp_path):
    """imwrite's PNG reads back bit for bit, by the port and by cv2."""
    rng = np.random.default_rng(6)
    for i, shape in enumerate(((33, 47, 3), (1, 1, 3), (19, 8, 3))):
        rgb = rng.integers(0, 256, shape, np.uint8)
        path = tmp_path / f"a{i}.{'PNG' if i else 'png'}"
        imwrite(path, rgb)
        assert np.array_equal(imread_rgb(path), rgb)
        assert np.array_equal(cv.cvtColor(cv.imread(str(path)), cv.COLOR_BGR2RGB), rgb)
    with pytest.raises(ValueError, match="suffix"):
        imwrite(tmp_path / "a.tif", rgb)
    with pytest.raises(ValueError, match="uint8"):
        imwrite(tmp_path / "g.png", rgb[..., 0])


def _jpeg_cases():
    rng = np.random.default_rng(7)
    cases = [("noise_256", rng.integers(0, 256, (256, 256, 3), np.uint8)),
             ("noise_37x53", rng.integers(0, 256, (37, 53, 3), np.uint8)),
             ("smooth_240x320", _smooth(240, 320)), ("smooth_17x33", _smooth(17, 33)),
             ("flat_9x300", np.full((9, 300, 3), 255, np.uint8)),
             ("noise_1x1", rng.integers(0, 256, (1, 1, 3), np.uint8))]
    for path in sorted(glob.glob(os.path.join(_CODEC, "*.jpg"))):
        rgb = np.load(path[:-4] + ".npz")["rgb"]
        cases.append((os.path.basename(path)[:-4], rgb))
    return cases


@pytest.mark.parametrize("name,rgb", _jpeg_cases(), ids=[c[0] for c in _jpeg_cases()])
def test_jpeg_encode_decodes_as_cv2s(cv, tmp_path, name, rgb):
    """imwrite's JPEG, decoded by imread_rgb, equals cv.imwrite's JPEG of
    the same image decoded the same way, bit for bit, on noise (the
    entropy coder's worst case), smooth and flat images, odd sizes (the
    edge padding and dummy blocks) and the decoded codec fixtures; the
    files are equal byte for byte too."""
    imwrite(tmp_path / "port.jpg", rgb)
    assert cv.imwrite(str(tmp_path / "cv.jpg"), cv.cvtColor(rgb, cv.COLOR_RGB2BGR))
    got, want = imread_rgb(tmp_path / "port.jpg"), imread_rgb(tmp_path / "cv.jpg")
    assert np.array_equal(got, want)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "cv.jpg").read_bytes()
    assert np.array_equal(cv.cvtColor(cv.imread(str(tmp_path / "port.jpg")), cv.COLOR_BGR2RGB), got)


def test_jpeg_refuses_what_it_does_not_write():
    rgb = np.random.default_rng(8).integers(0, 256, (24, 40, 3), np.uint8)
    for bad in (rgb[..., 0], np.concatenate([rgb, rgb[..., :1]], -1)):
        with pytest.raises(ValueError, match="RGB"):
            encode_jpeg(bad)
    with pytest.raises(TypeError, match="uint8"):
        encode_jpeg(rgb.astype(np.float32))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_CODEC, "area_*.npz"))),
                         ids=os.path.basename)
def test_committed_area_fixtures_equal_stored_cv2_resize(path):
    """The INTER_AREA fixtures chip_smoke.py checks on the card machine."""
    f = np.load(path)
    assert np.array_equal(resize_area_u8(f["src"], f["out"].shape[1::-1]), f["out"])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(_CODEC, "*.bmp"))),
                         ids=os.path.basename)
def test_committed_bmp_fixtures_equal_stored_cv2_decode(path):
    assert np.array_equal(imread_rgb(path), np.load(path[:-4] + ".npz")["rgb"])


def test_committed_jpeg_encode_fixtures_equal_cv2s_bytes():
    """imwrite's JPEG of each stored source equals the stored cv2 file
    byte for byte (what chip_smoke.py checks where cv2 is missing)."""
    f = np.load(os.path.join(_CODEC, "jpeg_encode.npz"))
    n = len([k for k in f.files if k.startswith("src_")])
    assert n >= 5
    for i in range(n):
        assert encode_jpeg(f[f"src_{i}"]) == f[f"jpg_{i}"].tobytes(), i
