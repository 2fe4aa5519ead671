"""Write the codec fixtures of this directory and cv2's result for each.

  python tests/data/torch_codec/make_codec_fixtures.py

Each `<name>.jpg` is written by cv.imwrite from seeded numpy and
`<name>.npz` holds `rgb`, cv.cvtColor(cv.imread(<name>.jpg), COLOR_BGR2RGB),
so a machine without cv2 can hold `data/image_io.py:imread_rgb` to it
(`tests/test_torch_image_io.py`, `chip_smoke.py` phases 22 and 23). The
same holds for each `<name>.bmp` (8-bit palette, 24-bit, 32-bit top-down).
Each `area_<src>to<dst>.npz` holds a seeded `src` and `out`,
cv.resize(src, (dst, dst), interpolation=cv.INTER_AREA), one for each of
cv.resize's INTER_AREA regimes (the integer factor, the area tables,
upscaling). `jpeg_encode.npz` holds seeded RGB sources `src_<i>` and
cv2's JPEG of each, `jpg_<i>` (cv.imencode('.jpg', BGR) with its defaults:
quality 95, 4:2:0), against which `data/image_io.py:imwrite` is held where
cv2 is missing. Needs cv2 (libjpeg-turbo); the files written here came from
OpenCV 5.0.0 with libjpeg-turbo 3.1.2.
"""

import os
import struct

import cv2 as cv
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + k) * np.cos(y / 23.0 - k) for k in range(3)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    rng = np.random.default_rng(2026)
    q = cv.IMWRITE_JPEG_QUALITY
    sf = cv.IMWRITE_JPEG_SAMPLING_FACTOR
    cases = {
        "noise_256_q95_420": (rng.integers(0, 255, (256, 256, 3), np.uint8), [q, 95]),
        "smooth_240x320_q95_420": (smooth(240, 320), [q, 95]),
        "noise_37x53_q95_444": (rng.integers(0, 255, (37, 53, 3), np.uint8),
                                [q, 95, sf, cv.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
        "noise_61x45_q90_422": (rng.integers(0, 255, (61, 45, 3), np.uint8),
                                [q, 90, sf, cv.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
        "smooth_50x70_q85_gray": (smooth(50, 70)[..., 0], [q, 85]),
        "noise_96x128_q95_420_rst": (rng.integers(0, 255, (96, 128, 3), np.uint8),
                                     [q, 95, cv.IMWRITE_JPEG_RST_INTERVAL, 3]),
    }
    for name, (img, params) in cases.items():
        path = os.path.join(HERE, name + ".jpg")
        assert cv.imwrite(path, img, params)
        rgb = cv.cvtColor(cv.imread(path), cv.COLOR_BGR2RGB)
        np.savez_compressed(os.path.join(HERE, name + ".npz"), rgb=rgb)


def bmp_bytes(img_bgr, bpp, top_down, palette=None):
    """An uncompressed BMP: 8-bit indices into `palette` ((n, 4) BGRA) or
    24-/32-bit pixels."""
    h, w = img_bgr.shape[:2]
    pitch = (w * bpp // 8 + 3) & ~3
    body = np.zeros((h, pitch), np.uint8)
    body[:, :w * bpp // 8] = (img_bgr if top_down else img_bgr[::-1]).reshape(h, -1)
    pal = b"" if palette is None else palette.tobytes()
    offset = 54 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, body.size,
                       2835, 2835, 0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset) + info + pal
            + body.tobytes())


def main_bmp_area():
    rng = np.random.default_rng(2027)
    bmps = {
        "bmp8_palette_21x30": bmp_bytes(rng.integers(0, 40, (21, 30, 1), np.uint8), 8, False,
                                        rng.integers(0, 256, (40, 4), np.uint8)),
        "bmp24_37x53": bmp_bytes(rng.integers(0, 256, (37, 53, 3), np.uint8), 24, False),
        "bmp32_topdown_17x9": bmp_bytes(rng.integers(0, 256, (17, 9, 4), np.uint8), 32, True),
    }
    for name, data in bmps.items():
        path = os.path.join(HERE, name + ".bmp")
        with open(path, "wb") as f:
            f.write(data)
        rgb = cv.cvtColor(cv.imread(path), cv.COLOR_BGR2RGB)
        np.savez_compressed(os.path.join(HERE, name + ".npz"), rgb=rgb)
    for s, d in ((96, 48), (60, 20), (100, 64), (37, 64)):
        src = rng.integers(0, 256, (s, s, 3), np.uint8)
        out = cv.resize(src, (d, d), interpolation=cv.INTER_AREA)
        np.savez_compressed(os.path.join(HERE, f"area_{s}to{d}.npz"), src=src, out=out)
    sources = [rng.integers(0, 256, (64, 48, 3), np.uint8),
               rng.integers(0, 256, (37, 53, 3), np.uint8), smooth(120, 160), smooth(256, 256),
               smooth(9, 300)]
    arrays = {}
    for i, src in enumerate(sources):
        ok, jpg = cv.imencode(".jpg", cv.cvtColor(src, cv.COLOR_RGB2BGR))
        assert ok
        arrays[f"src_{i}"], arrays[f"jpg_{i}"] = src, jpg.reshape(-1)
    np.savez_compressed(os.path.join(HERE, "jpeg_encode.npz"), **arrays)


if __name__ == "__main__":
    main()
    main_bmp_area()
