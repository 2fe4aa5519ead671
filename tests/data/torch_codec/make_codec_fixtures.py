"""Write the JPEG fixtures of this directory and cv2's decode of each.

  python tests/data/torch_codec/make_codec_fixtures.py

Each `<name>.jpg` is written by cv.imwrite from seeded numpy and
`<name>.npz` holds `rgb`, cv.cvtColor(cv.imread(<name>.jpg), COLOR_BGR2RGB),
so a machine without cv2 can hold `data/image_io.py:imread_rgb` to it
(`tests/test_torch_image_io.py`, `chip_smoke.py` phase 22). Needs cv2
(libjpeg-turbo); the files written here came from OpenCV 5.0.0 with
libjpeg-turbo 3.1.2.
"""

import os

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


if __name__ == "__main__":
    main()
