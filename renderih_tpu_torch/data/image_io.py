"""The cv2 calls of the dataset tools and the apps, without cv2.

  imread_rgb(path)             cv.cvtColor(cv.imread(path), cv.COLOR_BGR2RGB)
  imwrite(path, rgb)           cv.imwrite(path, cv.cvtColor(rgb, cv.COLOR_RGB2BGR))
  resize_bilinear_u8(img, wh)  cv.resize(img, wh)              (INTER_LINEAR)
  resize_area_u8(img, wh)      cv.resize(img, wh, interpolation=cv.INTER_AREA)
  warp_affine_u8(img, M, wh)   cv.warpAffine(img, M, dsize=wh) (INTER_LINEAR,
                                                                 border 0)
  rodrigues_np(R)              cv.Rodrigues(R)[0].reshape(3)

Each returns what the cv2 call returns, bit for bit; `imwrite`'s JPEG
decodes to what cv2's file of the same image decodes to. The per-pixel
work (JPEG's Huffman coding, DCTs, chroma resampling and colour
conversion; PNG's row unfiltering; the resamplers) is host C++,
`csrc/host_codec.cpp`, built with g++ at first use into
`build/renderih_tpu_torch/` (`kernels/_build.py:load_host`); a failed
build raises, and there is no Python fallback. PNG's deflate is Python's
`zlib`; BMP is plain numpy. Reading: JPEG baseline and extended
sequential Huffman, 8-bit, grey or three components, any integral
sampling factors, restart markers, and the EXIF orientation that
cv.imread applies; PNG 8-bit grey, grey+alpha, RGB and RGBA, not
interlaced (alpha is dropped, as cv.imread drops it); BMP uncompressed
8-bit palette, 24-bit and 32-bit (the fourth byte dropped), bottom-up or
top-down. Writing: JPEG baseline 4:2:0 at quality 95 (cv.imwrite's
defaults), PNG 8-bit RGB.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from renderih_tpu_torch.kernels import _build

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "hc_jpeg_info": (_I, (_P, _I64, _IP, _IP, _IP, ctypes.c_char_p, _I)),
    "hc_jpeg_decode": (_I, (_P, _I64, _P, _I, _I, ctypes.c_char_p, _I)),
    "hc_png_unfilter": (_I, (_P, _I64, _I64, _I, _P)),
    "hc_resize_bilinear_u8": (_I, (_P, _I, _I, _I, _P, _I, _I)),
    "hc_resize_area_u8": (_I, (_P, _I, _I, _I, _P, _I, _I)),
    "hc_jpeg_encode": (_I, (_P, _I, _I, _I, _P, _I64, ctypes.POINTER(ctypes.c_int64))),
    "hc_warp_affine_u8": (_I, (_P, _I, _I, _I, _P, _P, _I, _I)),
}
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_BMP_INFO_SIZES = (40, 52, 56, 108, 124)  # BITMAPINFOHEADER and its extensions
_JPEG_QUALITY = 95  # cv.imwrite's default


class ImageUnreadableError(FileNotFoundError):
    """The file is neither JPEG, PNG nor BMP: where cv.imread returns None."""


def _lib() -> ctypes.CDLL:
    return _build.load_host("host_codec", _SIGNATURES)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _exif_orientation(data: bytes) -> int:
    """The EXIF orientation tag (1-8) of a JPEG's APP1 segment, 1 if none."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xDA, 0xD9):  # start of scan / end: no more headers
            break
        seglen = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + seglen]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            tiff = seg[6:]
            if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
                return 1
            e = "<" if tiff[:2] == b"II" else ">"
            ifd = struct.unpack(e + "I", tiff[4:8])[0]
            if ifd + 2 > len(tiff):
                return 1
            for k in range(struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]):
                entry = tiff[ifd + 2 + 12 * k:ifd + 14 + 12 * k]
                if len(entry) < 12:
                    break
                if struct.unpack(e + "H", entry[:2])[0] == 0x0112:
                    value = struct.unpack(e + "H", entry[8:10])[0]
                    return value if 1 <= value <= 8 else 1
            return 1
        pos += 2 + seglen
    return 1


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv.imread's EXIF transform: the stored image -> the displayed one."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.transpose(1, 0, 2)
    elif orientation == 6:
        img = img.transpose(1, 0, 2)[:, ::-1]
    elif orientation == 7:
        img = img.transpose(1, 0, 2)[::-1, ::-1]
    elif orientation == 8:
        img = img.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(img)


def _decode_jpeg(data: bytes, path: str) -> np.ndarray:
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.hc_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(nc), err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.hc_jpeg_decode(data, len(data), _ptr(out), w.value, h.value, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return _apply_orientation(out, _exif_orientation(data))


def _decode_png(data: bytes, path: str) -> np.ndarray:
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: corrupt PNG (no IHDR or IDAT)")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}): 8-bit grey, grey+alpha, "
                         "RGB and RGBA, not interlaced")
    cn = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rowbytes = width * cn
    if raw.size < height * (rowbytes + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    raw = np.ascontiguousarray(raw[:height * (rowbytes + 1)])
    pix = np.empty((height, width, cn), np.uint8)
    if _lib().hc_png_unfilter(_ptr(raw), height, rowbytes, cn, _ptr(pix)):
        raise ValueError(f"{path}: corrupt PNG (unknown row filter)")
    if cn <= 2:  # grey (+alpha): replicate, drop alpha
        return np.ascontiguousarray(np.repeat(pix[..., :1], 3, axis=-1))
    return np.ascontiguousarray(pix[..., :3])


def _decode_bmp(data: bytes, path: str) -> np.ndarray:
    """8-bit palette, 24-bit or 32-bit uncompressed BMP -> RGB, as
    cv.imread(IMREAD_COLOR) reads it (palette colours; the fourth byte of a
    32-bit pixel dropped)."""
    if len(data) < 30:
        raise ValueError(f"{path}: truncated BMP header")
    offset, info = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    if info not in _BMP_INFO_SIZES or len(data) < 14 + info:
        raise ValueError(f"{path}: unsupported BMP header of {info} bytes")
    width, height, _, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    clr_used = struct.unpack("<I", data[46:50])[0]
    if bpp not in (8, 24, 32) or compression != 0 or width <= 0 or height == 0:
        raise ValueError(f"{path}: unsupported BMP ({bpp} bits, compression {compression}, "
                         f"{width}x{height}): uncompressed 8-, 24- or 32-bit only")
    rows = abs(height)
    pitch = (width * bpp // 8 + 3) & ~3
    if len(data) < offset + pitch * rows:
        raise ValueError(f"{path}: truncated BMP pixel data")
    raw = np.frombuffer(data, np.uint8, pitch * rows, offset).reshape(rows, pitch)
    if height > 0:  # bottom-up
        raw = raw[::-1]
    if bpp == 8:
        n = clr_used or 256
        palette = np.zeros((256, 4), np.uint8)
        entries = np.frombuffer(data, np.uint8, min(n, 256) * 4, 14 + info).reshape(-1, 4)
        palette[:len(entries)] = entries
        bgr = palette[raw[:, :width]][..., :3]
    else:
        bgr = raw[:, :width * bpp // 8].reshape(rows, width, bpp // 8)[..., :3]
    return np.ascontiguousarray(bgr[..., ::-1])


def imread_rgb(path) -> np.ndarray:
    """uint8 (H, W, 3) RGB of a JPEG, PNG or BMP file, as
    `cv.cvtColor(cv.imread(path), cv.COLOR_BGR2RGB)` returns it.

    Raises FileNotFoundError naming the path if the file is missing, its
    subclass ImageUnreadableError if it is neither JPEG, PNG nor BMP (where
    cv.imread returns None), and ValueError naming it for a file this
    reader does not decode (progressive or arithmetic-coded JPEG, 16-bit or
    interlaced PNG, compressed or 1-, 4- or 16-bit BMP) or a corrupt one."""
    path = str(path)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(f"image missing or unreadable: {path} ({e})") from None
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data, path)
    if data[:8] == _PNG_MAGIC:
        return _decode_png(data, path)
    if data[:2] == b"BM":
        return _decode_bmp(data, path)
    raise ImageUnreadableError(f"image unreadable (neither JPEG, PNG nor BMP): {path}")


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB image as PNG bytes (8-bit truecolour, no
    filter, zlib level 6)."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"png_bytes wants (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (_PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """Baseline JPEG of an RGB uint8 (H, W, 3) image with cv.imwrite's
    defaults (quality 95, 4:2:0, standard Huffman tables; libjpeg-turbo's
    forward path, `csrc/host_codec.cpp:hc_jpeg_encode`)."""
    rgb = _u8(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"JPEG: expected an RGB (H, W, 3) image, got {rgb.shape}")
    h, w = rgb.shape[:2]
    # an MCU's six blocks take at most 6 * 216 bytes of codes, twice that
    # with every byte stuffed
    cap = (-(-h // 16)) * (-(-w // 16)) * 6 * 432 + 1024
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64()
    rc = _lib().hc_jpeg_encode(_ptr(rgb), h, w, _JPEG_QUALITY, _ptr(out), cap, ctypes.byref(n))
    if rc:
        raise ValueError(f"JPEG encode failed ({rc}): {rgb.shape}")
    return out[:n.value].tobytes()


def imwrite(path, img: np.ndarray) -> None:
    """Write an RGB uint8 (H, W, 3) image as
    `cv.imwrite(path, cv.cvtColor(img, cv.COLOR_RGB2BGR))` does with its
    defaults, the format from the suffix: `.png` (lossless), `.jpg` or
    `.jpeg` (`encode_jpeg`). Raises ValueError for another suffix."""
    path = str(path)
    suffix = path.lower().rsplit(".", 1)[-1] if "." in path else ""
    img = _u8(img)
    if suffix == "png":
        data = png_bytes(img)
    elif suffix in ("jpg", "jpeg"):
        data = encode_jpeg(img)
    else:
        raise ValueError(f"imwrite: unsupported suffix of {path} (.png, .jpg, .jpeg)")
    with open(path, "wb") as f:
        f.write(data)


def _u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"expected a uint8 (H, W) or (H, W, C) image, got "
                        f"{img.dtype} {img.shape}")
    return img


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """`cv.resize(img, size)` (INTER_LINEAR) of a uint8 image; size is
    (width, height), as cv2's dsize."""
    img = _u8(img)
    w, h = int(size[0]), int(size[1])
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    if _lib().hc_resize_bilinear_u8(_ptr(img), img.shape[0], img.shape[1], cn,
                                    _ptr(out), h, w):
        raise ValueError(f"resize_bilinear_u8: bad sizes {img.shape} -> {size}")
    return out


def resize_area_u8(img: np.ndarray, size) -> np.ndarray:
    """`cv.resize(img, size, interpolation=cv.INTER_AREA)` of a uint8 image;
    size is (width, height), as cv2's dsize."""
    img = _u8(img)
    w, h = int(size[0]), int(size[1])
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    if _lib().hc_resize_area_u8(_ptr(img), img.shape[0], img.shape[1], cn, _ptr(out), h, w):
        raise ValueError(f"resize_area_u8: bad sizes {img.shape} -> {size}")
    return out


def warp_affine_u8(img: np.ndarray, M: np.ndarray, size) -> np.ndarray:
    """`cv.warpAffine(img, M, dsize=size)` of a uint8 image: bilinear, a
    constant-0 border; M (2, 3) maps source to destination pixels."""
    img = _u8(img)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(6))
    w, h = int(size[0]), int(size[1])
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    if _lib().hc_warp_affine_u8(_ptr(img), img.shape[0], img.shape[1], cn, _ptr(m),
                                _ptr(out), h, w):
        raise ValueError(f"warp_affine_u8: bad sizes {img.shape} -> {size}")
    return out


def rodrigues_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) -> axis-angle (3,) float64, as
    `cv.Rodrigues(R)[0].reshape(3)`: R is first replaced by the nearest
    rotation (U V^T of its SVD), then the angle comes from acos of the
    trace with cv2's branch for angles near 0 and pi."""
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64).reshape(3, 3))
    r = u @ vt
    v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    s = np.sqrt((v @ v) * 0.25)
    c = min(max((r[0, 0] + r[1, 1] + r[2, 2] - 1) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return v * (theta / (2 * s))
    if c > 0:
        return np.zeros(3)
    v = np.array([np.sqrt(max((r[0, 0] + 1) * 0.5, 0.0)),
                  np.sqrt(max((r[1, 1] + 1) * 0.5, 0.0)) * (-1.0 if r[0, 1] < 0 else 1.0),
                  np.sqrt(max((r[2, 2] + 1) * 0.5, 0.0)) * (-1.0 if r[0, 2] < 0 else 1.0)])
    if (abs(v[0]) < abs(v[1]) and abs(v[0]) < abs(v[2])
            and (r[1, 2] > 0) != (v[1] * v[2] > 0)):
        v[2] = -v[2]
    return v * (theta / np.linalg.norm(v))
