"""A minimal PNG reader and writer: 8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, all five filter types; zlib does the rest.

The inpaint CLI reads renders and masks and writes its images with it, so
the port needs no imaging library. :func:`to_rgb` and :func:`to_gray` are
PIL's ``convert("RGB")`` and ``convert("L")`` for these modes (alpha is
dropped, not composited; gray is ITU-R 601-2 luma in PIL's fixed point).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type -> channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 1, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H, W) or (H, W, C) image, C in 1..4, every row
    filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"PNG writer takes 1 to 4 channels, got {C}")
    x = img.reshape(H, W * C)
    a = np.zeros_like(x)                     # left neighbour (bpp bytes back)
    a[:, C:] = x[:, :-C]
    b = np.zeros_like(x)                     # the row above
    b[1:] = x[:-1]
    c = np.zeros_like(x)                     # above-left
    c[1:, C:] = x[:-1, :-C]
    predictor = {
        0: lambda: np.zeros_like(x),
        1: lambda: a,
        2: lambda: b,
        3: lambda: ((a.astype(np.uint16) + b) // 2).astype(np.uint8),
        4: lambda: _paeth(a, b, c),
    }[filter_type]()
    filtered = x - predictor                 # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if ftype == 0:
        return row
    if ftype == 1:
        return (np.cumsum(row.reshape(-1, bpp).astype(np.uint32), axis=0) & 0xFF) \
            .astype(np.uint8).reshape(-1)
    if ftype == 2:
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    out = [0] * len(row)
    f, up = row.tolist(), prior.tolist()
    for i in range(len(f)):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (left + up[i]) >> 1
        else:
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
        out[i] = (f[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W, C): C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray/RGB(A), non-interlaced PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected {H * (stride + 1)}")
    raw = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, C)
    return out.reshape(H, W, C)


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W, 3): gray is repeated, alpha dropped."""
    return np.repeat(image[..., :1], 3, axis=-1) if image.shape[-1] <= 2 else image[..., :3]


def to_gray(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W): PIL's ``L = (19595 R + 38470 G + 7471 B + 2^15) >> 16``."""
    if image.shape[-1] <= 2:
        return image[..., 0]
    rgb = image[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
