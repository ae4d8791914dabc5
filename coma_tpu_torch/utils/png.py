"""A minimal PNG reader and writer; zlib does the rest.

The writer takes 8-bit gray, gray+alpha, RGB and RGBA. The reader also takes
palette images (bit depths 1 to 8) and 16-bit and low-bit gray ones,
non-interlaced, all five filter types. The CLIs read renders, masks and
texture maps and write their images with it, so the port needs no imaging
library. :func:`read_png` returns what PIL holds for the file's mode, and
:func:`to_rgb` and :func:`to_gray` are PIL's ``convert("RGB")`` and
``convert("L")`` of it (alpha is dropped, not composited; gray is ITU-R 601-2
luma in PIL's fixed point).
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


def _unpack_bits(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """Samples of ``depth`` < 8 bits, packed high bits first, -> uint8 (H, count)."""
    bits = np.unpackbits(rows, axis=1)[:, : count * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(rows.shape[0], count, depth) * weights).sum(-1).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W, C): C = 1 gray, 2 gray+alpha, 3 RGB (palette images
    expanded through PLTE, tRNS ignored), 4 RGBA. 16-bit samples keep their
    high byte, except 16-bit gray, which PIL saturates at 255; 1-, 2- and
    4-bit gray is scaled to 0..255."""
    return _read(path, wide_gray=False)


def read_png_gray16(path: str) -> np.ndarray:
    """A gray PNG as ``np.asarray(PIL.Image.open(path))`` gives it: (H, W)
    uint16 at bit depth 16 (a Kinect depth map in mm), uint8 at 8."""
    image = _read(path, wide_gray=True)
    if image.ndim != 3 or image.shape[-1] != 1:
        raise ValueError(f"{path}: not a one-channel gray PNG")
    return image[..., 0]


def _read(path: str, wide_gray: bool) -> np.ndarray:
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, palette = len(_SIGNATURE), None, [], None
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
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    paletted = ctype == 3
    C = 1 if paletted else _CHANNELS.get(ctype)
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if C is None or depth not in allowed or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced gray, RGB(A) and palette PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    if paletted and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    stride = (W * C * depth + 7) // 8
    bpp = max(1, C * depth // 8)            # the filters' byte distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected {H * (stride + 1)}")
    raw = raw.reshape(H, stride + 1)
    kinds = raw[:, 0]
    if stride % bpp == 0 and np.isin(kinds, (0, 1)).all():
        # None and Sub filter each row on its own: all rows at once (the
        # port's writer uses Sub)
        sub = np.cumsum(raw[:, 1:].reshape(H, -1, bpp), axis=1, dtype=np.uint8)  # wraps mod 256
        out = sub.reshape(H, stride) if (kinds == 1).all() else np.where(
            (kinds == 1)[:, None], sub.reshape(H, stride), raw[:, 1:])
    else:
        out = np.empty((H, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(H):
            prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    if depth == 16:
        samples = out.reshape(H, W * C, 2)
        if ctype == 0:                      # PIL's I;16 -> L / RGB saturates
            wide = samples[..., 0].astype(np.uint16) << 8 | samples[..., 1]
            out = wide if wide_gray else np.minimum(wide, 255).astype(np.uint8)
        else:
            out = samples[..., 0]
    elif depth < 8:
        out = _unpack_bits(out, depth, W * C)
        if not paletted:
            out = out * np.uint8(255 // ((1 << depth) - 1))
    if paletted:
        if out.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the {len(palette)} PLTE entries")
        return palette[out.reshape(H, W)]
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
