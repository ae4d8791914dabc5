"""Blizzard texture files (BLP1, BLP2), as Pillow's ``BlpImagePlugin``
reads them (mip level 0 only).

BLP1: compression, an alpha flag (any nonzero alpha depth), the size, the
encoding; then 16 mip offsets and 16 lengths. Compression 1 with encoding
4 or 5 is a 256-entry BGRA palette followed at once by the indices of the
first mip (PIL does not seek to its offset); compression 0 is JPEG: a
shared header joined to the first mip's data, decoded (``utils/jpeg.py``),
converted to RGB and read back as BGR, so red and blue trade places.

BLP2: compression 1 only; encoding 1 is palette indices at the first
mip's offset, encoding 2 DXT1, DXT3 or DXT5 blocks by the alpha encoding
(0, 1, 7), decoded with PIL's own Python decoders: 5-6-5 colours widened
by a shift alone (no bit replication, unlike ``utils/dds.py``'s BCn), DXT1
black (and transparent) for index 3 where ``c0 <= c1``. Encoding 3 (raw
BGRA) and every other value is refused, as PIL refuses it.

The mode is "RGBA" with the alpha flag, else "RGB", and PIL reads the
decoded bytes as one stream of ``width`` pixels a row: block rows of a
width that is not a multiple of 4 shear, and 4-byte DXT3/DXT5 pixels
without the alpha flag are read 3 bytes at a time, as PIL reads them.

The DXT blocks decode in ``native/src/bcn_decode.cpp`` (``blp_dxt_decode``)
where ``g++`` builds it; :func:`dxt_decode_python` is its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

# alpha encoding -> (name, block bytes)
_DXT = {0: ("DXT1", 8), 1: ("DXT3", 16), 7: ("DXT5", 16)}


def _le(data: bytes, at: int, signed: bool = False) -> int:
    return int.from_bytes(data[at:at + 4], "little", signed=signed)


def _colours(blocks: np.ndarray, at: int) -> tuple:
    """The two 5-6-5 endpoints of each block at byte ``at``: (c0, c1) as
    ints and (B, 2, 3) RGB widened by a shift."""
    c = blocks[:, at:at + 4].astype(np.int32)
    c0, c1 = c[:, 0] | c[:, 1] << 8, c[:, 2] | c[:, 3] << 8
    rgb = np.stack([np.stack([(v >> 11 & 31) << 3, (v >> 5 & 63) << 2, (v & 31) << 3], -1)
                    for v in (c0, c1)], 1)
    return c0, c1, rgb


def _indices(blocks: np.ndarray, at: int, bits: int, count: int) -> np.ndarray:
    """(B, 16) fields of ``bits`` bits from the little-endian word of
    ``count`` bytes at ``at``, pixel 0 lowest."""
    word = np.zeros(blocks.shape[0], np.uint64)
    for k in range(count):
        word |= blocks[:, at + k].astype(np.uint64) << np.uint64(8 * k)
    shifts = np.arange(16, dtype=np.uint64) * np.uint64(bits)
    return ((word[:, None] >> shifts) & np.uint64((1 << bits) - 1)).astype(np.int32)


def dxt_decode_python(data: bytes, fmt: str, width: int, height: int, alpha: bool) -> bytes:
    """PIL's ``decode_dxt1/3/5`` over every block row: the bytes PIL hands its
    raw decoder (block rows of 4 lines of ``4 * ceil(width / 4)`` pixels;
    RGB triples for DXT1 without alpha, else RGBA). The reference of
    ``native/codecs.blp_dxt_decode``."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    size = 8 if fmt == "DXT1" else 16
    blocks = np.frombuffer(data, np.uint8, bw * bh * size).reshape(bw * bh, size)
    at = 0 if fmt == "DXT1" else 8
    c0, c1, ends = _colours(blocks, at)
    code = _indices(blocks, at + 4, 2, 4)
    four = (c0 > c1)[:, None] if fmt == "DXT1" else np.ones((len(blocks), 1), bool)
    e0, e1 = ends[:, None, 0], ends[:, None, 1]
    third = np.where(four[..., None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    fourth = np.where(four[..., None], (2 * e1 + e0) // 3, 0)
    rgb = np.select([code[..., None] == k for k in range(4)],
                    [np.broadcast_to(v, code.shape + (3,)) for v in (e0, e1, third, fourth)])
    if fmt == "DXT1":
        a = np.where((code == 3) & ~four, 0, 255)
    elif fmt == "DXT3":
        a = _indices(blocks, 0, 4, 8) * 17
    else:
        a0, a1 = blocks[:, :1].astype(np.int32), blocks[:, 1:2].astype(np.int32)
        k = _indices(blocks, 2, 3, 6)
        eight = ((8 - k) * a0 + (k - 1) * a1) // 7
        six = np.select([k == 6, k == 7], [0, 255], ((6 - k) * a0 + (k - 1) * a1) // 5)
        a = np.select([k == 0, k == 1],
                      [np.broadcast_to(a0, k.shape), np.broadcast_to(a1, k.shape)],
                      np.where(a0 > a1, eight, six))
    px = np.concatenate([rgb, a[..., None]], -1)
    if fmt == "DXT1" and not alpha:
        px = px[..., :3]
    px = px.astype(np.uint8).reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.tobytes()


def dxt_decode(data: bytes, fmt: str, width: int, height: int, alpha: bool, native=None) -> bytes:
    """:func:`dxt_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.bcn_available()
    if not native:
        return dxt_decode_python(data, fmt, width, height, alpha)
    return codecs.blp_dxt_decode(data, fmt, width, height, alpha)


def _palette(data: bytes, at: int) -> np.ndarray:
    entries = np.frombuffer(data[at:at + 1024], np.uint8)
    if entries.size < 1024:
        raise ValueError("truncated file read (the palette)")
    return entries.reshape(256, 4)


def _indexed(data: bytes, at: int, length: int, palette: np.ndarray, alpha: bool) -> bytes:
    """``_read_bgra``: palette entries (B, G, R, A) of ``length`` indices at
    ``at``, as RGB(A)."""
    idx = np.frombuffer(data[at:at + length], np.uint8)
    if idx.size < length:
        raise ValueError("truncated file read (the indices)")
    return palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]].tobytes()


def decode_blp(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A BLP file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2") or len(data) < (24 if magic == b"BLP1" else 20):
        raise NotThisFormat(f"{name}: not a BLP file")
    compression = _le(data, 4, signed=True)
    if magic == b"BLP1":
        alpha = _le(data, 8) != 0
        width, height = _le(data, 12), _le(data, 16)
        encoding, header = _le(data, 20, signed=True), 28
    else:
        encoding, alpha, alpha_encoding = (int.from_bytes(data[k:k + 1], "little", signed=True)
                                           for k in (8, 9, 10))
        alpha = alpha != 0
        width, height, header = _le(data, 12), _le(data, 16), 20
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: a BLP of {width} x {height} pixels")
    mode = "RGBA" if alpha else "RGB"
    try:
        raw, bands = _decode(data, magic, compression, encoding, alpha,
                             None if magic == b"BLP1" else alpha_encoding, width, height, header,
                             name, native)
    except ValueError as err:
        raise ValueError(f"{name}: BLP: {err}") from None
    bands = bands or len(mode)
    if len(raw) < width * height * bands:
        raise ValueError(f"{name}: BLP: not enough image data")
    pixels = np.frombuffer(raw, np.uint8, width * height * bands).reshape(height, width, bands)
    if bands < len(mode):                       # PIL's "BGR" raw mode into "RGBA": opaque
        pixels = np.concatenate([pixels, np.full((height, width, 1), 255, np.uint8)], -1)
    return Decoded(np.ascontiguousarray(pixels), mode)


def _decode(data, magic, compression, encoding, alpha, alpha_encoding, width, height, header,
            name, native) -> tuple:
    """The bytes PIL hands its raw decoder for the first mip, and the bytes
    a pixel they hold where that is not the mode's (0)."""
    if len(data) < header + 128:
        raise ValueError("truncated BLP file (the mip tables)")
    offsets = np.frombuffer(data, "<u4", 16, header)
    lengths = np.frombuffer(data, "<u4", 16, header + 64)
    pos = header + 128
    if magic == b"BLP1":
        if compression == 0:
            return _jpeg(data, pos, int(offsets[0]), int(lengths[0]), name), 3
        if compression != 1:
            raise ValueError(f"compression {compression} is not one PIL reads")
        if encoding not in (4, 5):
            raise ValueError(f"BLP1 encoding {encoding} is not one PIL reads")
        return _indexed(data, pos + 1024, int(lengths[0]), _palette(data, pos), alpha), 0
    palette = _palette(data, pos)
    if compression != 1:
        raise ValueError(f"BLP2 compression {compression} is not one PIL reads")
    if encoding == 1:
        return _indexed(data, int(offsets[0]), int(lengths[0]), palette, alpha), 0
    if encoding != 2:
        raise ValueError(f"BLP2 encoding {encoding} is not one PIL reads (raw BGRA included)")
    if alpha_encoding not in _DXT:
        raise ValueError(f"alpha encoding {alpha_encoding} is not one PIL reads")
    fmt, size = _DXT[alpha_encoding]
    need = (width + 3) // 4 * size * ((height + 3) // 4)
    blocks = data[int(offsets[0]):int(offsets[0]) + need]
    if len(blocks) < need:
        raise ValueError("truncated file read (the blocks)")
    return dxt_decode(blocks, fmt, width, height, alpha, native), 0


def _jpeg(data: bytes, pos: int, offset: int, length: int, name: str) -> bytes:
    """``_decode_jpeg_stream``: the shared header and the first mip as one
    JPEG, its RGB read back as BGR."""
    from coma_tpu_torch.utils import jpeg
    from coma_tpu_torch.utils.modes import cmyk_to_rgb

    size = _le(data, pos)
    head = data[pos + 4:pos + 4 + size]
    start = max(pos + 4 + size, offset)
    body = data[start:start + length]
    if len(head) < size or len(data) < start or len(body) < length:
        raise ValueError("truncated file read (the JPEG data)")
    if not (head + body).startswith(b"\xff\xd8\xff"):
        raise ValueError("the JPEG data is not a JPEG file")
    pixels = jpeg.decode_jpeg(head + body, name)
    if pixels.shape[-1] == 1:
        rgb = np.repeat(pixels, 3, -1)
    elif pixels.shape[-1] == 4:
        rgb = cmyk_to_rgb(pixels)
    else:
        rgb = pixels
    return np.ascontiguousarray(rgb[..., ::-1]).tobytes()
