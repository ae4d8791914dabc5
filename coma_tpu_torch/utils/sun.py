"""Sun raster files, as Pillow's ``SunImagePlugin`` reads them.

A 32-byte big-endian header (magic 0x59A66A95, width, height, depth, data
length, type, colour-map type and length), an optional colour map (PIL
takes one of at most 1024 bytes, of type 1: all red, then all green, then
all blue; PIL fails on one beside a depth of 1, 24 or 32), then rows padded
to 16 bits. Depth 1 gives "1" (a set bit is black), 4 and 8 "L", or "P"
with a colour map; 24 and 32 "RGB" (BGR and XBGR, or RGB and XRGB for type
3). Types 0, 1, 3, 4 and 5 are raw; type 2
is run-length coded as ``SunRleDecode.c`` codes it (0x80 0x00 a literal
0x80; 0x80 n v, n + 1 copies of v; any other byte itself) into one stream
cut into rows of ``ceil(width * depth / 8)`` bytes, without the raw rows'
padding, as PIL reads it. Data that ends early is refused, as PIL refuses
it.

The run-length decoding has a native twin in ``native/src/image_codecs.cpp``
(``sun_rle_decode``); :func:`rle_decode` picks it, or
:func:`rle_decode_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

MAGIC = 0x59A66A95


def rle_decode_python(data: bytes, pos: int, want: int) -> bytes:
    """``SunRleDecode`` from ``data[pos:]`` until ``want`` bytes are out (a
    run's surplus cut). The reference of ``native/codecs.sun_rle_decode``."""
    out, n = bytearray(), len(data)
    while len(out) < want:
        if pos >= n:
            raise ValueError("image file is truncated")
        byte = data[pos]
        if byte == 0x80:
            if pos + 1 >= n:
                raise ValueError("image file is truncated")
            count = data[pos + 1]
            if count == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= n:
                    raise ValueError("image file is truncated")
                out += bytes([data[pos + 2]]) * (count + 1)
                pos += 3
        else:
            out.append(byte)
            pos += 1
    return bytes(out[:want])


def rle_decode(data: bytes, pos: int, want: int, native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, pos, want)
    return codecs.sun_rle_decode(data, pos, want)


def _be(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "big")


def decode_sun(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A Sun raster file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where PIL refuses
    it."""
    if len(data) < 32 or _be(data, 0) != MAGIC:
        raise NotThisFormat(f"{name}: not a Sun raster file")
    width, height, depth = _be(data, 4), _be(data, 8), _be(data, 12)
    kind, map_type, map_length = _be(data, 20), _be(data, 24), _be(data, 28)
    rawmodes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
                24: ("RGB", "RGB" if kind == 3 else "BGR"),
                32: ("RGB", "RGBX" if kind == 3 else "BGRX")}
    if depth not in rawmodes:
        raise NotThisFormat(f"{name}: a Sun raster of depth {depth}")
    mode, rawmode = rawmodes[depth]
    offset, palette = 32, None
    if map_length:
        if map_length > 1024 or map_type != 1:
            raise NotThisFormat(f"{name}: a Sun colour map PIL does not take")
        entries = np.frombuffer(data[32:32 + map_length], np.uint8)
        offset += map_length
        if mode != "L":
            raise ValueError(f"{name}: a Sun colour map on a {mode} image (PIL fails on it)")
        mode, rawmode = "P", rawmode.replace("L", "P")
        third = entries.size // 3
        palette = np.ascontiguousarray(entries[:3 * third].reshape(3, third).T)
    if kind not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"{name}: Sun raster type {kind} is not read")
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: a Sun raster of {width} x {height} pixels")
    row = (width * depth + 7) // 8
    if kind == 2:
        try:
            raw = rle_decode(data, offset, row * height, native)
        except ValueError as err:
            raise ValueError(f"{name}: Sun raster: {err}") from None
        rows = np.frombuffer(raw, np.uint8).reshape(height, row)
    else:
        stride = (width * depth + 15) // 16 * 2
        if len(data) < offset + stride * (height - 1) + row:
            raise ValueError(f"{name}: Sun raster: image file is truncated")
        body = np.frombuffer(data[offset:offset + stride * height].ljust(stride * height, b"\0"),
                             np.uint8)
        rows = body.reshape(height, stride)
    if depth == 1:
        return Decoded(~np.unpackbits(rows, axis=1)[:, :width].astype(bool), "1")
    if depth == 4:
        nibbles = np.stack([rows >> 4, rows & 15], -1).reshape(height, -1)[:, :width]
        return Decoded(nibbles if mode == "P" else nibbles * np.uint8(17), mode, palette)
    if depth == 8:
        return Decoded(np.ascontiguousarray(rows[:, :width]), mode, palette)
    n = depth // 8
    px = rows[:, :n * width].reshape(height, width, n)
    order = {"RGB": [0, 1, 2], "BGR": [2, 1, 0], "RGBX": [0, 1, 2], "BGRX": [2, 1, 0]}[rawmode]
    return Decoded(np.ascontiguousarray(px[..., order]), "RGB")
