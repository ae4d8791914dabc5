"""Quite OK Image (QOI) files, as Pillow's ``QoiImagePlugin`` reads them.

A 14-byte header (``qoif``, big-endian width and height, the channel count,
a colourspace byte that is ignored), then the opcodes of
``QoiDecoder``: RGB and RGBA literals, an index into the 64 pixels last
seen by ``(3 r + 5 g + 7 b + 11 a) % 64`` (a slot never written gives
transparent black), the DIFF and LUMA deltas modulo 256, and runs of the
previous pixel, which start as opaque black. Three channels give "RGB",
any other count "RGBA". A stream that ends before the image is full is
refused, as PIL refuses it.

The opcode loop has a native twin in ``native/src/image_codecs.cpp``
(``qoi_decode``); :func:`decode_ops` picks it, or :func:`decode_ops_python`,
its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat


def decode_ops_python(data: bytes, pos: int, pixels: int, channels: int) -> bytes:
    """``QoiDecoder.decode`` from ``data[pos:]`` until ``pixels`` pixels of
    ``channels`` bytes (3 or 4) are out; a run may overshoot, and the
    surplus is cut. The reference of ``native/codecs.qoi_decode``."""
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    out = bytearray()
    want, n = pixels * channels, len(data)
    try:
        while len(out) < want:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:                                    # QOI_OP_RGB
                if pos + 3 > n:
                    raise IndexError
                value = (data[pos], data[pos + 1], data[pos + 2], prev[3])
                pos += 3
            elif byte == 0xFF:                                  # QOI_OP_RGBA
                if pos + 4 > n:
                    raise IndexError
                value = tuple(data[pos:pos + 4])
                pos += 4
            elif byte >> 6 == 0:                                # QOI_OP_INDEX
                value = seen[byte] or (0, 0, 0, 0)
            elif byte >> 6 == 1:                                # QOI_OP_DIFF
                value = ((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                         (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                         (prev[2] + (byte & 3) - 2) % 256, prev[3])
            elif byte >> 6 == 2:                                # QOI_OP_LUMA
                second = data[pos]
                pos += 1
                dg = (byte & 0x3F) - 32
                value = ((prev[0] + dg + (second >> 4) - 8) % 256, (prev[1] + dg) % 256,
                         (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
            else:                                               # QOI_OP_RUN
                out += bytes(prev[:channels]) * ((byte & 0x3F) + 1)
                continue
            prev = value
            seen[(value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11) % 64] = value
            out += bytes(value[:channels])
    except IndexError:
        raise ValueError("the QOI data ends before the image is full") from None
    return bytes(out[:want])


def decode_ops(data: bytes, pos: int, pixels: int, channels: int, native=None) -> bytes:
    """:func:`decode_ops_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return decode_ops_python(data, pos, pixels, channels)
    return codecs.qoi_decode(data, pos, pixels, channels)


def decode_qoi(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A QOI file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:4] != b"qoif" or len(data) < 14:
        raise NotThisFormat(f"{name}: not a QOI file")
    width, height = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: a QOI image of {width} x {height} pixels")
    channels = 3 if data[12] == 3 else 4
    try:
        raw = decode_ops(data, 14, width * height, channels, native)
    except ValueError as err:
        raise ValueError(f"{name}: {err}") from None
    pixels = np.frombuffer(raw, np.uint8).reshape(height, width, channels)
    return Decoded(pixels.copy(), "RGB" if channels == 3 else "RGBA")
