"""Microsoft Paint (MSP) files, as Pillow's ``MspImagePlugin`` reads them.

A 32-byte little-endian header whose sixteen words XOR to 0, then version 1
(``DanM``) raw rows, or version 2 (``LinS``) a map of each row's byte
count and the rows coded as ``MspDecoder`` codes them: a 0 byte, a count
and a value is a run of the value; any other byte n is n literal bytes; a
row of count 0 is white. The decoded bytes are read as PIL reads them,
one stream cut into rows of ``ceil(width / 8)`` bytes, so a row that
decodes to another length moves the rows after it. Mode "1" (a set bit is
white); a file that ends early is refused, as PIL refuses it.

The row decoding has a native twin in ``native/src/image_codecs.cpp``
(``msp_rle_decode``); :func:`rle_decode` picks it, or
:func:`rle_decode_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat


def rle_decode_python(data: bytes, width: int, height: int) -> bytes:
    """``MspDecoder.decode``: the rows after the row map at byte 32, joined.
    The reference of ``native/codecs.msp_rle_decode``."""
    blank = b"\xff" * ((width + 7) // 8)
    counts = np.frombuffer(data, "<u2", height, 32) if len(data) >= 32 + 2 * height else None
    if counts is None:
        raise ValueError("truncated MSP file in row map")
    pos, out = 32 + 2 * height, bytearray()
    for y, n in enumerate(counts.tolist()):
        if n == 0:
            out += blank
            continue
        row = data[pos:pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"truncated MSP file, expected {n} bytes on row {y}")
        k = 0
        while k < n:
            kind = row[k]
            k += 1
            if kind == 0:
                if k + 2 > n:
                    raise ValueError(f"corrupted MSP file in row {y}")
                out += row[k + 1:k + 2] * row[k]
                k += 2
            else:
                out += row[k:k + kind]
                k += kind
    return bytes(out)


def rle_decode(data: bytes, width: int, height: int, native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, width, height)
    return codecs.msp_rle_decode(data, width, height)


def decode_msp(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """An MSP file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives
    (mode "1"); a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:4] not in (b"DanM", b"LinS") or len(data) < 32:
        raise NotThisFormat(f"{name}: not an MSP file")
    words = np.frombuffer(data, "<u2", 16)
    if np.bitwise_xor.reduce(words) != 0:
        raise NotThisFormat(f"{name}: bad MSP checksum")
    width, height = int(words[2]), int(words[3])
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an MSP image of {width} x {height} pixels")
    stride = (width + 7) // 8
    if data[:4] == b"DanM":
        raw = data[32:32 + stride * height]
        if len(raw) < stride * height:
            raise ValueError(f"{name}: MSP: image file is truncated")
    else:
        try:
            raw = rle_decode(data, width, height, native)
        except ValueError as err:
            raise ValueError(f"{name}: MSP: {err}") from None
        if len(raw) < stride * height:
            raise ValueError(f"{name}: MSP: not enough image data")
    rows = np.frombuffer(raw, np.uint8, stride * height).reshape(height, stride)
    return Decoded(np.unpackbits(rows, axis=1)[:, :width].astype(bool), "1")
