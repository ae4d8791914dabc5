"""ZSoft Paintbrush (PCX) and Intel DCX files, as Pillow's
``PcxImagePlugin`` and ``DcxImagePlugin`` read them.

A 128-byte header: the inclusive bounding box (its size ``xmax + 1 -
xmin`` by ``ymax + 1 - ymin``; an empty box is not a PCX to PIL), bits
per pixel and planes, and a row stride PIL does not trust: it takes
``ceil(width * bits / 8)``, made even where the file's differs. Modes:
1 bit, 1 plane "1"; 1 bit, 2 or 4 planes "P" with the header's 16-colour
palette (PIL's ``P;2L``/``P;4L`` unpackers, the planes ``ceil(width / 8)``
bytes apart); version 5 with 8
bits and 1 plane "L", or "P" where the file ends in a 0x0C-marked palette
that is not the gray ramp; version 5 with 8 bits and 3 planes "RGB". The
run-length rows decode as ``PcxDecode.c`` does: a run that passes a row's
end is refused, and before a row is unpacked its planes are moved as PIL
moves them: for 2 and 4 bit planes, from ``stride`` to ``ceil(width / 8)``
bytes apart; for the others, ``bytes // width`` bands from ``bytes //
bands`` to ``width`` apart.

A DCX file is a table of up to 1024 offsets of PCX images; PIL opens the
first. PIL looks for the 8-bit palette at the end of the whole file.

The run-length loop has a native twin in ``native/src/image_codecs.cpp``
(``pcx_rle_decode``); :func:`rle_decode` picks it, or
:func:`rle_decode_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

DCX_MAGIC = 0x3ADE68B1


def _le16(data: bytes, at: int) -> int:
    return data[at] | data[at + 1] << 8


def accept(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def _relay(width: int, row_bytes: int, bits: int) -> tuple:
    """PIL's plane move before a row is unpacked (``bits``: the unpacker's
    bits a pixel): (bands, plane size, stride), or None where it moves
    nothing."""
    if bits in (2, 4):
        size, bands, stride = (width + 7) // 8, bits, row_bytes // bits
    else:
        size, bands = width, row_bytes // width
        stride = row_bytes // bands if bands else 0
    return (bands, size, stride) if stride > size else None


def rle_decode_python(data: bytes, pos: int, row_bytes: int, rows: int, width: int,
                      bits: int) -> bytes:
    """``ImagingPcxDecode`` from ``data[pos:]``: ``rows`` rows of
    ``row_bytes``, each re-laid as PIL re-lays its planes (``bits``: the
    unpacker's bits a pixel). The reference of ``native/codecs.pcx_rle_decode``."""
    relay = _relay(width, row_bytes, bits)
    out = bytearray()
    buf = bytearray(row_bytes)
    x, n = 0, len(data)
    overrun = False
    while len(out) < rows * row_bytes:
        if pos >= n:
            raise ValueError("image file is truncated")
        byte = data[pos]
        if byte & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("image file is truncated")
            count = byte & 0x3F
            if x + count > row_bytes:
                overrun = True
                count = row_bytes - x
            buf[x:x + count] = data[pos + 1:pos + 2] * count
            x += count
            pos += 2
        else:
            buf[x] = byte
            x += 1
            pos += 1
        if x >= row_bytes:
            if relay:
                bands, size, stride = relay
                for i in range(1, bands):
                    buf[i * size:(i + 1) * size] = buf[i * stride:i * stride + size]
            out += buf
            x = 0
    if overrun:
        raise ValueError("a run passes the end of a row (buffer overrun)")
    return bytes(out)


def rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, width: int, bits: int,
               native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, pos, row_bytes, rows, width, bits)
    return codecs.pcx_rle_decode(data, pos, row_bytes, rows,
                                 *(_relay(width, row_bytes, bits) or (0, 0, 0)))


def _planes_to_index(rows: np.ndarray, planes: int, width: int) -> np.ndarray:
    """PIL's ``P;2L``/``P;4L``: bit planes ``ceil(width / 8)`` bytes apart in
    each row, plane k giving bit k of the index."""
    step = (width + 7) // 8
    index = np.zeros((rows.shape[0], width), np.uint8)
    for k in range(planes):
        bits = np.unpackbits(rows[:, k * step:(k + 1) * step], axis=1)[:, :width]
        index |= bits << k
    return index


def decode_pcx(data: bytes, name: str = "<bytes>", native=None, at: int = 0) -> Decoded:
    """A PCX image at ``data[at:]`` -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where PIL refuses
    it."""
    s = data[at:at + 68]
    if not accept(s) or len(s) < 68:
        raise NotThisFormat(f"{name}: not a PCX file")
    x0, y0 = _le16(s, 4), _le16(s, 6)
    x1, y1 = _le16(s, 8) + 1, _le16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise NotThisFormat(f"{name}: an empty PCX image box")
    version, bits, planes, given_stride = s[1], s[3], s[65], _le16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:
            raise ValueError(f"{name}: PCX: too short for PIL's look for a palette in its "
                             "last 769 bytes")
        tail = data[-769:]
        if tail[0] == 12:
            entries = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (entries == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", entries
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{name}: PCX: {bits} bits and {planes} planes is not a mode PIL "
                         "reads")
    width, height = x1 - x0, y1 - y0
    stride = (width * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    try:
        raw = rle_decode(data, at + 128, row_bytes, height, width, bits * planes, native)
    except ValueError as err:
        raise ValueError(f"{name}: PCX: {err}") from None
    rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes)
    if mode == "1":
        return Decoded(np.unpackbits(rows, axis=1)[:, :width].astype(bool), "1")
    if mode == "P" and bits == 1:
        return Decoded(_planes_to_index(rows, planes, width), "P", palette)
    if mode == "RGB":
        return Decoded(np.ascontiguousarray(rows[:, :3 * width].reshape(
            height, 3, width).transpose(0, 2, 1)), "RGB")
    return Decoded(np.ascontiguousarray(rows[:, :width]), mode, palette)


def decode_dcx(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A DCX file's first page, as PIL opens it."""
    if len(data) < 8 or int.from_bytes(data[:4], "little") != DCX_MAGIC:
        raise NotThisFormat(f"{name}: not a DCX file")
    first = int.from_bytes(data[4:8], "little")
    if not first:
        raise NotThisFormat(f"{name}: a DCX file with no pages")
    return decode_pcx(data, name, native, at=first)
