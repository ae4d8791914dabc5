"""SGI image files (``.rgb``, ``.sgi``, ``.bw``), as Pillow's
``SgiImagePlugin`` reads them.

A 512-byte big-endian header (magic 474, storage, bytes per channel,
dimension, x, y and z sizes), then the channels: verbatim, one plane after
another, or run-length coded (``SgiRleDecode.c``), with a table of each
row's offset and length, channel by channel. PIL's modes by (bytes per
channel, dimension, channels): 1 or 2 bytes, dimension 1 or 2 with one
channel give "L", dimension 3 with 3 or 4 channels "RGB" or "RGBA"; two
bytes a channel keep the high byte (PIL's ";16B" raw modes). Every other
layout is refused, as PIL refuses it. Rows are stored bottom-up.

The run-length rows decode as PIL's C decoder decodes them, quirks
included: a row's length counts packets, not bytes (one of 2^31 or more,
negative as C's int, decodes nothing); a nonzero packet in a
row's last counted place ends the whole image there, leaving the rows not
yet decoded black; a row that stops short keeps the bytes the row before
left in the decoder's buffer; a packet that would pass the row's end, or
read past the end of the file, is refused. The loop has a native twin in
``native/src/image_codecs.cpp`` (``sgi_rle_decode``); :func:`rle_decode`
picks it, or :func:`rle_decode_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

HEADER = 512
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def _be(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "big")


def rle_decode_python(data: bytes, width: int, height: int, bands: int, bpc: int) -> bytes:
    """``ImagingSgiRleDecode``: the file's rows in file order (bottom row
    first), each ``width * bands * bpc`` bytes, samples interleaved. The
    reference of ``native/codecs.sgi_rle_decode``."""
    body = data[HEADER:]
    size, tablen = len(body), bands * height
    if size < 8 * tablen:
        raise ValueError("the RLE tables run past the end of the file")
    starts = np.frombuffer(body, ">u4", tablen).astype(np.int64)
    lengths = np.frombuffer(body, ">u4", tablen, 4 * tablen).astype(np.int64)
    last = size - 1                                     # the decoder's end_of_buffer
    row = bytearray(width * bands * bpc)
    out = bytearray(len(row) * height)
    for y in range(height):
        for c in range(bands):
            start, n = int(starts[y + c * height]), int(lengths[y + c * height])
            n -= (n >= 1 << 31) << 32           # the decoder's int: 2^31 and up decode nothing
            if start < HEADER:
                raise ValueError("an RLE row offset inside the header")
            src, x, dest = start - HEADER, 0, c * bpc
            status = 0
            while n > 0:
                if src + bpc - 1 > last:
                    raise ValueError("an RLE row runs past the end of the file")
                pixel = body[src + bpc - 1]
                src += bpc
                if n == 1 and pixel:
                    status = 1
                    break
                count = pixel & 0x7F
                if not count:
                    break
                if x + count > width:
                    raise ValueError("an RLE packet runs past the end of its row")
                x += count
                if pixel & 0x80:
                    if src + bpc * count > last:
                        raise ValueError("an RLE row runs past the end of the file")
                    for k in range(count):
                        row[dest:dest + bpc] = body[src:src + bpc]
                        src += bpc
                        dest += bands * bpc
                else:
                    if src + bpc - 1 > last:
                        raise ValueError("an RLE row runs past the end of the file")
                    value = body[src:src + bpc]
                    for k in range(count):
                        row[dest:dest + bpc] = value
                        dest += bands * bpc
                    src += bpc
                n -= 1
            if status:
                return bytes(out)
        out[y * len(row):(y + 1) * len(row)] = row
    return bytes(out)


def rle_decode(data: bytes, width: int, height: int, bands: int, bpc: int, native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, width, height, bands, bpc)
    return codecs.sgi_rle_decode(data, width, height, bands, bpc)


def decode_sgi(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """An SGI file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    if len(data) < 12 or _be(data, 0, 2) != 474:
        raise NotThisFormat(f"{name}: not an SGI file")
    storage, bpc = data[2], data[3]
    dimension, width, height, bands = (_be(data, 4 + 2 * k, 2) for k in range(4))
    mode = _MODES.get((bpc, dimension, bands))
    if mode is None:
        raise ValueError(f"{name}: SGI: {bpc} bytes a channel, dimension {dimension} and "
                         f"{bands} channels is not a mode PIL reads")
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an SGI image of {width} x {height} pixels")
    if storage == 1:
        try:
            raw = rle_decode(data, width, height, bands, bpc, native)
        except ValueError as err:
            raise ValueError(f"{name}: SGI: {err}") from None
        pixels = np.frombuffer(raw, np.uint8).reshape(height, width, bands, bpc)[..., 0]
    elif storage == 0:
        plane = width * height * bpc
        if len(data) < HEADER + plane * bands:
            raise ValueError(f"{name}: SGI: image file is truncated")
        planes = np.frombuffer(data, np.uint8, plane * bands, HEADER).reshape(
            bands, height, width, bpc)[..., 0]
        pixels = planes.transpose(1, 2, 0)
    else:
        raise ValueError(f"{name}: SGI: storage {storage} is not read (PIL reads 0 and 1)")
    pixels = np.ascontiguousarray(pixels[::-1])
    return Decoded(pixels[..., 0] if mode == "L" else pixels, mode)
