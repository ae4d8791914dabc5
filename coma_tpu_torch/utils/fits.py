"""FITS files, as Pillow's ``FitsImagePlugin`` reads them.

80-byte header cards (``KEYWORD = value / comment``) in 2880-byte blocks,
the first ``SIMPLE = T``; an extension (``XTENSION``) adds its cards to
the same table, and the first header unit whose ``NAXIS`` is not 0 gives
the image: ``NAXIS1`` x ``NAXIS2`` (``NAXIS`` 1: one column of ``NAXIS1``
rows), the first plane of a cube. BITPIX 8 gives "L", 16 "I;16", 32 "I",
-32 and -64 "F", each read with PIL's raw mode of that name and
orientation -1: rows bottom-up, and, against the FITS standard, the
samples little-endian (a big-endian int16 1 reads as 256); -64's 8-byte
samples are read as 4-byte floats, so a row takes the first half of its
bytes and the next rows run on from there. The data unit starts at the
first card after the header that is not a header, which must be in the
file.

A binary table of a ``ZIMAGE`` compressed with ``GZIP_1`` (``ZBITPIX``,
``ZNAXIS1``, ``ZNAXIS2``) is read as PIL's ``FitsGzipDecoder`` reads it:
the rest of the file after the table's rows, gzip-decompressed, each
4-byte group keeping its last ``min(bits // 8, 4)`` bytes (Python's slice,
so negative BITPIX keep none and the file is refused), the rows in reverse
order, read top-down with the same raw mode. What PIL's ``_open`` gives up
is left to the next format; what it or the decoder fails on is refused.
"""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_DTYPES = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}


def _int(value: bytes, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}: FITS: a header value {value!r} that is not a whole "
                         "number") from None


def _size(headers: dict, prefix: bytes, name: str):
    """PIL's ``_get_size``: (width, height), or None for NAXIS 0."""
    naxis = _int(headers[prefix + b"NAXIS"], name)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers[prefix + b"NAXIS1"], name)
    return _int(headers[prefix + b"NAXIS1"], name), _int(headers[prefix + b"NAXIS2"], name)


def _parse(headers: dict, name: str):
    """PIL's ``_parse_headers``: (decoder, offset, bits, size, mode); decoder
    "" where the unit holds no image."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _size(headers, prefix, name) or (0, 0)
        offset = table[0] * table[1] * (_int(headers[b"BITPIX"], name) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix, name)
    if not size:
        return "", 0, 0, None, ""
    bits = _int(headers[prefix + b"BITPIX"], name)
    return decoder, offset, bits, size, _MODES.get(bits, "")


def _open(data: bytes, name: str):
    """``FitsImageFile._open``: (decoder, data offset, bits, size, mode)."""
    headers: dict = {}
    in_progress, decoder, pos = False, "", 0
    offset = bits = 0
    size, mode = None, ""
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{name}: FITS: Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                                   # the data unit
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                decoder, offset, bits, size, mode = _parse(headers, name)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise NotThisFormat(f"{name}: not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError(f"{name}: FITS: No image data")
    return decoder, offset + pos - 80, bits, size, mode


def decode_fits(data: bytes, name: str = "<bytes>") -> Decoded:
    """A FITS file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; ``NotThisFormat`` where PIL's plugin does not take it, a
    ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:6] != b"SIMPLE":
        raise NotThisFormat(f"{name}: not a FITS file")
    try:
        decoder, offset, bits, (width, height), mode = _open(data, name)
    except KeyError:
        raise NotThisFormat(f"{name}: a FITS header without its size") from None
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a FITS image of BITPIX {bits}, {width} x {height}")
    dtype = np.dtype(_DTYPES[mode])
    row = width * dtype.itemsize
    if decoder == "raw":
        if offset < 0:
            raise ValueError(f"{name}: FITS: Tile offset cannot be negative")
        if len(data) < offset + row * height:
            raise ValueError(f"{name}: FITS: image file is truncated")
        pixels = np.frombuffer(data, dtype, width * height, offset).reshape(height, width)
        return Decoded(np.ascontiguousarray(pixels[::-1]).astype(dtype.newbyteorder("=")), mode)
    if offset < 0:
        raise ValueError(f"{name}: FITS: a negative seek to the compressed data")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as err:
        raise ValueError(f"{name}: FITS: {err}") from None
    keep = min(bits // 8, 4)
    groups = np.frombuffer(value[:len(value) // 4 * 4], np.uint8).reshape(-1, 4)
    if keep <= 0 or groups.shape[0] < width * height:
        # a negative keep (BITPIX -32, -64) takes nothing; short data too
        raise ValueError(f"{name}: FITS: not enough image data")
    raw = groups[:width * height, 4 - keep:].reshape(height, width * keep)[::-1]
    pixels = np.frombuffer(np.ascontiguousarray(raw).tobytes(), dtype).reshape(height, width)
    return Decoded(pixels.astype(dtype.newbyteorder("=")), mode)
