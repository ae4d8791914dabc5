"""Freeware texture (FTEX) files, as Pillow's ``FtexImagePlugin`` reads them.

``FTEX``, then little-endian int32s: version, width, height, mipmap count
and format count (PIL asserts it is 1, so another is refused), the format
and the offset of the first mipmap, whose int32 size and data follow there.
Format 0 is DXT1 (mode "RGBA", the blocks decoded as Pillow's ``bcn``
decoder decodes BC1, ``utils/dds.py``, with its native twin in
``native/src/bcn_decode.cpp``); format 1 is raw "RGB"; any other is refused.
A mipmap that holds fewer bytes than the image needs is refused, as PIL
refuses it; a header cut short is left to the next format.
"""
from __future__ import annotations

import struct

import numpy as np

from coma_tpu_torch.utils import dds
from coma_tpu_torch.utils.modes import Decoded, NotThisFormat


def decode_ftex(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """An FTEX file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; ``NotThisFormat`` where PIL's plugin does not take it, a
    ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:4] != b"FTEX" or len(data) < 24:
        raise NotThisFormat(f"{name}: not an FTEX file, or its header cut short")
    width, height, _, formats = struct.unpack_from("<4i", data, 8)
    if formats != 1:
        raise ValueError(f"{name}: FTEX: {formats} formats (PIL asserts one)")
    if len(data) < 32:
        raise NotThisFormat(f"{name}: an FTEX format entry cut short")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: FTEX: a negative mipmap offset")
    if len(data) < where + 4:
        raise NotThisFormat(f"{name}: an FTEX mipmap size past the end of the file")
    (size,) = struct.unpack_from("<i", data, where)
    if size < -1:
        raise ValueError(f"{name}: FTEX: a mipmap of {size} bytes (read length must be "
                         "non-negative or -1)")
    # a file's read(-1) reads to its end
    mip = data[where + 4:] if size == -1 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: FTEX: Invalid texture compression format: {fmt}")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an FTEX texture of {width} x {height} pixels")
    if fmt == 1:
        need = width * height * 3
        if len(mip) < need:
            raise ValueError(f"{name}: FTEX: image file is truncated")
        return Decoded(np.frombuffer(mip, np.uint8, need).reshape(height, width, 3), "RGB")
    need = -(-width // 4) * -(-height // 4) * 8
    if len(mip) < need:
        raise ValueError(f"{name}: FTEX: image file is truncated")
    return Decoded(dds._bcn(mip[:need], "BC1", width, height, native), "RGBA")
