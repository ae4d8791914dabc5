"""McIdas area files, as Pillow's ``McIdasImagePlugin`` reads them.

A 256-byte directory of 64 big-endian int32 words (PIL's ``w[k]``, 1-based,
``w[1..2]`` 0 and 4): ``w[9]`` rows, ``w[10]`` columns, ``w[11]`` bytes an
element (1 "L", 2 "I;16B", 4 "I" from big-endian int32), ``w[14]`` bands,
``w[15]`` the row prefix and ``w[34]`` the data offset. The first row
starts at ``w[34] + w[15]`` and rows ``w[15] + w[10] w[11] w[14]`` bytes
apart. Pillow memory-maps "L" and "I;16B" files it opens from a path where
the file holds ``height`` whole strides (a stride of 0 or less is then a
row of its own, and rows may overlap); otherwise, and for "I", its raw
decoder reads them, refusing a stride shorter than a row. Data that ends
early is refused, as PIL refuses it; a directory PIL gives up is left to
the next format.
"""
from __future__ import annotations

import struct

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

MAGIC = b"\0\0\0\0\0\0\0\4"
_MODES = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def decode_mcidas(data: bytes, name: str = "<bytes>") -> Decoded:
    """A McIdas area file's bytes -> what ``np.asarray(PIL.Image.open(path))``
    gives, and its mode; ``NotThisFormat`` where PIL's plugin does not take
    it, a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:8] != MAGIC or len(data) < 256:
        raise NotThisFormat(f"{name}: not a McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    if w[11] not in _MODES:
        raise NotThisFormat(f"{name}: unsupported McIdas format ({w[11]} bytes an element)")
    mode, dtype = _MODES[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a McIdas area of {width} x {height} elements")
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    row = width * w[11]
    if offset < 0:
        raise ValueError(f"{name}: McIdas: a negative data offset")
    if mode != "I" and offset + height * stride <= len(data):
        step = stride if stride > 0 else row       # PIL's memory map
        if offset + height * step > len(data):
            raise ValueError(f"{name}: McIdas: buffer is not large enough")
    else:                                           # PIL's raw decoder
        if stride and stride < row:
            raise ValueError(f"{name}: McIdas: a stride of {stride} bytes under a row of {row} "
                             "(bad configuration; PIL refuses it)")
        step = stride or row
        if offset + (height - 1) * step + row > len(data):
            raise ValueError(f"{name}: McIdas: image file is truncated")
    buf = np.frombuffer(data, np.uint8)
    starts = offset + step * np.arange(height, dtype=np.int64)
    rows = buf[starts[:, None] + np.arange(row)]
    pixels = np.ascontiguousarray(rows).view(dtype).reshape(height, width)
    return Decoded(pixels.astype(np.int32) if mode == "I" else pixels, mode)
