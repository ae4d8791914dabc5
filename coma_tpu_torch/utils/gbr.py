"""GIMP brushes (GBR), as Pillow's ``GbrImagePlugin`` reads them.

A big-endian header: its size (at least 20), version 1 or 2, width, height
and colour depth (1 gives "L", 4 "RGBA"); version 2 adds ``GIMP`` and a
spacing. A comment fills the header's size; then ``width * height * depth``
raw bytes. A header PIL's ``_open`` gives up is left to the next format;
data that ends early is refused, as PIL refuses it.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat


def _be(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "big")


def decode_gbr(data: bytes, name: str = "<bytes>") -> Decoded:
    """A GBR file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; ``NotThisFormat`` where PIL's plugin does not take it, a
    ``ValueError`` naming ``name`` where PIL refuses it."""
    header, version = _be(data, 0), _be(data, 4)
    if len(data) < 20 or header < 20 or version not in (1, 2):
        raise NotThisFormat(f"{name}: not a GIMP brush")
    width, height, depth = _be(data, 8), _be(data, 12), _be(data, 16)
    if width == 0 or height == 0 or depth not in (1, 4):
        raise NotThisFormat(f"{name}: not a GIMP brush PIL opens")
    if version == 1:
        pos, comment = 20, header - 20
    else:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise NotThisFormat(f"{name}: not a GIMP brush, bad magic number")
        pos, comment = 28, header - 28
    if comment < -1:
        raise ValueError(f"{name}: GBR: a comment of {comment} bytes (read length must be "
                         "non-negative or -1)")
    # a file's read(-1) reads to its end
    pos = len(data) if comment == -1 else min(pos + comment, len(data))
    need = width * height * depth
    if len(data) - pos < need:
        raise ValueError(f"{name}: GBR: not enough image data")
    px = np.frombuffer(data, np.uint8, need, pos)
    if depth == 1:
        return Decoded(px.reshape(height, width), "L")
    return Decoded(px.reshape(height, width, 4), "RGBA")
