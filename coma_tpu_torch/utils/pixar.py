"""PIXAR raster files, as Pillow's ``PixarImagePlugin`` reads them.

The magic ``80 E8 00 00``; a 512-byte header whose little-endian words at
418 and 416 are the width and height, and at 424 and 426 the channels and
depth; only (14, 2) has a mode in PIL, "RGB", read raw ("dumped") from
byte 1024. Anything else is left to the next format; data that ends early
is refused, as PIL refuses it.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

MAGIC = b"\200\350\000\000"


def _le(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2], "little")


def decode_pixar(data: bytes, name: str = "<bytes>") -> Decoded:
    """A PIXAR file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives
    (mode "RGB"); ``NotThisFormat`` where PIL's plugin does not take it, a
    ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:4] != MAGIC or len(data) < 428 or (_le(data, 424), _le(data, 426)) != (14, 2):
        raise NotThisFormat(f"{name}: not a PIXAR file PIL opens")
    width, height = _le(data, 418), _le(data, 416)
    if not (width and height):
        raise NotThisFormat(f"{name}: a PIXAR image of {width} x {height} pixels")
    need = width * height * 3
    if len(data) < 1024 + need:
        raise ValueError(f"{name}: PIXAR: image file is truncated")
    return Decoded(np.frombuffer(data, np.uint8, need, 1024).reshape(height, width, 3), "RGB")
