"""SPIDER images, as Pillow's ``SpiderImagePlugin`` reads them.

SPIDER has no magic number: PIL reads the first 27 floats, big-endian
first and then little-endian, and takes the file where header words 1, 2,
5, 12, 13, 22 and 23 are whole numbers, word 5 (the format) is one of 1,
3, -11, -12, -21, -22, and the header length (word 22) is word 13 times
word 23 and not 0. Only a 2D image (format 1) opens: "F", width word 12,
height word 2, float32 pixels in the header's byte order right after the
header, or, in a stack (word 24 positive), after the stack's header and
the first image's own. A file PIL does not take this way is left to the
next format, as PIL leaves it.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_FORMS = (1, 3, -11, -12, -21, -22)


def _whole(f: float) -> bool:
    """PIL's ``isInt``."""
    return math.isfinite(f) and f == int(f)


def header_length(t: tuple) -> int:
    """PIL's ``isSpiderHeader`` of the header's floats (1-based words): the
    header length, or 0 where it is not a SPIDER header."""
    h = (99,) + tuple(t)
    if not all(_whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _FORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def decode_spider(data: bytes, name: str = "<bytes>") -> Decoded:
    """A SPIDER file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives
    (mode "F"); ``NotThisFormat`` where PIL's plugin does not take it."""
    if len(data) < 108:
        raise NotThisFormat(f"{name}: not a SPIDER file")
    for order in (">", "<"):
        t = struct.unpack(order + "27f", data[:108])
        length = header_length(t)
        if length:
            break
    else:
        raise NotThisFormat(f"{name}: not a SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat(f"{name}: not a SPIDER 2D image")
    width, height = int(h[12]), int(h[2])
    if not (math.isfinite(h[24]) and math.isfinite(h[27])):
        raise ValueError(f"{name}: SPIDER: a stack word that is not a number")
    stack, number = int(h[24]), int(h[27])
    if stack == 0 and number == 0:
        offset = length
    elif stack > 0 and number == 0:
        offset = 2 * length
    elif stack == 0 and number > 0:
        raise ValueError(f"{name}: SPIDER: an image of a stack without its stack header (PIL "
                         "fails on it)")
    else:
        raise NotThisFormat(f"{name}: inconsistent SPIDER stack header values")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a SPIDER image of {width} x {height} pixels")
    if len(data) < offset + 4 * width * height:
        raise ValueError(f"{name}: SPIDER: image file is truncated")
    pixels = np.frombuffer(data, order + "f4", width * height, offset).astype(np.float32)
    return Decoded(pixels.reshape(height, width), "F")
