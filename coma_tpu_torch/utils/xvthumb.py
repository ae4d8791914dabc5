"""XV thumbnails, as Pillow's ``XVThumbImagePlugin`` reads them.

``P7 332``; the rest of that line; comment lines starting ``#``; a line
whose first two words are the width and height (a line of fewer words, or
words that are not numbers, is refused, as PIL fails on it); then
``width * height`` bytes of mode "P" over PIL's fixed 3-3-2 palette
(:data:`PALETTE`: red and green in 8 levels, blue in 4). A file that ends
in the comments is left to the next format, pixels that end early refused.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

# PIL's PALETTE: r g b over 8 x 8 x 4 levels, (r 255) // 7, (g 255) // 7, (b 255) // 3
PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                    for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def _line(data: bytes, pos: int):
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes, name: str = "<bytes>") -> Decoded:
    """An XV thumbnail's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives (mode "P"); ``NotThisFormat`` where PIL's plugin does not take it,
    a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:6] != b"P7 332":
        raise NotThisFormat(f"{name}: not an XV thumbnail file")
    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise NotThisFormat(f"{name}: Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:                              # not a "#" comment
            break
    words = s.strip().split(maxsplit=2)[:2]
    try:
        width, height = (int(w) for w in words)
    except ValueError:
        raise ValueError(f"{name}: XV thumbnail: a size line {s!r} PIL fails on") from None
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an XV thumbnail of {width} x {height} pixels")
    if len(data) < pos + width * height:
        raise ValueError(f"{name}: XV thumbnail: buffer is not large enough")
    px = np.frombuffer(data, np.uint8, width * height, pos).reshape(height, width)
    return Decoded(px, "P", PALETTE)
