"""X11 bitmaps (XBM), as Pillow's ``XbmImagePlugin`` reads them.

The first 512 bytes must match PIL's header pattern: ``#define ..._width
N`` and ``#define ..._height N`` lines, an optional hot spot, and then
anything up to the last ``_bits[]`` in those bytes. The data that follows
is read as ``XbmDecode.c`` reads it: skip to the next ``x``, take the two
bytes after it as hex digits (a byte that is not one counts 0), least
significant bit first, ``ceil(width / 8)`` bytes a row. Mode "1"; data
that ends before the image is full is refused, as PIL refuses it.
"""
from __future__ import annotations

import re

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdef":
    _HEX[_c] = int(chr(_c), 16)
    _HEX[ord(chr(_c).upper())] = int(chr(_c), 16)


def accept(data: bytes) -> bool:
    return data[:16].lstrip().startswith(b"#define")


def decode_xbm(data: bytes, name: str = "<bytes>") -> Decoded:
    """An XBM file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives
    (mode "1"); a ``ValueError`` naming ``name`` where PIL refuses it."""
    m = _HEAD.match(data[:512])
    if not m:
        raise NotThisFormat(f"{name}: not an XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an XBM of {width} x {height} pixels")
    want = (width + 7) // 8 * height
    body = np.frombuffer(data, np.uint8)[m.end():]
    at = np.flatnonzero(body == ord("x"))
    # each hex pair ends the scan: the next 'x' is looked for after it
    values, pos = [], -1
    for k in at:
        if k <= pos:
            continue
        if k + 2 >= body.size:
            break
        values.append(_HEX[body[k + 1]] << 4 | _HEX[body[k + 2]])
        pos = k + 2
        if len(values) == want:
            break
    if len(values) < want:
        raise ValueError(f"{name}: XBM: image file is truncated")
    rows = np.array(values, np.uint8).reshape(height, -1)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :width]
    return Decoded(bits.astype(bool), "1")
