"""IM Tools (IMT) files, as Pillow's ``ImtImagePlugin`` reads them.

A text header, a line feed among its first 100 bytes: ``key value`` lines
(``*`` lines are comments), of which ``width``, ``height`` and ``pixel
n8`` (mode "L") count, up to a form feed (0x0C), after which the pixels
follow raw, ``width`` bytes a row. A header PIL's ``_open`` gives up is
left to the next format; one PIL opens without reaching a form feed has no
data and is refused, as PIL refuses it, and so are pixels that end early.
"""
from __future__ import annotations

import re

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _header(data: bytes, name: str):
    """``ImtImageFile._open``: (width, height, mode, data offset or None)."""
    buffer, pos = data[:100], min(len(data), 100)
    if b"\n" not in buffer:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    width = height = 0
    mode, offset = None, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)              # the image data begins
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError:
            raise ValueError(f"{name}: IMT: a {k.decode()} of {v!r} (PIL fails on it)") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    return width, height, mode, offset


def decode_imt(data: bytes, name: str = "<bytes>") -> Decoded:
    """An IM Tools file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives (mode "L"); ``NotThisFormat`` where PIL's plugin does not take it,
    a ``ValueError`` naming ``name`` where PIL refuses it."""
    width, height, mode, offset = _header(data, name)
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    if offset is None:
        raise ValueError(f"{name}: IMT: cannot load this image (no form feed before the data)")
    if len(data) < offset + width * height:
        raise ValueError(f"{name}: IMT: buffer is not large enough")
    return Decoded(np.frombuffer(data, np.uint8, width * height, offset).reshape(height, width),
                   "L")
