"""X11 pixmaps (XPM), as Pillow's ``XpmImagePlugin`` reads them.

``/* XPM */``, then the first line that starts ``"w h colours bpp``; then
one line a colour, ``line[1:bpp + 1]`` its key and the words of
``line[bpp + 1:-2]`` its keys and values, of which the first ``c`` counts:
``#`` and a hexadecimal number (its low 24 bits as RGB), or ``None``, the
transparent key, which gets no palette entry. A named colour, or a line
without a ``c``, is refused, as PIL refuses it. At most 256 colours give
"P" (the palette in the order of the keys), more give "RGB".

The pixels are read as PIL's ``XpmDecoder`` reads them: line after line,
what lies between a line's first and last double quotes (a first
``/* pixels */`` line skipped), cut into keys of ``bpp`` bytes, until the
image's bytes are all there; the keys form one stream, whatever the line
lengths, and a key without a colour (the transparent one too) or a stream
that ends early is refused, as PIL refuses it.
"""
from __future__ import annotations

import re

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """``readline`` from ``pos``: (line with its newline, next position)."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def _int(text: bytes, name: str, base: int = 10) -> int:
    try:
        return int(text, base)
    except ValueError:
        raise ValueError(f"{name}: XPM: {text!r} is not a number (PIL fails on it)") from None


def decode_xpm(data: bytes, name: str = "<bytes>") -> Decoded:
    """An XPM file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; ``NotThisFormat`` where PIL's plugin does not take it, a
    ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:9] != b"/* XPM */":
        raise NotThisFormat(f"{name}: not an XPM file")
    pos = 9
    while True:
        line, pos = _lines(data, pos)
        if not line:
            raise NotThisFormat(f"{name}: broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    width, height, colours, bpp = (_int(g, name) for g in m.groups())
    palette: dict = {}
    for _ in range(colours):
        line, pos = _lines(data, pos)
        line = line.rstrip()
        key, words = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise NotThisFormat(f"{name}: an XPM colour key without its value")
                rgb = words[i + 1]
                if rgb == b"None":
                    pass                            # the transparency key: no entry
                elif rgb.startswith(b"#"):
                    v = _int(rgb[1:], name, 16)
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    raise ValueError(f"{name}: XPM: cannot read this XPM file (the colour "
                                     f"{rgb!r} is not #rrggbb; PIL refuses it)")
                break
        else:
            raise ValueError(f"{name}: XPM: cannot read this XPM file (a colour line without "
                             "a c key; PIL refuses it)")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an XPM of {width} x {height} pixels")
    if bpp <= 0:
        # PIL's range(0, n, bpp) fails on 0 and never ends a stream on less
        raise ValueError(f"{name}: XPM: {bpp} characters a pixel (PIL fails on it)")
    rgb_mode = colours > 256
    keys = list(palette)
    lookup = palette if rgb_mode else {k: bytes((keys.index(k),)) for k in keys}
    need = width * height * (3 if rgb_mode else 1)
    out, pixel_header = bytearray(), False
    while len(out) < need:
        line, pos = _lines(data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            k = line[i:i + bpp]
            if k not in lookup:
                raise ValueError(f"{name}: XPM: the key {k!r} has no colour (PIL fails on it)")
            out += lookup[k]
    if len(out) < need:
        raise ValueError(f"{name}: XPM: not enough image data")
    px = np.frombuffer(bytes(out[:need]), np.uint8)
    if rgb_mode:
        return Decoded(px.reshape(height, width, 3), "RGB")
    pal = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    return Decoded(px.reshape(height, width), "P", pal)
