"""Windows icons (ICO) and cursors (CUR), as Pillow's ``IcoImagePlugin``
and ``CurImagePlugin`` read them.

ICO: a directory of 16-byte entries (width and height, 0 meaning 256, a
colour count, planes, bits per pixel, size and offset). PIL sorts them by
colour depth (the bits per pixel, else ``ceil(log2(colours))``, else 256)
and then, stably, by area, largest first, and opens the first. A member
that starts with PNG's signature is a PNG (``utils/png.py``, in the PNG's
own mode). Any other is a bitmap without a file header (``utils/bmp.py``)
whose header counts the XOR image and the AND mask: its top half of rows
is the image, and PIL gives "RGBA": a 32-bit entry's alpha from every
fourth byte of its data, any other's from the 1-bit AND mask at the end of
the member (0 opaque).

CUR: the same directory with type 2. PIL picks the first entry, or a later
one wider and taller than it, and reads its bitmap's top half in the
bitmap's own mode (no mask; a 32-bit bitmap whose header starts at byte 22
is read "RGBA" with its fourth byte as alpha, as PIL reads it).
"""
from __future__ import annotations

from math import ceil, log

import numpy as np

from coma_tpu_torch.utils import bmp
from coma_tpu_torch.utils.modes import Decoded, NotThisFormat, to_mode
from coma_tpu_torch.utils.png import decode_png_pil

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _le(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _entries(data: bytes, name: str) -> list:
    count = _le(data, 4, 2)
    entries = []
    for k in range(count):
        s = data[6 + 16 * k:22 + 16 * k]
        if len(s) < 16:
            raise NotThisFormat(f"{name}: the icon directory runs past the end of the file")
        width, height, colours, bpp = s[0] or 256, s[1] or 256, s[2], _le(s, 6, 2)
        depth = bpp or (colours != 0 and ceil(log(colours, 2))) or 256
        entries.append(dict(width=width, height=height, bpp=bpp, size=_le(s, 8, 4),
                            offset=_le(s, 12, 4), depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["width"] * e["height"], reverse=True)
    return entries


def _rgba(image: Decoded) -> np.ndarray:
    """``Image.convert("RGBA")`` of a bitmap's image."""
    if image.mode == "RGBA":
        return image.pixels.copy()
    rgb = to_mode(image, "RGB")
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def decode_ico(data: bytes, name: str = "<bytes>") -> Decoded:
    """An ICO file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[:4] != b"\0\0\1\0" or len(data) < 6:
        raise NotThisFormat(f"{name}: not an ICO file")
    entries = _entries(data, name)
    if not entries:
        raise NotThisFormat(f"{name}: an icon with no images")
    entry = entries[0]
    at = entry["offset"]
    if data[at:at + 8] == PNG_MAGIC:
        return decode_png_pil(data[at:], name)
    image, pixel_at = bmp.bitmap(data, at, 0, height_div=2, name=name)
    height, width = image.pixels.shape[:2]
    if entry["bpp"] == 32:
        alpha = np.frombuffer(data[pixel_at:pixel_at + width * height * 4], np.uint8)[3::4]
        if alpha.size < width * height:
            raise ValueError(f"{name}: ICO: not enough image data for the alpha")
        alpha = alpha.reshape(height, width)[::-1]
    else:
        row = (width + 31) // 32 * 4
        total = row * height
        start = at + entry["size"] - total
        # the last row read needs its bits, not its padding
        mask = np.frombuffer(data[max(start, 0):max(start, 0) + total].ljust(total, b"\0"),
                             np.uint8)
        if start < 0 or len(data) - start < total - row + (width + 7) // 8:
            raise ValueError(f"{name}: ICO: not enough image data for the AND mask")
        bits = np.unpackbits(mask.reshape(height, row), axis=1)[:, :width]
        alpha = np.where(bits[::-1], 0, 255).astype(np.uint8)
    rgba = _rgba(image)
    rgba[..., 3] = alpha
    return Decoded(rgba, "RGBA")


def decode_cur(data: bytes, name: str = "<bytes>") -> Decoded:
    """A CUR file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode."""
    if data[:4] != b"\0\0\2\0" or len(data) < 6:
        raise NotThisFormat(f"{name}: not a CUR file")
    best, count = None, _le(data, 4, 2)
    for k in range(count):
        s = data[6 + 16 * k:22 + 16 * k]
        if not best:
            best = s
        elif len(s) < 2:
            raise NotThisFormat(f"{name}: the cursor directory runs past the end of the file")
        elif s[0] > best[0] and s[1] > best[1]:
            best = s
    if not best or len(best) < 16:
        raise NotThisFormat(f"{name}: a cursor with no images")
    at = _le(best, 12, 4)
    # PIL seeks to a nonzero offset only: 0 reads the header where the directory ends
    return bmp.bitmap(data, at or 6 + 16 * count, 0, height_div=2, raw_alpha=at == 22,
                      name=name)[0]
