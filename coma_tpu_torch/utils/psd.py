"""Adobe Photoshop (PSD) files, as Pillow's ``PsdImagePlugin`` reads them.

The composite image only (Pillow opens it as frame 1; the layers are read
on ``seek``). The header, the colour-mode data (768 bytes of planar
palette give a "P" image its palette), the image resources (walked as PIL
walks them, so a malformed one moves the start of the image as it does in
PIL), the layer and mask section (skipped), then the composite's channels:
raw (compression 0) or PackBits (1) with per-row byte counts, one plane
after another.

Modes from PIL's ``MODES``: bitmap "1" (PIL's 1 is white), gray,
multichannel and duotone as "L", "P", "RGB" ("RGBA" with a fourth
channel), "CMYK" (stored inverted) and "LAB" (a and b signed bytes). 16-
and 32-bit depths, PSB (version 2), ZIP compression and too few channels
are refused, as PIL refuses them; so is a file whose image data ends
early. ``utils.modes.to_mode`` converts the result as PIL's ``convert``
does: "LAB" to "RGB" through Little CMS's transform (``utils/lcms.py``),
"LAB" to "L" refused as PIL refuses it.

PackBits runs as PIL's decoder runs it (rows, a packet cut at a row's end)
through ``native/codecs.packbits_rows_decode`` where it builds, else
:func:`packbits_rows_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded

# (Photoshop colour mode, bits) -> (PIL mode, channels it needs)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def _be(data: bytes, at: int, n: int) -> int:
    if at + n > len(data):
        raise ValueError("the file ends inside its header")
    return int.from_bytes(data[at:at + n], "big")


def packbits_rows_python(data: bytes, pos: int, row: int, rows: int) -> bytes:
    """PIL's PackBits decoder from ``data[pos:]``: ``rows`` rows of ``row``
    bytes; a header n in 0..127 copies n + 1 bytes, 129..255 repeats the next
    byte 257 - n times, 128 does nothing, and a packet that crosses a row's
    end is cut there. The reference of ``native/codecs.packbits_rows_decode``."""
    out = bytearray(row * rows)
    x = y = 0
    n = len(data)
    while y < rows:
        if pos >= n:
            raise ValueError("image file is truncated")
        h = data[pos]
        if h == 0x80:
            pos += 1
            continue
        if h & 0x80:
            if pos + 2 > n:
                raise ValueError("image file is truncated")
            take = min(257 - h, row - x)
            out[y * row + x:y * row + x + take] = data[pos + 1:pos + 2] * take
            pos += 2
        else:
            if pos + 2 + h > n:
                raise ValueError("image file is truncated")
            take = min(h + 1, row - x)
            out[y * row + x:y * row + x + take] = data[pos + 1:pos + 1 + take]
            pos += 2 + h
        x += take
        if x >= row:
            x, y = 0, y + 1
    return bytes(out)


def _packbits(data: bytes, pos: int, row: int, rows: int, native) -> bytes:
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if native:
        return codecs.packbits_rows_decode(data, pos, row, rows)
    return packbits_rows_python(data, pos, row, rows)


def decode_psd(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A PSD file's composite -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    try:
        return _decode(data, native)
    except ValueError as err:
        raise ValueError(f"{name}: Photoshop PSD: {err}") from None


def _decode(data: bytes, native) -> Decoded:
    if data[:4] != b"8BPS" or _be(data, 4, 2) != 1:
        raise ValueError("not a PSD file (PSB, version 2, is not read)")
    channels, height, width = _be(data, 12, 2), _be(data, 14, 4), _be(data, 18, 4)
    bits, ps_mode = _be(data, 22, 2), _be(data, 24, 2)
    if (ps_mode, bits) not in _MODES:
        raise ValueError(f"colour mode {ps_mode} at {bits} bits is not read")
    mode, need = _MODES[(ps_mode, bits)]
    if need > channels:
        raise ValueError("not enough channels")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    pos = 26
    size = _be(data, pos, 4)
    palette = None
    if mode == "P":
        palette = np.zeros((0, 3), np.uint8)        # PIL's empty palette: every index black
        if size == 768:
            palette = np.frombuffer(data, np.uint8, 768, pos + 4).reshape(3, 256).T.copy()
    pos += 4 + size
    size = _be(data, pos, 4)
    pos += 4
    end = pos + size
    while pos < end:                                # the image resources, as PIL walks them
        name_len = _be(data, pos + 6, 1)
        pos += 7 + name_len + (0 if name_len & 1 else 1)
        length = _be(data, pos, 4)
        pos += 4 + length + (length & 1)
    size = _be(data, pos, 4)
    pos += 4 + size
    compression = _be(data, pos, 2)
    pos += 2
    row = (width + 7) // 8 if mode == "1" else width
    plane = row * height
    if compression == 0:
        planes = [data[pos + c * width * height:pos + c * width * height + plane]
                  for c in range(need)]
        if any(len(p) < plane for p in planes):
            raise ValueError("image file is truncated")
    elif compression == 1:
        # PIL reads the byte counts of the channels it uses, not of all the
        # file's, and takes the data to start after them
        counts = np.frombuffer(data[pos:pos + 2 * need * height], ">u2").astype(np.int64)
        if counts.size < need * height:
            raise ValueError("image file is truncated")
        starts = pos + 2 * need * height + np.concatenate(
            [[0], np.cumsum(counts)])[::height][:need]
        planes = [_packbits(data, int(s), row, height, native) for s in starts]
    else:
        raise ValueError(f"compression {compression} is not read")
    stack = np.stack([np.frombuffer(p, np.uint8, plane).reshape(height, row) for p in planes], -1)
    if mode == "1":
        return Decoded(np.unpackbits(stack[..., 0], axis=1)[:, :width].astype(bool), "1")
    if mode == "CMYK":
        stack = 255 - stack
    if mode == "LAB":                               # PIL holds a and b as signed bytes
        stack = stack ^ np.array([0, 128, 128], np.uint8)
    if need == 1:
        return Decoded(stack[..., 0], mode, palette)
    return Decoded(stack, mode)
