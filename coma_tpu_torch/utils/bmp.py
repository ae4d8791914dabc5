"""Windows BMP files, as Pillow's ``BmpImagePlugin`` reads them.

1, 4 and 8-bit palette images ("P"; "1" or "L" where the palette is the
black-white pair or the gray ramp, as PIL ditches such a palette), 16-bit
5-5-5, 24-bit and 32-bit ("RGB"; the fourth byte is not alpha), BI_BITFIELDS
with PIL's supported masks (16-bit 5-6-5 and 5-5-5, 24-bit, 32-bit with or
without an alpha mask), RLE8 and RLE4 (PIL's decoder, quirks included: a
delta escape reads two bytes more than it uses), bottom-up and top-down.
OS/2 1.x headers (12 bytes) and Windows headers of 40 to 124 bytes.

:func:`bitmap` is PIL's ``BmpImageFile._bitmap``: the info header at any
offset, so it also reads a bare DIB (:func:`decode_dib`, PIL's
``DibImageFile``: the info header first, the pixels right after it and its
masks and palette) and the bitmaps inside icons and cursors
(``utils/ico.py``).
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_HEADERS = (40, 52, 56, 64, 108, 124)
# (bits, masks) -> PIL raw mode of BI_BITFIELDS data
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _le(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """(H, stride) bytes -> PIL's pixels for ``rawmode``."""
    if rawmode in ("P;1", "1"):
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return bits.astype(bool) if rawmode == "1" else bits
    if rawmode == "P;4":
        return np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        px = rows[:, :2 * width].reshape(rows.shape[0], width, 2).astype(np.int32)
        px = px[..., 0] | px[..., 1] << 8
        if rawmode == "BGR;15":
            r, g, b = (px >> 10) & 31, (px >> 5) & 31, px & 31
            g = g * 255 // 31
        else:
            r, g, b = (px >> 11) & 31, (px >> 5) & 63, px & 31
            g = g * 255 // 63
        return np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)
    n = 3 if rawmode == "BGR" else 4
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    order = {"BGR": [2, 1, 0], "BGRX": [2, 1, 0], "XBGR": [3, 2, 1], "BGXR": [3, 1, 0],
             "ABGR": [3, 2, 1, 0], "RGBA": [0, 1, 2, 3], "BGRA": [2, 1, 0, 3],
             "BGAR": [3, 1, 0, 2]}[rawmode]
    return np.ascontiguousarray(px[..., order])


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> bytes:
    """PIL's ``BmpRleDecoder`` from file offset ``pos``: the pixel bytes in
    file row order (it pads to whole rows only at end-of-line escapes)."""
    out = bytearray()
    x, n, want = 0, len(data), width * height
    while len(out) < want:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                               # encoded run
            count = min(count, max(0, width - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * (count // 2 + 1))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                                         # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:                                         # end of bitmap
            break
        elif byte == 2:                                         # delta: PIL reads 4 bytes
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError("a BMP delta escape runs past the end of the file")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                                   # absolute run
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                out += bytes(v for c in chunk for v in (c >> 4, c & 15))
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2                                      # word alignment in the file
    return bytes(out)


def decode_bmp(data: bytes, name: str = "<bytes>") -> Decoded:
    """A BMP file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives, and
    its mode; a ``ValueError`` naming ``name`` where PIL refuses."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    return bitmap(data, 14, _le(data, 10, 4), name=name)[0]


def dib_accept(data: bytes) -> bool:
    """PIL's ``_dib_accept``: the first four bytes are an info header's size."""
    return len(data) >= 4 and _le(data, 0, 4) in (12,) + _HEADERS


def decode_dib(data: bytes, name: str = "<bytes>") -> Decoded:
    """A bare DIB (a BMP without its 14-byte file header) as PIL's
    ``DibImageFile`` reads it."""
    return bitmap(data, 0, 0, name=name)[0]


def bitmap(data: bytes, at: int, offset: int = 0, height_div: int = 1, raw_alpha: bool = False,
           name: str = "<bytes>"):
    """PIL's ``_bitmap(header=at, offset=offset)``: the info header at
    ``at``, the pixels at ``offset`` (0: right after the header, its masks
    and its palette). ``height_div`` 2 keeps the top half of the rows an
    icon's header counts (its XOR image), and ``raw_alpha`` reads 32-bit
    data as "BGRA" (PIL does for a cursor whose bitmap starts at byte 22).
    Returns (``Decoded``, the offset of the pixel data)."""
    header_size = _le(data, at, 4)
    hdr = data[at + 4:at + header_size]
    if len(hdr) != header_size - 4 or len(data) < at + 4:
        raise ValueError(f"{name}: a BMP header that runs past the end of the file")
    pos = at + header_size                                      # the file position after it
    direction, palette_padding = -1, 4
    if header_size == 12:
        width, height, bits = _le(hdr, 0, 2), _le(hdr, 2, 2), _le(hdr, 6, 2)
        compression, colors, palette_padding = 0, 0, 3
    elif header_size in _HEADERS:
        if hdr[7] == 0xFF:                                      # negative height: top-down
            direction, height = 1, 2 ** 32 - _le(hdr, 4, 4)
        else:
            height = _le(hdr, 4, 4)
        width, bits = _le(hdr, 0, 4), _le(hdr, 10, 2)
        compression, colors = _le(hdr, 12, 4), _le(hdr, 28, 4)
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    masks = None
    if compression == 3:
        if len(hdr) >= 48:
            count = 4 if len(hdr) >= 52 else 3
            masks = [_le(hdr, 36 + 4 * i, 4) for i in range(count)] + [0] * (4 - count)
        else:
            masks = [_le(data, pos + 4 * i, 4) for i in range(3)] + [0]
            pos += 12
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    mode, rawmode = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
                     24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}.get(bits, (None, None))
    if mode is None:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    rle = False
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
        rawmode = _MASK_MODES[key]
        mode = "RGBA" if "A" in rawmode else mode
    elif compression in (1, 2):
        rle = True
    elif compression == 0:
        if bits == 32 and raw_alpha:
            mode, rawmode = "RGBA", "BGRA"
    else:
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        raw = np.frombuffer(data[pos:pos + palette_padding * colors], np.uint8)
        pos = min(pos + palette_padding * colors, len(data))
        entries = raw[:len(raw) // palette_padding * palette_padding].reshape(
            -1, palette_padding)[:, 2::-1]
        ramp = [0, 255] if colors == 2 else list(range(colors))
        gray = all(i < len(entries) and (entries[i] == v).all() for i, v in enumerate(ramp))
        if gray:
            mode = rawmode = "1" if colors == 2 else "L"
        elif len(entries) > 256:                # Pillow's putpalette refuses it
            raise ValueError(f"{name}: a BMP palette of {len(entries)} entries (invalid "
                             "palette size)")
        else:
            palette = np.ascontiguousarray(entries)
    offset = offset or pos
    height //= height_div
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a BMP of {width} x {height} pixels")
    if rle:
        if mode == "1":
            raise ValueError(f"{name}: an RLE BMP with a black-and-white palette (PIL has no "
                             "unpacker for it)")
        try:
            pixels = _rle(data, offset, width, height, compression == 2)
        except ValueError as err:
            raise ValueError(f"{name}: {err}") from None
        if len(pixels) < width * height:
            raise ValueError(f"{name}: not enough image data")
        rows = np.frombuffer(pixels[:width * height], np.uint8).reshape(height, width)
        rawmode = "L" if mode == "L" else "P"
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        if rawmode in ("L", "P") and bits != 8:
            # a gray ramp at 1 or 4 bits: PIL maps the file and reads each
            # row as 8-bit "L", ``width`` bytes from the row's start
            if offset + stride * height > len(data):
                raise ValueError(f"{name}: not enough image data")
            tail = np.frombuffer(data[offset:] + bytes(width), np.uint8)
            rows = np.stack([tail[r * stride:r * stride + width] for r in range(height)])
        else:
            # PIL's raw decoder needs the last row's pixels, not its padding
            if offset + stride * (height - 1) + (width * bits + 7) // 8 > len(data):
                raise ValueError(f"{name}: not enough image data")
            rows = np.frombuffer(data[offset:offset + stride * height].ljust(stride * height,
                                                                              b"\0"),
                                 np.uint8).reshape(height, stride)
    out = _unpack(rows, rawmode, width)
    if direction == -1:
        out = out[::-1]
    return Decoded(np.ascontiguousarray(out), mode, palette), offset
