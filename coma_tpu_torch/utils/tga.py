"""Truevision TGA files, as Pillow's ``TgaImagePlugin`` reads them.

Image types 1 (colour-mapped), 2 (true colour) and 3 (gray), and their
run-length coded forms 9, 10 and 11: "P" (a colour map is needed), "1",
"L", "LA", "RGB" at 24 bits and "RGBA" at 16 (5-5-5 with an inverted alpha
bit, PIL's ``BGRA;15Z``) and 32, colour maps of 16 and 24 bits (PIL refuses
32), and the
four origins (bottom-up by default, flipped left-right as bit 4 says). A
run-length packet that crosses a row end is refused, as PIL's decoder
refuses it; a literal packet may. TGA has no magic number: as PIL does,
a file is a TGA when its header is valid and no other reader claims it.

The run-length decoding has a native twin in ``native/src/image_codecs.cpp``
(``tga_rle_decode``); :func:`rle_decode` picks it, or this plain Python
version, which is its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
             (2, 24): "BGR", (2, 32): "BGRA"}


def _le16(data: bytes, at: int) -> int:
    return data[at] | data[at + 1] << 8


def header_ok(data: bytes) -> bool:
    """PIL's validity test: colour-map type 0 or 1, a positive size and a
    pixel depth of 1, 8, 16, 24 or 32."""
    return (len(data) >= 18 and data[1] in (0, 1) and _le16(data, 12) > 0
            and _le16(data, 14) > 0 and data[16] in (1, 8, 16, 24, 32))


def rle_decode_python(data: bytes, pos: int, row_bytes: int, rows: int,
                      pixel_bytes: int) -> bytes:
    """PIL's ``TgaRleDecode`` from ``pos``: packets of a header byte (bit 7 a
    run of one pixel, else a literal of pixels; low 7 bits the count less
    one) until ``rows`` rows of ``row_bytes`` are full. The reference of
    the native decoder."""
    out, n, want = bytearray(), len(data), row_bytes * rows
    while len(out) < want:
        if pos >= n:
            raise ValueError("the run-length data ends before the image is full")
        head = data[pos]
        count = pixel_bytes * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + pixel_bytes > n:
                raise ValueError("the run-length data ends before the image is full")
            if len(out) % row_bytes + count > row_bytes:
                raise ValueError("a run-length packet crosses the end of a row")
            out += data[pos + 1:pos + 1 + pixel_bytes] * (count // pixel_bytes)
            pos += 1 + pixel_bytes
        else:
            if pos + 1 + count > n:
                raise ValueError("the run-length data ends before the image is full")
            out += data[pos + 1:pos + 1 + count]
            pos += 1 + count
    return bytes(out[:want])


def rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, pixel_bytes: int,
               native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, pos, row_bytes, rows, pixel_bytes)
    return codecs.tga_rle_decode(data, pos, row_bytes, rows, pixel_bytes)


def _unpack(raw: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """(H, row bytes) -> PIL's pixels for ``rawmode``."""
    H = raw.shape[0]
    if rawmode == "1":
        return np.unpackbits(raw, axis=1)[:, :width].astype(bool)
    if rawmode in ("P", "L"):
        return raw[:, :width]
    if rawmode == "LA":
        return raw[:, :2 * width].reshape(H, width, 2)
    if rawmode == "BGRA;15Z":
        return _bgra15z(raw[:, :2 * width].reshape(H, width, 2))
    n = 3 if rawmode == "BGR" else 4
    px = raw[:, :n * width].reshape(H, width, n)
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:n]])


def _bgra15z(pairs: np.ndarray) -> np.ndarray:
    """(..., 2) little-endian 16-bit pixels -> (..., 4) RGBA: 5 bits each of
    blue, green, red scaled to 0..255, alpha 255 where bit 15 is clear."""
    px = pairs[..., 0].astype(np.int32) | pairs[..., 1].astype(np.int32) << 8
    rgb = [((px >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    alpha = np.where(px >> 15, 0, 255)
    return np.stack(rgb + [alpha], -1).astype(np.uint8)


def decode_tga(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A TGA file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives, and
    its mode; a ``ValueError`` naming ``name`` where PIL refuses."""
    if not header_ok(data):
        raise NotThisFormat(f"{name}: not a TGA file")
    id_len, cmap_type, itype, depth, flags = data[0], data[1], data[2], data[16], data[17]
    width, height = _le16(data, 12), _le16(data, 14)
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        if not cmap_type:
            raise ValueError(f"{name}: a colour-mapped TGA without a colour map (PIL refuses "
                             "it)")
        mode = "P"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat(f"{name}: unknown TGA image type {itype}")
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    top_down = orientation in (0x20, 0x30)
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = _le16(data, 3), _le16(data, 5), data[7]
        if map_depth not in (16, 24, 32):
            raise NotThisFormat(f"{name}: unknown TGA map depth {map_depth}")
        if map_depth == 32:
            raise ValueError(f"{name}: a TGA colour map of {map_depth} bits is not read (PIL "
                             "refuses it)")
        nbytes = map_depth // 8
        raw = np.frombuffer(data[pos:pos + nbytes * size], np.uint8)
        pos += nbytes * size
        entries = raw[:len(raw) // nbytes * nbytes].reshape(-1, nbytes)
        colours = _bgra15z(entries)[:, :3] if map_depth == 16 else entries[:, ::-1]
        palette = np.concatenate([np.zeros((start, 3), np.uint8), colours])
        if len(palette) > 256 and itype & 7 == 1:   # Pillow's putpalette refuses it
            raise ValueError(f"{name}: a TGA colour map of {len(palette)} entries (invalid "
                             "palette size)")
    rawmode = _RAWMODES.get((itype & 7, depth))
    if rawmode is None:
        raise ValueError(f"{name}: PIL cannot decode a TGA of type {itype} at {depth} bits")
    pixel_bytes = (depth + 7) // 8
    row_bytes = (width * depth + 7) // 8
    if itype & 8:
        try:
            pixels = rle_decode(data, pos, row_bytes, height, pixel_bytes, native)
        except ValueError as err:
            raise ValueError(f"{name}: {err}") from None
    else:
        pixels = data[pos:pos + row_bytes * height]
        if len(pixels) < row_bytes * height:
            raise ValueError(f"{name}: not enough image data")
    out = _unpack(np.frombuffer(pixels, np.uint8).reshape(height, row_bytes), rawmode, width)
    if not top_down:
        out = out[::-1]
    if flip:
        out = out[:, ::-1]
    return Decoded(np.ascontiguousarray(out), mode, palette)
