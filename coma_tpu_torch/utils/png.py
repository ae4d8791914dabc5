"""A minimal PNG reader and writer; zlib does the rest.

The writer takes 8-bit gray, gray+alpha, RGB and RGBA. The reader also takes
palette images (bit depths 1 to 8) and 16-bit and low-bit gray ones,
non-interlaced or Adam7-interlaced, all five filter types. The CLIs read renders, masks and
texture maps and write their images with it, so the port needs no imaging
library. :func:`read_png` returns what PIL holds for the file's mode, and
:func:`to_rgb` and :func:`to_gray` are PIL's ``convert("RGB")`` and
``convert("L")`` of it (alpha is dropped, not composited; gray is ITU-R 601-2
luma in PIL's fixed point). Damage is taken as PIL takes it: the chunks
before the image data must be whole with good CRCs; the IDATs' CRCs are not
checked and the file may end inside them once the image's bytes are in;
zlib inflates only those bytes (a broken stream or checksum it meets first
is refused); later chunks must be whole up to IEND.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type -> channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 1, level: int = 6) -> bytes:
    """PNG bytes of a uint8 (H, W) or (H, W, C) image, C in 1..4, every row
    filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"PNG writer takes 1 to 4 channels, got {C}")
    x = img.reshape(H, W * C)
    a = np.zeros_like(x)                     # left neighbour (bpp bytes back)
    a[:, C:] = x[:, :-C]
    b = np.zeros_like(x)                     # the row above
    b[1:] = x[:-1]
    c = np.zeros_like(x)                     # above-left
    c[1:, C:] = x[:-1, :-C]
    predictor = {
        0: lambda: np.zeros_like(x),
        1: lambda: a,
        2: lambda: b,
        3: lambda: ((a.astype(np.uint16) + b) // 2).astype(np.uint8),
        4: lambda: _paeth(a, b, c),
    }[filter_type]()
    filtered = x - predictor                 # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if ftype == 0:
        return row
    if ftype == 1:
        return (np.cumsum(row.reshape(-1, bpp).astype(np.uint32), axis=0) & 0xFF) \
            .astype(np.uint8).reshape(-1)
    if ftype == 2:
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    out = [0] * len(row)
    f, up = row.tolist(), prior.tolist()
    for i in range(len(f)):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (left + up[i]) >> 1
        else:
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
        out[i] = (f[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def _unpack_bits(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """Samples of ``depth`` < 8 bits, packed high bits first, -> uint8 (H, count)."""
    bits = np.unpackbits(rows, axis=1)[:, : count * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(rows.shape[0], count, depth) * weights).sum(-1).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """uint8 (H, W, C): C = 1 gray, 2 gray+alpha, 3 RGB (palette images
    expanded through PLTE, tRNS ignored), 4 RGBA. 16-bit samples keep their
    high byte, except 16-bit gray, which PIL saturates at 255; 1-, 2- and
    4-bit gray is scaled to 0..255. ``utils/image_io.read_image`` gives
    PIL's own arrays (palette indices, uint16 gray)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(raw: np.ndarray, stride: int, bpp: int, name: str) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) bytes."""
    h = raw.shape[0]
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{name}: unknown PNG filter type {kinds.max()}")
    if stride % bpp == 0 and np.isin(kinds, (0, 1)).all():
        # None and Sub filter each row on its own: all rows at once (the
        # port's writer uses Sub)
        sub = np.cumsum(raw[:, 1:].reshape(h, -1, bpp), axis=1, dtype=np.uint8)  # wraps mod 256
        return sub.reshape(h, stride) if (kinds == 1).all() else np.where(
            (kinds == 1)[:, None], sub.reshape(h, stride), raw[:, 1:])
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered (h, stride) bytes -> (h, width * channels) samples: uint16
    at depth 16, the raw level or palette index below 8."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return pairs[..., 0] << 8 | pairs[..., 1]
    if depth < 8:
        return _unpack_bits(rows, depth, width * channels)
    return rows


def _inflate(stream: bytes, needed: int, name: str) -> bytes:
    """The first ``needed`` bytes zlib inflates from ``stream``, as PIL's
    decoder takes them: fewer where the stream is cut short, and past the
    last of them zlib goes on only through what writes nothing (an end of
    block, the checksum); a ``ValueError`` where it meets broken data first."""
    try:
        return zlib.decompressobj().decompress(stream, needed)
    except zlib.error as err:
        raise ValueError(f"{name}: broken data stream ({err})") from None


def _trailing_chunks_ok(data: bytes, pos: int) -> bool:
    """PIL's ``load_end``: after the image data it reads each following
    chunk until IEND or a header that is not one (a chunk type of 4
    letters), and fails where a chunk's data runs past the end of the file."""
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if not kind.isalpha() or not kind.isascii() or kind == b"IEND":
            return True
        if pos + 8 + length > len(data):
            return False
        pos += 12 + length
    return True


def _decode_samples(data: bytes, name: str):
    """PNG bytes -> (samples (H, W, C): uint16 at depth 16, raw levels or
    palette indices below 8; bit depth; colour type; PLTE (N, 3) or None)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat, palette = len(_SIGNATURE), None, [], None
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{name}: a PNG chunk runs past the end of the file")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IDAT":
            # PIL checks no IDAT's CRC and reads the run of IDATs as far as
            # the file goes; of the chunks after it, only that each is whole
            while kind == b"IDAT":
                idat.append(data[pos + 8:pos + 8 + length])
                pos += 12 + length
                if pos + 8 > len(data):
                    break
                (length,) = struct.unpack(">I", data[pos:pos + 4])
                kind = data[pos + 4:pos + 8]
            if not _trailing_chunks_ok(data, pos):
                raise ValueError(f"{name}: a chunk after the image data runs past the end of "
                                 "the file")
            break
        if pos + 12 + length > len(data):
            raise ValueError(f"{name}: a PNG chunk runs past the end of the file")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{name}: an IHDR chunk of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    paletted = ctype == 3
    C = 1 if paletted else _CHANNELS.get(ctype)
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if C is None or depth not in allowed or interlace not in (0, 1):
        raise ValueError(f"{name}: only gray, RGB(A) and palette PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    if paletted and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    bpp = max(1, C * depth // 8)            # the filters' byte distance
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    needed = sum(h * ((w * C * depth + 7) // 8 + 1) for w, h in
                 ((-(-(W - x0) // dx), -(-(H - y0) // dy)) for x0, y0, dx, dy in passes)
                 if w > 0 and h > 0)
    raw = np.frombuffer(_inflate(b"".join(idat), needed, name), np.uint8)
    out = np.empty((H, W * C), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w <= 0 or h <= 0:
            continue                        # an empty pass has no scanlines
        stride = (w * C * depth + 7) // 8
        if raw.size < pos + h * (stride + 1):
            raise ValueError(f"{name}: image data has {raw.size} bytes, expected at least "
                             f"{pos + h * (stride + 1)}")
        rows = _unfilter(raw[pos:pos + h * (stride + 1)].reshape(h, stride + 1), stride, bpp, name)
        pos += h * (stride + 1)
        out.reshape(H, W, C)[y0::dy, x0::dx] = _samples(rows, w, C, depth).reshape(h, w, C)
    if paletted and out.max(initial=0) >= len(palette):
        raise ValueError(f"{name}: palette index beyond the {len(palette)} PLTE entries")
    return out.reshape(H, W, C), depth, ctype, palette


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> :func:`read_png`'s array; ``name`` names the file in
    errors."""
    out, depth, ctype, palette = _decode_samples(data, name)
    if depth == 16:
        if ctype == 0:                      # PIL's I;16 -> L / RGB saturates
            out = np.minimum(out, 255).astype(np.uint8)
        else:
            out = (out >> 8).astype(np.uint8)
    elif depth < 8 and ctype != 3:
        out = out * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        return palette[out[..., 0]]
    return out


def decode_png_pil(data: bytes, name: str = "<bytes>"):
    """PNG bytes -> ``utils.modes.Decoded``: the array and mode PIL holds
    (``PngImagePlugin._MODES``): gray "1" (bool) at depth 1, "L" at 2-8
    (scaled to 0..255), "I;16" (uint16) at 16; "RGB"; "P" (indices, with the
    PLTE); "LA"; "RGBA". 16-bit colour keeps its high byte, and 16-bit gray
    with alpha becomes "RGBA", as in PIL."""
    from coma_tpu_torch.utils.modes import Decoded

    out, depth, ctype, palette = _decode_samples(data, name)
    if ctype == 3:
        return Decoded(out[..., 0], "P", palette)
    if ctype == 0:
        if depth == 1:
            return Decoded(out[..., 0].astype(bool), "1")
        if depth == 16:
            return Decoded(out[..., 0], "I;16")
        return Decoded(out[..., 0] * np.uint8(255 // ((1 << depth) - 1)), "L")
    if depth == 16:
        out = (out >> 8).astype(np.uint8)
    if ctype == 4:
        if depth == 16:
            return Decoded(out[..., [0, 0, 0, 1]], "RGBA")
        return Decoded(out, "LA")
    return Decoded(out, "RGB" if ctype == 2 else "RGBA")


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W, 3): gray is repeated, alpha dropped."""
    return np.repeat(image[..., :1], 3, axis=-1) if image.shape[-1] <= 2 else image[..., :3]


def to_gray(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W): PIL's ``L = (19595 R + 38470 G + 7471 B + 2^15) >> 16``."""
    if image.shape[-1] <= 2:
        return image[..., 0]
    rgb = image[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
