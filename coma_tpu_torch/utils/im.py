"""IFUNC Image Memory (IM) files, as Pillow's ``ImImagePlugin`` reads them.

IM has no magic number. PIL takes a file whose first 100 bytes hold a
newline and whose header is a run of ``Key: value`` lines (each under 101
bytes, ``\\r`` ignored) up to a 0, 0x1A or the end, at least one key being
one of PIL's tags; the pixels start after the next 0x1A (and, with a
``Lut`` key, its 768-byte planar palette). ``Image type`` names the mode
and PIL's raw mode (``OPEN``); ``Image size (x*y)`` the size (512 x 512
when it is missing). Rows are stored bottom-up, and a mode's bands line by
line (``;L``: all of a row's first band, then its second, ...).

The modes PIL's IM writer writes, and the rest of ``OPEN`` that PIL can
unpack: "1"; "L"; "P" and "PA" (a ``Lut`` that is not gray; a gray ``Lut``
leaves "L" or "LA"); "LA"; "RGB" (line-interleaved, pixel-interleaved,
three planes in the order G, R, B; "RGBX" reads as "RGB"); "RGBA"; "CMYK";
"YCbCr"; "I" (32-bit); "I;16", "I;16L", "I;16B"; "F" from 8, 16 and 32-bit
integers, signed or not, from float32, and from 2 to 31-bit fields (PIL's
bit decoder, quirks included). Raw modes PIL cannot unpack are refused, as
PIL refuses them, and so is data that ends early.
"""
from __future__ import annotations

import re

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

FRAMES, SCALE, SIZE, MODE = "File size (no of images)", "Scale (x,y)", "Image size (x*y)", \
    "Image type"
TAGS = ("Comment", "Date", "Digitalization equipment", FRAMES, "Lut", "Name", SCALE, SIZE, MODE)

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# raw mode -> (bits a pixel, numpy type of its samples, bands); the
# line-interleaved ones (";L") store a row's bands one after another
_RAW = {"1": (1, None, 1), "L": (8, "u1", 1), "P": (8, "u1", 1), "P;2": (2, None, 1),
        "P;4": (4, None, 1), "RGB": (24, "u1", 3), "RGB;L": (24, "u1", 3),
        "LA;L": (16, "u1", 2), "PA;L": (16, "u1", 2), "RGBA;L": (32, "u1", 4),
        "RGBX;L": (32, "u1", 4), "CMYK;L": (32, "u1", 4), "YCbCr;L": (24, "u1", 3),
        "I;32": (32, "<u4", 1), "I;32S": (32, "<i4", 1), "I;16": (16, "<u2", 1),
        "I;16L": (16, "<u2", 1), "I;16B": (16, ">u2", 1), "F;8": (8, "u1", 1),
        "F;8S": (8, "i1", 1), "F;16": (16, "<u2", 1), "F;16S": (16, "<i2", 1),
        "F;32": (32, "<u4", 1), "F;32F": (32, "<f4", 1)}
# (mode, raw mode) pairs PIL has an unpacker for
_UNPACKS = {("1", "1"), ("L", "L"), ("P", "P"), ("P", "P;2"), ("P", "P;4"), ("RGB", "RGB"),
            ("RGB", "RGB;L"), ("LA", "LA;L"), ("PA", "PA;L"), ("RGBA", "RGBA;L"),
            ("RGB", "RGBX;L"), ("CMYK", "CMYK;L"), ("YCbCr", "YCbCr;L"), ("I", "I;32"),
            ("I", "I;32S"), ("I;16", "I;16"), ("I;16L", "I;16L"), ("I;16B", "I;16B"),
            ("F", "F;8"), ("F", "F;8S"), ("F", "F;16"), ("F", "F;16S"), ("F", "F;32"),
            ("F", "F;32F")}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def header(data: bytes, name: str) -> tuple:
    """PIL's ``ImImageFile._open``: (info, raw mode, the offset of the pixels,
    the planar palette or None); ``NotThisFormat`` where PIL's plugin gives
    the file up."""
    if b"\n" not in data[:100]:
        raise NotThisFormat(f"{name}: not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, pos, tags = "L", 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise NotThisFormat(f"{name}: not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise NotThisFormat(f"{name}: not an IM file (header syntax)")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k != "Comment":
            info[k] = v
        tags += k in TAGS
    if not tags:
        raise NotThisFormat(f"{name}: not an IM file (no IM tags)")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise NotThisFormat(f"{name}: IM file truncated in its header")
    lut = None
    if "Lut" in info:
        lut = np.frombuffer(data[pos:pos + 768], np.uint8)
        pos += lut.size
        if lut.size < 768:
            raise NotThisFormat(f"{name}: IM file truncated in its Lut")
    return info, rawmode, pos, lut


def _bits(data: bytes, pos: int, bits: int, width: int, height: int) -> np.ndarray:
    """PIL's ``BitDecode.c`` with fill 3 and row padding: each byte goes into
    a 64-bit buffer above the bits it holds, fields leave from its low end,
    and a new row sets the count of held bits to 0 but keeps the buffer's
    leftover high bits, which the next bytes are ORed onto. (H, W) float32
    in file row order."""
    out = np.zeros(height * width, np.float32)
    mask, buffer, count, k = (1 << bits) - 1, 0, 0, 0
    for byte in data[pos:]:
        buffer = (buffer | byte << count) & 0xFFFFFFFFFFFFFFFF
        count += 8
        while count >= bits:
            value = buffer & mask
            buffer = byte >> (8 - (count - bits)) if count > 32 else buffer >> bits
            count -= bits
            out[k] = value
            k += 1
            if k % width == 0:
                if k == out.size:
                    return out.reshape(height, width)
                count = 0
    raise ValueError("image file is truncated")


def decode_im(data: bytes, name: str = "<bytes>") -> Decoded:
    """An IM file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; ``NotThisFormat`` where PIL's plugin does not take the
    file, a ``ValueError`` naming ``name`` where PIL refuses it."""
    info, rawmode, pos, lut = header(data, name)
    size, mode = info[SIZE], info[MODE]
    if not isinstance(size, tuple) or len(size) < 2:
        raise NotThisFormat(f"{name}: IM size {size!r} is not a width and a height")
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"{name}: IM size {size!r} is not two whole numbers (PIL fails on it)")
    width, height = size
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an IM image of {width} x {height} pixels")
    palette = None
    if lut is not None:
        planes = lut.reshape(3, 256)
        gray = bool((planes[0] == planes[1]).all() and (planes[1] == planes[2]).all())
        if mode in ("L", "LA", "P", "PA") and not gray:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = np.ascontiguousarray(planes.T)
    if mode == "P" and palette is None:
        palette = np.zeros((0, 3), np.uint8)    # no Lut: PIL's empty palette, every index black
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16,
                                                                                      32):
        bits = int(rawmode[2:])
        if bits >= 32:
            raise ValueError(f"{name}: IM: PIL's bit decoder takes 1 to 31 bits, not {bits}")
        try:
            return Decoded(np.ascontiguousarray(_bits(data, pos, bits, width, height)[::-1]), "F")
        except ValueError as err:
            raise ValueError(f"{name}: IM: {err}") from None
    if rawmode in ("RGB;T", "RYB;T"):
        plane = width * height
        if len(data) < pos + 3 * plane:
            raise ValueError(f"{name}: IM: image file is truncated")
        g, r, b = (np.frombuffer(data, np.uint8, plane, pos + k * plane).reshape(height, width)
                   for k in range(3))
        return Decoded(np.ascontiguousarray(np.stack([r, g, b], -1)[::-1]), "RGB")
    if (mode, rawmode) not in _UNPACKS:
        raise ValueError(f"{name}: IM: PIL has no unpacker from {rawmode!r} to {mode!r}")
    bits, dtype, bands = _RAW[rawmode]
    row_bytes = (width * bits + 7) // 8
    if len(data) < pos + row_bytes * height:
        raise ValueError(f"{name}: IM: image file is truncated")
    raw = np.frombuffer(data, np.uint8, row_bytes * height, pos).reshape(height, row_bytes)[::-1]
    if rawmode == "1":
        return Decoded(np.unpackbits(raw, axis=1)[:, :width].astype(bool), mode)
    if rawmode in ("P;2", "P;4"):
        per = 8 // bits
        fields = np.stack([(raw >> (8 - bits * (k + 1))) & ((1 << bits) - 1)
                           for k in range(per)], -1)
        return Decoded(fields.reshape(height, -1)[:, :width].astype(np.uint8), mode, palette)
    samples = np.ascontiguousarray(raw).view(dtype)
    if rawmode.endswith(";L"):
        samples = samples.reshape(height, bands, width).transpose(0, 2, 1)
    elif bands > 1:
        samples = samples.reshape(height, width, bands)
    if rawmode == "RGBX;L":
        samples = samples[..., :3]
    if mode == "F":
        samples = samples.astype(np.float32)
    elif mode == "I":
        samples = samples.astype(np.int32)
    elif mode == "I;16L" or mode == "I;16":
        samples = samples.astype(np.uint16)
    return Decoded(np.ascontiguousarray(samples), mode, palette)
