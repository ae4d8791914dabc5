"""Netpbm files (PBM, PGM, PPM; P1-P6) and Pillow's own magics, as
Pillow's ``PpmImagePlugin`` reads them.

P1 and P4 give "1"; P2 and P5 "L", or "I" (int32, scaled to 0..65535) when
maxval exceeds 255; P3 and P6 "RGB". A maxval other than 255 (65535 for
16-bit gray) is scaled as PIL scales it: ``round(v / maxval * out_max)``
with Python's rounding, at most ``out_max``. The header's tokens may carry
``#`` comments; one whitespace byte ends it. Pillow's extensions: ``Pf``
(PFM) is "F", float32 rows stored bottom-up, little-endian where the scale
is negative, big-endian where it is positive (a scale of 0 or not finite is
refused); ``P0CMYK`` and ``PyCMYK`` are "CMYK", ``PyRGBA`` "RGBA" and
``PyP`` "P" (with no palette, so every index converts to black), each
with a maxval as P5/P6 take it. A magic Pillow does not know
hands the file on (``NotThisFormat``).
"""
from __future__ import annotations

import math

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _token(data: bytes, pos: int, name: str):
    """PIL's ``_read_token``: the next header token and the position after
    the whitespace byte that ends it."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError(f"{name}: reached the end of the file while reading the PNM header")
    if len(token) > 10:
        raise ValueError(f"{name}: a PNM header token too long")
    return token, pos


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """PIL's ``min(out_max, round(v / maxval * out_max))`` (round half to even)."""
    return np.minimum(out_max, np.round(values.astype(np.float64) / maxval * out_max))


def _plain_tokens(body: bytes) -> list:
    """The data tokens of a plain (P2/P3) file, comments removed."""
    lines = []
    for line in body.replace(b"\r", b"\n").split(b"\n"):
        lines.append(line.split(b"#", 1)[0])
    return b" ".join(lines).split()


def decode_pnm(data: bytes, name: str = "<bytes>") -> Decoded:
    """A PBM/PGM/PPM file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where PIL refuses."""
    magic, pos = b"", 0
    while pos < min(len(data), 6):              # PIL reads at most six bytes of magic
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise NotThisFormat(f"{name}: not a PPM file (magic {magic!r})")
    mode = _MODES[magic]
    w, pos = _token(data, pos, name)
    h, pos = _token(data, pos, name)
    width, height = int(w), int(h)
    if mode == "F":
        token, pos = _token(data, pos, name)
        scale = float(token)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{name}: scale must be finite and non-zero")
        need = width * height * 4
        if len(data) - pos < need:
            raise ValueError(f"{name}: image file is truncated")
        rows = np.frombuffer(data, "<f4" if scale < 0 else ">f4", width * height, pos)
        return Decoded(rows.reshape(height, width)[::-1].astype(np.float32), "F")
    maxval = 1
    if mode != "1":
        token, pos = _token(data, pos, name)
        maxval = int(token)
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    bands = _BANDS[mode]
    count = width * height * bands
    out_max = 65535 if mode == "I" else 255
    body = data[pos:]
    if magic == b"P4":
        stride = (width + 7) // 8
        if len(body) < stride * height:
            raise ValueError(f"{name}: not enough image data")
        rows = np.frombuffer(body[:stride * height], np.uint8).reshape(height, stride)
        pixels = np.unpackbits(rows, axis=1)[:, :width] == 0
        return Decoded(pixels, mode)
    if magic == b"P1":
        tokens = b"".join(_plain_tokens(body))
        if any(t not in b"01" for t in tokens):
            raise ValueError(f"{name}: a PBM token other than 0 or 1")
        if len(tokens) < width * height:
            raise ValueError(f"{name}: not enough image data")
        bits = np.frombuffer(tokens[:width * height], np.uint8).reshape(height, width)
        return Decoded(bits == ord("0"), mode)
    if magic in (b"P2", b"P3"):
        tokens = _plain_tokens(body)[:count]
        if len(tokens) < count:
            raise ValueError(f"{name}: not enough image data")
        values = np.array([int(t) for t in tokens], np.int64)
        if (values < 0).any() or (values > maxval).any():
            raise ValueError(f"{name}: a channel value outside 0..{maxval}")
        values = _scale(values, maxval, out_max)
    else:
        wide = maxval > 255
        need = count * (2 if wide else 1)
        if len(body) < need:
            raise ValueError(f"{name}: not enough image data")
        values = np.frombuffer(body[:need], ">u2" if wide else np.uint8)
        if not (maxval == 255 or (maxval == 65535 and mode == "I")):
            values = _scale(values, maxval, out_max)
    dtype = np.int32 if mode == "I" else np.uint8
    shape = (height, width, bands) if bands > 1 else (height, width)
    palette = np.zeros((0, 3), np.uint8) if mode == "P" else None
    return Decoded(np.asarray(values).astype(dtype).reshape(shape), mode, palette)
