"""PIL's image modes and its ``convert`` to "RGB" and "L", for the readers.

Every reader of ``utils/`` returns a :class:`Decoded`: the array
``np.asarray(PIL.Image.open(path))`` gives, with PIL's mode name (and the
palette of a "P" image). :func:`to_mode` is ``Image.convert(mode)`` of it,
in PIL's integer arithmetic:

- "L" from colour is ITU-R 601-2 luma, ``(19595 R + 38470 G + 7471 B +
  2^15) >> 16``; a palette image converts its palette entries (entries past
  the palette are black);
- "1" is 0 or 255; "I;16", "I;16B" and "I" are clipped to 0..255; "F" is
  truncated toward zero and clipped (NaN gives 0); alpha and "RGBX"'s pad
  are dropped, not composited; "PA" converts its palette entries as "P";
- "YCbCr" to "L" is its Y; to "RGB" it is ``ImagingConvertYCbCr2RGB``'s
  fixed point: ``y + (T[c] >> 6)`` clipped, with each table entry
  ``T[c] = (int)(k * (c - 128) * 64 + 0.5)`` (C's truncating cast) for k
  1.402 (red from Cr), 1.772 (blue from Cb), and green from the sum of
  the -0.34414 (Cb) and -0.71414 (Cr) entries;
- "CMYK" to "RGB" is ``cmyk2rgb``: ``nk - nk C / 255`` with ``nk = 255 - K``,
  in PIL's ``MULDIV255`` rounding;
- "LAB" (a Photoshop or CIELab TIFF file's) to "RGB" is Little CMS's
  Lab -> sRGB transform as Pillow builds it (``utils/lcms.py``); to "L" it
  raises, as PIL refuses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

GRAY_MODES = ("1", "L", "LA", "I;16", "I;16L", "I;16B", "I", "F")
COLOUR_MODES = ("P", "PA", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr")


class Decoded(NamedTuple):
    pixels: np.ndarray                      # np.asarray(PIL image): (H, W) or (H, W, C)
    mode: str                               # PIL's mode
    palette: Optional[np.ndarray] = None    # (N, 3) uint8 RGB, modes "P" and "PA"


class NotThisFormat(ValueError):
    """The file is not of the reader's format as PIL's plugin judges it:
    its ``_open`` raises SyntaxError (or IndexError, TypeError, KeyError,
    EOFError, struct.error), or gives a size of zero, and ``Image.open``
    goes on to the next plugin in its order."""


class FormatNotRead(ValueError):
    """A file of a format PIL reads and the port does not; ``format`` names
    it."""

    def __init__(self, name: str, fmt: str, detail: str = ""):
        super().__init__(f"{name}: {fmt}: a format PIL reads that is not read here{detail}")
        self.format = fmt


def luma(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) -> (...) uint8: PIL's ``L = (19595 R + 38470 G + 7471 B +
    2^15) >> 16``."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(H, W, 4) -> (H, W, 3) uint8: PIL's ``cmyk2rgb``."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    return np.clip(nk - _muldiv255(c[..., :3], nk), 0, 255).astype(np.uint8)


def _ycbcr_table(k: float) -> np.ndarray:
    return np.trunc(k * (np.arange(256) - 128) * 64 + 0.5).astype(np.int32)


_R_CR, _B_CB = _ycbcr_table(1.402), _ycbcr_table(1.772)
_G_CB, _G_CR = _ycbcr_table(-0.34414), _ycbcr_table(-0.71414)


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> (..., 3) uint8: PIL's ``ImagingConvertYCbCr2RGB``."""
    y = ycc[..., 0].astype(np.int32)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _gray(img: Decoded) -> np.ndarray:
    px, mode = img.pixels, img.mode
    if mode == "1":
        return px.astype(np.uint8) * np.uint8(255)
    if mode == "LA":
        return px[..., 0]
    if mode == "F":
        out = np.zeros(px.shape, np.uint8)      # NaN and v <= 0 give 0
        mid = (px > 0) & (px < 255)
        out[mid] = px[mid].astype(np.uint8)
        out[px >= 255] = 255
        return out
    if mode.startswith("I"):
        return np.clip(px, 0, 255).astype(np.uint8)
    return px


def _rgb(img: Decoded) -> np.ndarray:
    px, mode = img.pixels, img.mode
    if mode in ("P", "PA"):
        palette = np.zeros((256, 3), np.uint8)
        if img.palette is not None:
            entries = np.asarray(img.palette, np.uint8).reshape(-1, 3)[:256]
            palette[:len(entries)] = entries
        return palette[px if mode == "P" else px[..., 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(px)
    if mode == "YCbCr":
        return ycbcr_to_rgb(px)
    return px[..., :3]


def to_mode(img: Decoded, mode: Optional[str]) -> np.ndarray:
    """``np.asarray(image.convert(mode))`` for mode "RGB" or "L"; the image's
    own array for None."""
    if mode is None:
        return img.pixels
    if img.mode == "LAB":
        if mode == "RGB":
            from coma_tpu_torch.utils import lcms

            return lcms.lab_to_rgb(img.pixels)
        raise ValueError(f"conversion from LAB to {mode} not supported (PIL refuses it too)")
    if img.mode not in GRAY_MODES + COLOUR_MODES:
        raise ValueError(f"PIL mode {img.mode!r} is not converted here")
    if img.mode in GRAY_MODES:
        gray = _gray(img)
        return np.repeat(gray[..., None], 3, axis=-1) if mode == "RGB" else gray
    if img.mode == "YCbCr" and mode == "L":
        return img.pixels[..., 0]
    rgb = _rgb(img)
    return rgb if mode == "RGB" else luma(rgb)
