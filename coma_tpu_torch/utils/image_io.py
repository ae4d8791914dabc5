"""One reader for every image file ``coma_tpu`` opens with PIL.

:func:`read_image` gives the array that
``np.asarray(PIL.Image.open(path).convert(mode))`` gives, for mode None (the
file's own mode, as PIL holds it), "RGB" or "L". It picks the format by the
file's first bytes, as PIL does, not by its name:

- PNG (``utils/png.py``): gray at 1-16 bits, RGB(A), palette, gray+alpha,
  Adam7-interlaced;
- JPEG (``utils/jpeg.py``, libjpeg-turbo's decoder): baseline, extended,
  progressive and lossless, Huffman or arithmetic coded, every sampling,
  gray, YCbCr, RGB, CMYK and YCCK;
- GIF (``utils/gif_reader.py``): the first frame, "P" or "L";
- WebP (``utils/webp.py``): lossy with its alpha, lossless, an animation's
  first frame;
- DDS (``utils/dds.py``): BC1-BC7, bit masks, luminance, palettes;
- PSD (``utils/psd.py``): the composite image of every mode PIL reads;
- BMP (``utils/bmp.py``), TIFF (``utils/tiff.py``, first page, JPEG
  compression included), PBM/PGM/PPM (``utils/pnm.py``) and, as PIL's last
  resort for a file with no magic number, TGA (``utils/tga.py``).

The card machine has no PIL. JPEG 2000 files, TIFFs with CCITT or old-style
JPEG compression, a Lab PSD's conversions, and anything PIL itself refuses
raise a ``ValueError`` naming the file (and the format where it is known).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from coma_tpu_torch.utils import bmp, dds, gif_reader, jpeg, pnm, psd, tga, tiff, webp
from coma_tpu_torch.utils.modes import Decoded, to_mode
from coma_tpu_torch.utils.png import decode_png_pil

# formats PIL reads that the port does not: (test of the first bytes, name)
_NOT_READ = (
    (lambda d: d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or d[:4] == b"\xffO\xffQ",
     "JPEG 2000"),
)


def _jpeg(data: bytes, name: str) -> Decoded:
    pixels = jpeg.decode_jpeg(data, name)
    if pixels.shape[-1] == 1:
        return Decoded(pixels[..., 0], "L")
    return Decoded(pixels, "CMYK" if pixels.shape[-1] == 4 else "RGB")


def decode_image(data: bytes, name: str = "<bytes>") -> Decoded:
    """An image file's bytes -> PIL's array and mode (``utils.modes.Decoded``)."""
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        return decode_png_pil(data, name)
    if data.startswith(b"\xff\xd8"):
        return _jpeg(data, name)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return gif_reader.decode_gif(data, name)
    if data[:2] == b"BM":
        return bmp.decode_bmp(data, name)
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return tiff.decode_tiff(data, name)
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
        return pnm.decode_pnm(data, name)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return webp.decode_webp(data, name)
    if data[:4] == b"DDS ":
        return dds.decode_dds(data, name)
    if data[:4] == b"8BPS":
        return psd.decode_psd(data, name)
    for test, fmt in _NOT_READ:
        if test(data):
            raise ValueError(f"{name}: a {fmt} file is not read")
    if tga.header_ok(data):
        return tga.decode_tga(data, name)
    raise ValueError(f"{name}: not an image file of a format read here (PNG, JPEG, GIF, BMP, "
                     "TIFF, PBM/PGM/PPM, TGA)")


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert(mode))``: mode None gives
    the file's own array (a palette image's indices, gray as (H, W), 1-bit
    as bool, 16-bit gray as uint16, CMYK as PIL's (H, W, 4)); "RGB" (H, W, 3)
    uint8; "L" (H, W) uint8, PIL's ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``."""
    if mode not in (None, "RGB", "L"):
        raise ValueError(f"mode {mode!r}: only None, 'RGB' and 'L' are read")
    with open(path, "rb") as fh:
        data = fh.read()
    decoded = decode_image(data, str(path))
    try:
        return to_mode(decoded, mode)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
