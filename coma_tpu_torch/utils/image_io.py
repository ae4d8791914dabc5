"""One reader for every image file ``coma_tpu`` opens with PIL.

:func:`read_image` gives the array that
``np.asarray(PIL.Image.open(path).convert(mode))`` gives, for mode None (the
file's own mode, as PIL holds it), "RGB" or "L". :func:`decode_image` picks
the format as ``PIL.Image.open`` does, not by the file's name: Pillow
12.1.0's plugins in their order (:data:`PLUGINS`), each an accept test of
the first 16 bytes (none for IM, IMT, IPTC, PCD, SPIDER and TGA, which try
every file) and an opener that hands the file on where PIL's ``_open``
gives it up. Read:

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
- PSD and TIFF "LAB" images to "RGB" through Little CMS's transform
  (``utils/lcms.py``);
- JPEG 2000 (``utils/jp2.py`` over ``utils/j2k.py``, OpenJPEG's decoder):
  JP2 and bare codestreams, reversible and irreversible, every progression,
  POC, tiles, precincts, quality layers, code-block styles, ROI, SOP/EPH,
  PPM/PPT, subsampled components, palettes; HTJ2K code-blocks refused;
- BMP and bare DIB (``utils/bmp.py``), TIFF (``utils/tiff.py``, first page,
  every compression Pillow's libtiff reads: none, PackBits, LZW, Deflate,
  JPEG, CCITT RLE/RLEW, Group 3, Group 4, ThunderScan, LZMA, Zstandard and
  old-style JPEG; CIELab too), PBM/PGM/PPM and Pillow's PFM, P0 and Py
  magics (``utils/pnm.py``), TGA (``utils/tga.py``);
- SGI (``utils/sgi.py``), PCX and DCX (``utils/pcx.py``), ICO and CUR
  (``utils/ico.py``), QOI (``utils/qoi.py``), XBM (``utils/xbm.py``), IM
  (``utils/im.py``), ICNS (``utils/icns.py``, PNG and JPEG 2000 members),
  BLP (``utils/blp.py``), Sun raster (``utils/sun.py``), MSP
  (``utils/msp.py``) and SPIDER (``utils/spider.py``).

Refused with ``utils.modes.FormatNotRead``, a ``ValueError`` naming the file
and the format, though PIL reads them: HTJ2K code-blocks, AVIF, XPM, FTEX,
GBR, PIXAR, FLI/FLC, PCD, McIdas, IMT, FITS, XV thumbnails, IPTC/NAA, MPEG,
EPS, WMF/EMF and the BUFR, GRIB and HDF5 stubs. What PIL itself refuses raises a ``ValueError``
naming the file. The card machine has no PIL.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

from coma_tpu_torch.utils import (blp, bmp, dds, gif_reader, icns, ico, im, jp2, jpeg, msp, pcx,
                                  pnm, psd, qoi, sgi, spider, sun, tga, tiff, webp, xbm)
from coma_tpu_torch.utils.modes import Decoded, FormatNotRead, NotThisFormat, to_mode
from coma_tpu_torch.utils.png import decode_png_pil


def _jpeg(data: bytes, name: str) -> Decoded:
    pixels = jpeg.decode_jpeg(data, name)
    if pixels.shape[-1] == 1:
        return Decoded(pixels[..., 0], "L")
    return Decoded(pixels, "CMYK" if pixels.shape[-1] == 4 else "RGB")


def _refuse(fmt: str):
    def opener(data: bytes, name: str) -> Decoded:
        raise FormatNotRead(name, fmt)
    return opener


def _le(data: bytes, at: int, n: int = 4) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _be(data: bytes, at: int, n: int = 4) -> int:
    return int.from_bytes(data[at:at + n], "big")


def _gbr(data: bytes, name: str) -> Decoded:
    """GIMP brushes past ``GbrImageFile._open``'s checks are refused; the
    rest are left to the next format, as PIL leaves them."""
    version = _be(data, 4)
    if (len(data) < 20 or not (_be(data, 8) and _be(data, 12)) or _be(data, 16) not in (1, 4)
            or version == 2 and data[20:24] != b"GIMP"):
        raise NotThisFormat(f"{name}: not a GIMP brush")
    raise FormatNotRead(name, "GIMP brush (GBR)")


def _fli(data: bytes, name: str) -> Decoded:
    if not (data[20:22] == bytes(2) and data[42:80] == bytes(38) and data[88:128] == bytes(40)
            and len(data) >= 128):
        raise NotThisFormat(f"{name}: not an FLI/FLC file")
    raise FormatNotRead(name, "FLI/FLC animation")


def _imt(data: bytes, name: str) -> Decoded:
    """``ImtImageFile._open``: a header of ``width``, ``height`` and ``pixel
    n8`` lines is an IM Tools file, refused; anything else is left to the
    next format."""
    buffer, pos = data[:100], 100
    if b"\n" not in buffer:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    width = height = 0
    mode = None
    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + 1
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos += 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = field.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    raise FormatNotRead(name, "IM Tools (IMT)")


def _iptc(data: bytes, name: str) -> Decoded:
    """``IptcImageFile._open``: a first field that is not an IPTC tag is
    left to the next format; an IPTC/NAA file is refused."""
    if data[:1] == b"\x1c" and data[1:2] and data[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise FormatNotRead(name, "IPTC/NAA")
    raise NotThisFormat(f"{name}: not an IPTC/NAA file")


def _pixar(data: bytes, name: str) -> Decoded:
    """``PixarImageFile._open`` opens only channels/depth (14, 2) at a size."""
    if len(data) < 428 or (_le(data, 424, 2), _le(data, 426, 2)) != (14, 2) \
            or not (_le(data, 416, 2) and _le(data, 418, 2)):
        raise NotThisFormat(f"{name}: not a PIXAR file PIL opens")
    raise FormatNotRead(name, "PIXAR")


def _mcidas(data: bytes, name: str) -> Decoded:
    """``McIdasImageFile._open``: 1, 2 or 4 bytes an element, at a size."""
    if len(data) < 256 or _be(data, 40) not in (1, 2, 4) or _be(data, 32) <= 0 \
            or _be(data, 36) <= 0:
        raise NotThisFormat(f"{name}: not a McIdas area file PIL opens")
    raise FormatNotRead(name, "McIdas area")


def _wmf(data: bytes, name: str) -> Decoded:
    """``WmfStubImageFile._open``: a placeable WMF or an EMF header."""
    if not (data[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" and data[22:26] == b"\x01\x00\t\x00"
            or data[:4] == b"\x01\x00\x00\x00" and data[40:44] == b" EMF"):
        raise NotThisFormat(f"{name}: not a WMF/EMF file PIL opens")
    raise FormatNotRead(name, "WMF/EMF")


def _pcd(data: bytes, name: str) -> Decoded:
    if data[2048:2052] != b"PCD_":
        raise NotThisFormat(f"{name}: not a Kodak PhotoCD file")
    raise FormatNotRead(name, "Kodak PhotoCD (PCD)")


def _avif(data: bytes) -> bool:
    return data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


# Pillow 12.1.0's plugins in ``Image.ID``'s order: (name, accept test of the
# first 16 bytes or None for a plugin that tries every file, opener). An
# opener raising ``NotThisFormat`` hands the file to the next plugin, as
# PIL's ``_open`` raising SyntaxError does.
PLUGINS = (
    ("BMP", lambda d: d[:2] == b"BM", bmp.decode_bmp),
    ("DIB", bmp.dib_accept, bmp.decode_dib),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), gif_reader.decode_gif),
    ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff", _jpeg),
    ("PPM", lambda d: d[:1] == b"P" and d[1:2] != b"" and d[1] in b"0123456fy", pnm.decode_pnm),
    ("PNG", lambda d: d[:8] == b"\x89PNG\r\n\x1a\n", decode_png_pil),
    ("AVIF", _avif, _refuse("AVIF")),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), blp.decode_blp),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), _refuse("BUFR (a PIL stub)")),
    ("CUR", lambda d: d[:4] == b"\0\0\2\0", ico.decode_cur),
    ("PCX", pcx.accept, pcx.decode_pcx),
    ("DCX", lambda d: len(d) >= 4 and _le(d, 0) == pcx.DCX_MAGIC, pcx.decode_dcx),
    ("DDS", lambda d: d[:4] == b"DDS ", dds.decode_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or len(d) >= 4 and _le(d, 0) == 0xC6D3D0C5,
     _refuse("EPS")),
    ("FITS", lambda d: d[:6] == b"SIMPLE", _refuse("FITS")),
    ("FLI", lambda d: len(d) >= 16 and _le(d, 4, 2) in (0xAF11, 0xAF12)
     and _le(d, 14, 2) in (0, 3), _fli),
    ("FTEX", lambda d: d[:4] == b"FTEX", _refuse("FTEX (Freeware texture)")),
    ("GBR", lambda d: len(d) >= 8 and _be(d, 0) >= 20 and _be(d, 4) in (1, 2), _gbr),
    ("GRIB", lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1,
     _refuse("GRIB (a PIL stub)")),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", _refuse("HDF5 (a PIL stub)")),
    ("JPEG2000", jp2.accept, jp2.decode_jp2),
    ("ICNS", lambda d: d[:4] == b"icns", icns.decode_icns),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0", ico.decode_ico),
    ("IM", None, im.decode_im),
    ("IMT", None, _imt),
    ("IPTC", None, _iptc),
    ("MCIDAS", lambda d: d[:8] == b"\0\0\0\0\0\0\0\4", _mcidas),
    ("MPEG", lambda d: d[:4] == b"\0\0\1\xb3", _refuse("MPEG")),
    ("TIFF", lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"),
     tiff.decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), msp.decode_msp),
    ("PCD", None, _pcd),
    ("PIXAR", lambda d: d[:4] == b"\200\350\000\000", _pixar),
    ("PSD", lambda d: d[:4] == b"8BPS", psd.decode_psd),
    ("QOI", lambda d: d[:4] == b"qoif", qoi.decode_qoi),
    ("SGI", lambda d: len(d) >= 2 and _be(d, 0, 2) == 474, sgi.decode_sgi),
    ("SPIDER", None, spider.decode_spider),
    ("SUN", lambda d: len(d) >= 4 and _be(d, 0) == sun.MAGIC, sun.decode_sun),
    ("TGA", None, tga.decode_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", webp.decode_webp),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or d[:4] == b"\x01\x00\x00\x00",
     _wmf),
    ("XBM", xbm.accept, xbm.decode_xbm),
    ("XPM", lambda d: d[:9] == b"/* XPM */", _refuse("XPM")),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332", _refuse("XV thumbnail")),
)


def decode_image(data: bytes, name: str = "<bytes>") -> Decoded:
    """An image file's bytes -> PIL's array and mode (``utils.modes.Decoded``):
    the first plugin in PIL's order whose accept test passes and whose
    opener does not hand the file on. A format PIL reads and the port does
    not raises ``FormatNotRead`` (a ``ValueError`` naming the file and the
    format); a file no plugin takes, a ``ValueError`` as PIL's
    ``UnidentifiedImageError``."""
    prefix = data[:16]
    for fmt, accept, opener in PLUGINS:
        if accept is not None and not accept(prefix):
            continue
        try:
            return opener(data, name)
        except NotThisFormat:
            continue
        except ValueError as err:            # a refusal names the file
            if str(err).startswith(name):
                raise
            raise ValueError(f"{name}: {fmt}: {err}") from None
    raise ValueError(f"{name}: not an image file PIL identifies (no plugin of PIL's takes it)")


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
