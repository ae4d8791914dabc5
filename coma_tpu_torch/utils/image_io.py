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
  old-style JPEG; CIELab too; strips or tiles at any bit depth it reads),
  PBM/PGM/PPM and Pillow's PFM, P0 and Py magics (``utils/pnm.py``), TGA
  (``utils/tga.py``);
- SGI (``utils/sgi.py``), PCX and DCX (``utils/pcx.py``), ICO and CUR
  (``utils/ico.py``), QOI (``utils/qoi.py``), XBM (``utils/xbm.py``), IM
  (``utils/im.py``), ICNS (``utils/icns.py``, PNG and JPEG 2000 members),
  BLP (``utils/blp.py``), Sun raster (``utils/sun.py``), MSP
  (``utils/msp.py``) and SPIDER (``utils/spider.py``);
- FITS (``utils/fits.py``, PIL's little-endian reading of its samples and
  its GZIP_1 tables), FLI/FLC (``utils/fli.py``, the first frame), FTEX
  (``utils/ftex.py``), GIMP brushes (``utils/gbr.py``), IM Tools
  (``utils/imt.py``), IPTC/NAA (``utils/iptc.py``, raw or JPEG), McIdas
  areas (``utils/mcidas.py``), Kodak PhotoCD (``utils/pcd.py``, the base
  image), PIXAR (``utils/pixar.py``), XPM (``utils/xpm.py``) and XV
  thumbnails (``utils/xvthumb.py``);
- AVIF whose AV1 frames are coded-lossless, or lossy as Pillow writes
  them at any speed, with the deblocking filter, CDEF and Wiener,
  self-guided and switchable loop restoration, screen content tools,
  quantizer matrices and film grain
  (``utils/avif.py`` over ``utils/heif.py``, the AV1 decoder in
  ``native/src/av1_decode.cpp``): every sampling, full and limited range,
  RGBA (premultiplied alpha and limited-range alpha items too), tiles,
  128 x 128 superblocks, the BT.601, BT.709, BT.2020 and identity matrices.

Refused with ``utils.modes.FormatNotRead``, a ``ValueError`` naming the file
and the format, though PIL reads them: HTJ2K code-blocks, and AVIF outside
those slices (delta lf, segment loop filter levels, superres, high bit
depth, grids, ``avis`` sequences), the detail naming what is not read. The
formats Pillow 12.1.0 opens here but cannot load (the BUFR, GRIB and HDF5
stubs and WMF/EMF, which have no loader; EPS, without Ghostscript; MPEG,
of which it reads the header only) and whatever else PIL itself refuses
raise a plain ``ValueError`` naming the file. The card machine has no PIL.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from coma_tpu_torch.utils import (avif, blp, bmp, dds, fits, fli, ftex, gbr, gif_reader, icns, ico, im,
                                  imt, iptc, jp2, jpeg, mcidas, msp, pcd, pcx, pixar, pnm, psd,
                                  qoi, sgi, spider, sun, tga, tiff, webp, xbm, xpm, xvthumb)
from coma_tpu_torch.utils.modes import Decoded, NotThisFormat, to_mode
from coma_tpu_torch.utils.png import decode_png_pil


def _jpeg(data: bytes, name: str) -> Decoded:
    pixels = jpeg.decode_jpeg(data, name)
    if pixels.shape[-1] == 1:
        return Decoded(pixels[..., 0], "L")
    return Decoded(pixels, "CMYK" if pixels.shape[-1] == 4 else "RGB")


def _pillow_refuses(fmt: str, why: str):
    """A format Pillow 12.1.0 opens here and then refuses to load: a plain
    ``ValueError`` naming the file, as PIL's own refusals."""
    def opener(data: bytes, name: str) -> Decoded:
        raise ValueError(f"{name}: {fmt}: {why} (Pillow refuses it too)")
    return opener


_NO_LOADER = "Pillow has only a stub of this format and no loader for it"


def _le(data: bytes, at: int, n: int = 4) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _be(data: bytes, at: int, n: int = 4) -> int:
    return int.from_bytes(data[at:at + n], "big")


def _mpeg(data: bytes, name: str) -> Decoded:
    """``MpegImageFile._open``: a sequence header of a size is opened (and
    not loaded); a short or empty one is left to the next format."""
    if len(data) < 7 or not (_be(data, 4, 3) >> 12 and _be(data, 4, 3) & 0xFFF):
        raise NotThisFormat(f"{name}: not an MPEG file PIL opens")
    raise ValueError(f"{name}: MPEG: cannot load this image (Pillow opens MPEG's header only; "
                     "Pillow refuses it too)")


def _wmf(data: bytes, name: str) -> Decoded:
    """``WmfStubImageFile._open``: a placeable WMF or an EMF header is opened,
    and PIL has no loader for it here."""
    if not (data[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" and data[22:26] == b"\x01\x00\t\x00"
            or data[:4] == b"\x01\x00\x00\x00" and data[40:44] == b" EMF"):
        raise NotThisFormat(f"{name}: not a WMF/EMF file PIL opens")
    raise ValueError(f"{name}: WMF/EMF: cannot find loader for this WMF file (Pillow refuses it "
                     "too)")


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
    ("AVIF", _avif, avif.decode_avif),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), blp.decode_blp),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), _pillow_refuses("BUFR", _NO_LOADER)),
    ("CUR", lambda d: d[:4] == b"\0\0\2\0", ico.decode_cur),
    ("PCX", pcx.accept, pcx.decode_pcx),
    ("DCX", lambda d: len(d) >= 4 and _le(d, 0) == pcx.DCX_MAGIC, pcx.decode_dcx),
    ("DDS", lambda d: d[:4] == b"DDS ", dds.decode_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or len(d) >= 4 and _le(d, 0) == 0xC6D3D0C5,
     _pillow_refuses("EPS", "Pillow renders EPS through Ghostscript, which is not installed")),
    ("FITS", lambda d: d[:6] == b"SIMPLE", fits.decode_fits),
    ("FLI", lambda d: len(d) >= 16 and _le(d, 4, 2) in (0xAF11, 0xAF12)
     and _le(d, 14, 2) in (0, 3), fli.decode_fli),
    ("FTEX", lambda d: d[:4] == b"FTEX", ftex.decode_ftex),
    ("GBR", lambda d: len(d) >= 8 and _be(d, 0) >= 20 and _be(d, 4) in (1, 2), gbr.decode_gbr),
    ("GRIB", lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1,
     _pillow_refuses("GRIB", _NO_LOADER)),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", _pillow_refuses("HDF5", _NO_LOADER)),
    ("JPEG2000", jp2.accept, jp2.decode_jp2),
    ("ICNS", lambda d: d[:4] == b"icns", icns.decode_icns),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0", ico.decode_ico),
    ("IM", None, im.decode_im),
    ("IMT", None, imt.decode_imt),
    ("IPTC", None, iptc.decode_iptc),
    ("MCIDAS", lambda d: d[:8] == mcidas.MAGIC, mcidas.decode_mcidas),
    ("MPEG", lambda d: d[:4] == b"\0\0\1\xb3", _mpeg),
    ("TIFF", lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"),
     tiff.decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), msp.decode_msp),
    ("PCD", None, pcd.decode_pcd),
    ("PIXAR", lambda d: d[:4] == pixar.MAGIC, pixar.decode_pixar),
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
    ("XPM", lambda d: d[:9] == b"/* XPM */", xpm.decode_xpm),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332", xvthumb.decode_xvthumb),
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
