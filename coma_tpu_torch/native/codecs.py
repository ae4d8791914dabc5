"""ctypes bindings of ``src/image_codecs.cpp``: the LZW, PackBits, run-length
and QOI decoders of the image readers (``utils/gif_reader.py``,
``utils/tiff.py``, ``utils/psd.py``, ``utils/tga.py``, ``utils/{sgi,pcx,
icns,sun,msp,qoi}.py``), of ``src/bcn_decode.cpp`` (DDS's and BLP's
blocks), of ``src/webp_decode.cpp`` and of ``src/tiff_codecs.cpp`` (TIFF's
CCITT and Zstandard strips), built with ``g++`` at first use like
the other native sources. Each reader keeps its plain Python decoder as the
reference and falls back to it where :func:`available` is false."""
from __future__ import annotations

import ctypes

import numpy as np

from coma_tpu_torch import native

CODECS_SRC = native._SRC_DIR / "image_codecs.cpp"
BCN_SRC = native._SRC_DIR / "bcn_decode.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.lzw_decode.restype = ctypes.c_int64
    lib.lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.packbits_decode.restype = ctypes.c_int64
    lib.packbits_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.packbits_rows_decode.restype = ctypes.c_int
    lib.packbits_rows_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.tga_rle_decode.restype = ctypes.c_int
    lib.tga_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_void_p]
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for fn, args, res in (
            ("qoi_decode", [ctypes.c_char_p, i64, i64, i64, ctypes.c_int, ptr], ctypes.c_int),
            ("sgi_rle_decode", [ctypes.c_char_p, i64, i64, i64, ctypes.c_int, ctypes.c_int, ptr],
             ctypes.c_int),
            ("pcx_rle_decode", [ctypes.c_char_p, i64, i64, i64, i64, i64, i64, i64, ptr],
             ctypes.c_int),
            ("icns_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr], ctypes.c_int),
            ("sun_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr], ctypes.c_int),
            ("msp_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr, i64], i64)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res


def _lib():
    return native.load_library(CODECS_SRC, _declare)


def available() -> bool:
    """Whether the codecs library builds and loads in this process."""
    return _lib() is not None


def _need():
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native image codecs are not available (no g++)")
    return lib


def lzw_decode(data: bytes, min_code_size: int, tiff: bool, cap: int, end_from: int = 0) -> bytes:
    """GIF (``tiff`` False) or TIFF LZW of ``data``, at most ``cap`` bytes;
    an end code ending before byte ``end_from`` is passed over."""
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().lzw_decode(data, len(data), min_code_size, int(tiff), out.ctypes.data, cap,
                           end_from)
    if n < 0:
        raise ValueError("an LZW code that is not in the table (corrupt data)")
    return out[:n].tobytes()


def packbits_decode(data: bytes, cap: int) -> bytes:
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().packbits_decode(data, len(data), out.ctypes.data, cap)
    return out[:n].tobytes()


def packbits_rows_decode(data: bytes, pos: int, row: int, rows: int) -> bytes:
    """PackBits from ``data[pos:]`` as PIL decodes a Photoshop channel:
    ``rows`` rows of ``row`` bytes, packets cut at each row's end."""
    out = np.zeros(max(row * rows, 1), np.uint8)
    if _need().packbits_rows_decode(data, len(data), pos, row, rows, out.ctypes.data):
        raise ValueError("image file is truncated")
    return out[:row * rows].tobytes()


def tga_rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, pixel_bytes: int) -> bytes:
    out = np.zeros(max(row_bytes * rows, 1), np.uint8)
    status = _need().tga_rle_decode(data, len(data), pos, row_bytes, rows, pixel_bytes,
                                    out.ctypes.data)
    if status == 1:
        raise ValueError("the run-length data ends before the image is full")
    if status == 2:
        raise ValueError("a run-length packet crosses the end of a row")
    return out[:row_bytes * rows].tobytes()


def qoi_decode(data: bytes, pos: int, pixels: int, channels: int) -> bytes:
    out = np.zeros(max(pixels * channels, 1), np.uint8)
    if _need().qoi_decode(data, len(data), pos, pixels, channels, out.ctypes.data):
        raise ValueError("the QOI data ends before the image is full")
    return out[:pixels * channels].tobytes()


def sgi_rle_decode(data: bytes, width: int, height: int, bands: int, bpc: int) -> bytes:
    out = np.zeros(max(width * height * bands * bpc, 1), np.uint8)
    if _need().sgi_rle_decode(data, len(data), width, height, bands, bpc, out.ctypes.data):
        raise ValueError("an RLE table, row or packet runs past the file or its row")
    return out[:width * height * bands * bpc].tobytes()


def pcx_rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, bands: int, size: int,
                   stride: int) -> bytes:
    out = np.zeros(max(row_bytes * rows, 1), np.uint8)
    status = _need().pcx_rle_decode(data, len(data), pos, row_bytes, rows, bands, size, stride,
                                    out.ctypes.data)
    if status == 1:
        raise ValueError("image file is truncated")
    if status == 2:
        raise ValueError("a run passes the end of a row (buffer overrun)")
    return out[:row_bytes * rows].tobytes()


def icns_rle_decode(data: bytes, pos: int, pixels: int) -> bytes:
    out = np.zeros(max(3 * pixels, 1), np.uint8)
    status = _need().icns_rle_decode(data, len(data), pos, pixels, out.ctypes.data)
    if status == 1:
        raise ValueError("error reading channel (it does not end at the image's size)")
    if status == 2:
        raise ValueError("not enough image data")
    return out[:3 * pixels].tobytes()


def sun_rle_decode(data: bytes, pos: int, want: int) -> bytes:
    out = np.zeros(max(want, 1), np.uint8)
    if _need().sun_rle_decode(data, len(data), pos, want, out.ctypes.data):
        raise ValueError("image file is truncated")
    return out[:want].tobytes()


def msp_rle_decode(data: bytes, width: int, height: int) -> bytes:
    """The joined rows, at most ``(width + 7) // 8 * height`` bytes of them
    (the raw decoder reads no more)."""
    cap = (width + 7) // 8 * height
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().msp_rle_decode(data, len(data), width, height, out.ctypes.data, cap)
    if n == -1:
        raise ValueError("truncated MSP file (row map or row)")
    if n == -2:
        raise ValueError("corrupted MSP file (a run cut short)")
    return out[:min(n, cap)].tobytes()


def _declare_bcn(lib: ctypes.CDLL) -> None:
    lib.bcn_decode.restype = None
    lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    lib.blp_dxt_decode.restype = None
    lib.blp_dxt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]


def bcn_available() -> bool:
    """Whether ``src/bcn_decode.cpp`` builds and loads in this process."""
    return native.load_library(BCN_SRC, _declare_bcn) is not None


def bcn_decode(data: bytes, n: int, sign: bool, width: int, height: int) -> np.ndarray:
    """Pillow's ``bcn`` decoder ``n`` (1-7) over every block in ``data``:
    (H, W, 4) RGBA, or (H, W) for BC4."""
    lib = native.load_library(BCN_SRC, _declare_bcn)
    if lib is None:
        raise RuntimeError("the native BCn decoder is not available (no g++)")
    out = np.zeros((height, width, 1 if n == 4 else 4), np.uint8)
    lib.bcn_decode(data, n, int(sign), width, height, out.ctypes.data)
    return out[..., 0] if n == 4 else out


def blp_dxt_decode(data: bytes, fmt: str, width: int, height: int, alpha: bool) -> bytes:
    """BLP2's DXT1/3/5 blocks as ``BlpImagePlugin`` decodes them (see
    ``utils/blp.dxt_decode_python``)."""
    lib = native.load_library(BCN_SRC, _declare_bcn)
    if lib is None:
        raise RuntimeError("the native BCn decoder is not available (no g++)")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    bands = 3 if fmt == "DXT1" and not alpha else 4
    out = np.zeros(bh * 4 * bw * 4 * bands, np.uint8)
    lib.blp_dxt_decode(data, int(fmt[-1]), int(alpha), width, height, out.ctypes.data)
    return out.tobytes()


WEBP_SRC = native._SRC_DIR / "webp_decode.cpp"


def _declare_webp(lib: ctypes.CDLL) -> None:
    lib.webp_decode_image.restype = ctypes.c_int
    lib.webp_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]


def webp_available() -> bool:
    """Whether ``src/webp_decode.cpp`` builds and loads in this process."""
    return native.load_library(WEBP_SRC, _declare_webp) is not None


def webp_decode_image(payload: bytes, lossless: bool, alph, width: int,
                      height: int) -> np.ndarray:
    """One WebP image chunk's payload (``VP8L`` when ``lossless``, else
    ``VP8 `` with the ``ALPH`` payload ``alph`` or None) -> (H, W, 4) RGBA."""
    lib = native.load_library(WEBP_SRC, _declare_webp)
    if lib is None:
        raise RuntimeError("the native WebP decoder is not available (no g++)")
    out = np.zeros((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.webp_decode_image(payload, len(payload), int(lossless), alph or b"",
                             -1 if alph is None else len(alph), width, height, out.ctypes.data,
                             err, len(err)):
        raise ValueError(err.value.decode())
    return out


TIFF_SRC = native._SRC_DIR / "tiff_codecs.cpp"


def _declare_tiff(lib: ctypes.CDLL) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.fax_decode.restype = ctypes.c_int
    lib.fax_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               i64, i64, i64, ptr, ptr, i64, ctypes.POINTER(ctypes.c_int)]
    lib.zstd_decode.restype = ctypes.c_int
    lib.zstd_decode.argtypes = [ctypes.c_char_p, i64, i64, ptr, ctypes.c_char_p, i64]


def _tiff_lib():
    lib = native.load_library(TIFF_SRC, _declare_tiff)
    if lib is None:
        raise RuntimeError("the native TIFF codecs are not available (no g++)")
    return lib


def tiff_available() -> bool:
    """Whether ``src/tiff_codecs.cpp`` builds and loads in this process."""
    return native.load_library(TIFF_SRC, _declare_tiff) is not None


_FAX_ERRORS = {1: "premature end of CCITT data (libtiff fails the strip)",
               2: "CCITT Group 4 data ends before its first row (libtiff fails the strip)",
               3: "a run array overflow (libtiff fails the strip)"}


def fax_decode(data: bytes, parity: int, compression: int, width: int, rows: int,
               buf: np.ndarray, carry) -> None:
    """libtiff's CCITT decoder of one strip into ``buf`` ((rows, row bytes)
    uint8, C-contiguous), ``carry`` (``utils.tiff_codecs.FaxCarry``) the
    codec's state from strip to strip: ``utils/tiff_codecs.fax_decode_python``."""
    mode = ctypes.c_int(int(carry.no_eol))
    try:
        status = _tiff_lib().fax_decode(data, len(data), parity, compression, int(carry.two_d),
                                        width, rows, buf.shape[1], buf.ctypes.data,
                                        carry.runs.ctypes.data, carry.runs.shape[1] - 1,
                                        ctypes.byref(mode))
    finally:
        carry.no_eol = bool(mode.value)
    if status:
        raise ValueError(_FAX_ERRORS[status])


def zstd_decode(data: bytes, cap: int) -> bytes:
    """One Zstandard TIFF strip of ``cap`` bytes:
    ``utils/tiff_codecs.zstd_decode_python``."""
    out = np.zeros(max(cap, 1), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _tiff_lib().zstd_decode(data, len(data), cap, out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return out[:cap].tobytes()
