"""ctypes bindings of ``src/image_codecs.cpp``: the LZW, PackBits and TGA
run-length decoders of the image readers (``utils/gif_reader.py``,
``utils/tiff.py``, ``utils/psd.py``, ``utils/tga.py``), built with ``g++`` at first use like
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
                               ctypes.c_void_p, ctypes.c_int64]
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


def lzw_decode(data: bytes, min_code_size: int, tiff: bool, cap: int) -> bytes:
    """GIF (``tiff`` False) or TIFF LZW of ``data``, at most ``cap`` bytes."""
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().lzw_decode(data, len(data), min_code_size, int(tiff), out.ctypes.data, cap)
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


def _declare_bcn(lib: ctypes.CDLL) -> None:
    lib.bcn_decode.restype = None
    lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
