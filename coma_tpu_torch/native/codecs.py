"""ctypes bindings of ``src/image_codecs.cpp``: the LZW, PackBits and TGA
run-length decoders of the image readers (``utils/gif_reader.py``,
``utils/tiff.py``, ``utils/tga.py``), built with ``g++`` at first use like
the other native sources. Each reader keeps its plain Python decoder as the
reference and falls back to it where :func:`available` is false."""
from __future__ import annotations

import ctypes

import numpy as np

from coma_tpu_torch import native

CODECS_SRC = native._SRC_DIR / "image_codecs.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.lzw_decode.restype = ctypes.c_int64
    lib.lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64]
    lib.packbits_decode.restype = ctypes.c_int64
    lib.packbits_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_int64]
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


def tga_rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, pixel_bytes: int) -> bytes:
    out = np.zeros(max(row_bytes * rows, 1), np.uint8)
    status = _need().tga_rle_decode(data, len(data), pos, row_bytes, rows, pixel_bytes,
                                    out.ctypes.data)
    if status == 1:
        raise ValueError("the run-length data ends before the image is full")
    if status == 2:
        raise ValueError("a run-length packet crosses the end of a row")
    return out[:row_bytes * rows].tobytes()
