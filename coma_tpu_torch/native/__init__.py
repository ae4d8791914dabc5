"""Native (C++) host code, loaded with ctypes.

A copy of ``coma_tpu/native`` (``src/coma_native.cpp`` unchanged): Yuksel's
weighted sample elimination behind poisson-disk downsampling, and a
ray-parity point-in-mesh test. ``src/jpeg_decode.cpp`` is the JPEG decoder's
native half (``utils/jpeg.py`` loads it), ``src/image_codecs.cpp`` the LZW,
PackBits, run-length (TGA, SGI, PCX, ICNS, Sun, MSP) and QOI decoders of the
other image readers, ``src/bcn_decode.cpp`` the block decoders of DDS and
BLP, ``src/webp_decode.cpp`` WebP's, ``src/tiff_codecs.cpp`` TIFF's CCITT
and Zstandard, ``src/j2k_decode.cpp`` JPEG 2000's and ``src/av1_decode.cpp``
AVIF's AV1 decoder (``codecs.py`` loads them). This is host code, not a
device kernel.

Each source is compiled with ``g++`` at first use into
``coma_tpu_torch/_build/`` (ignored by git), named by a hash of the source
and the flags, written to a per-process temporary file and renamed into
place, so concurrent processes never load a half-written library. Each
entry point has a pure-Python fallback (``geometry/sampling.py``); where no
toolchain is present :func:`available` is false and the fallback runs.
The AV1 decoder has none: :func:`require_library` raises where it does not
build. Each source is one translation unit that includes no header of its
own, so the hash of its text names everything the build reads.
:func:`path_name` says which of the two a process uses.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent / "src"
_SRC = _SRC_DIR / "coma_native.cpp"
JPEG_DECODE_SRC = _SRC_DIR / "jpeg_decode.cpp"    # utils/jpeg.py loads it
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the flags of coma_tpu's build: the same arithmetic (contractions included)
# gives the same elimination order, hence the same indices
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}          # source path -> its loaded library, or None without a toolchain
_lock = threading.Lock()


def library_path(src: Path = _SRC) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_library(src: Path = _SRC) -> Path:
    """Compile ``src`` into ``BUILD_DIR`` unless its library is there; its
    path. Raises ``OSError`` or ``subprocess.SubprocessError`` without a
    working ``g++``."""
    out = library_path(src)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    return out


def load_library(src: Path, declare: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """``src`` built and loaded once per process, ``declare`` having set its
    functions' ``argtypes`` and ``restype``; None where it does not build or
    load (no toolchain), and then the caller's fallback runs."""
    with _lock:
        if src not in _libs:
            try:
                lib = ctypes.CDLL(str(build_library(src)))
            except (OSError, subprocess.SubprocessError):
                lib = None
            else:
                declare(lib)
            _libs[src] = lib
        return _libs[src]


class BuildError(RuntimeError):
    """A native source that has no plain fallback did not build or load."""


def require_library(src: Path, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """``src`` built and loaded once per process, for a reader with no plain
    fallback: where it does not build or load, ``BuildError`` names the
    source and gives the compiler's stderr."""
    lib = load_library(src, declare)
    if lib is not None:
        return lib
    try:
        ctypes.CDLL(str(build_library(src)))
        why = "it built but does not load"
    except subprocess.CalledProcessError as err:
        why = (err.stderr or b"").decode(errors="replace").strip() or f"g++ exited {err.returncode}"
    except (OSError, subprocess.SubprocessError) as err:
        why = str(err)
    raise BuildError(f"{src}: the native build failed: {why}")


def _declare(lib: ctypes.CDLL) -> None:
    lib.poisson_eliminate.restype = ctypes.c_int
    lib.poisson_eliminate.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.points_inside_mesh.restype = None
    lib.points_inside_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]


def _build_and_load() -> Optional[ctypes.CDLL]:
    return load_library(_SRC, _declare)


def available() -> bool:
    """Whether the native library builds and loads in this process."""
    return _build_and_load() is not None


def path_name() -> str:
    """Which elimination this process runs: the native library or the
    pure-Python fallback."""
    return "native C++ (g++)" if available() else "pure Python fallback"


def poisson_eliminate(points: np.ndarray, n_target: int, total_area: float) -> np.ndarray:
    """Native weighted sample elimination; returns kept indices.

    Semantics match ``coma_tpu_torch.geometry.sampling.poisson_disk_eliminate``.
    """
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3 or not 0 < n_target <= len(pts):
        raise ValueError(f"points {pts.shape}, n_target {n_target}")
    keep = np.zeros(len(pts), dtype=np.uint8)
    n = lib.poisson_eliminate(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(pts), int(n_target), float(total_area),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n != n_target:
        raise RuntimeError(f"native elimination kept {n}, wanted {n_target}")
    return np.flatnonzero(keep)


def points_inside_mesh(points: np.ndarray, verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Native ray-parity inside test; returns (P,) bool."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if pts.ndim != 2 or pts.shape[1] != 3 or v.ndim != 2 or v.shape[1] != 3 \
            or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"points {pts.shape}, verts {v.shape}, faces {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face index out of range")
    out = np.zeros(len(pts), dtype=np.uint8)
    lib.points_inside_mesh(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)
