"""Native (C++) host code for the offline prep stages, loaded with ctypes.

A copy of ``coma_tpu/native`` (``src/coma_native.cpp`` unchanged): Yuksel's
weighted sample elimination behind poisson-disk downsampling, and a
ray-parity point-in-mesh test. This is host code, not a device kernel.

The source is compiled with ``g++`` at first use into
``coma_tpu_torch/_build/`` (ignored by git), named by a hash of the source
and the flags, written to a per-process temporary file and renamed into
place, so concurrent processes never load a half-written library. Each
entry point has a pure-Python fallback (``geometry/sampling.py``); where no
toolchain is present :func:`available` is false and the fallback runs.
:func:`path_name` says which of the two a process uses.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "coma_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the flags of coma_tpu's build: the same arithmetic (contractions included)
# gives the same elimination order, hence the same indices
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcoma_native-{digest}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    return out


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            return None   # no toolchain or no loadable library: the fallback runs
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
        _lib = lib
        return _lib


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
