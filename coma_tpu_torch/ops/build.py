"""Build the CUDA sources under ``coma_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries go to
``coma_tpu_torch/_build/`` (ignored by git), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is not.
A missing ``nvcc`` or a failed build raises: there is no fallback.

:func:`build_all` starts one ``nvcc`` per source at once and waits for all;
:func:`load` builds one source on demand. :func:`check_tensor` and
:func:`check` are the wrappers' checks before and after a launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("contact_splat", "occupancy_hits", "flash_attention", "flash_attention_sm90")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch finds (``$CUDA_HOME``,
    ``$CUDA_PATH``, ``nvcc`` on ``PATH``, then the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of coma_tpu_torch are built from source at first use"
        )
    return nvcc


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``."""
    return BUILD_DIR / f"{name}.log"


def _start(name: str):
    """Start nvcc for ``name``; ``None`` if the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    # per process, renamed into place as the library is: two processes that
    # build at once never interleave one log
    tmp_log = log_path(name).with_suffix(f".{os.getpid()}.log")
    log = open(tmp_log, "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp_log, tmp, out, cmd


def _finish(name: str, started) -> None:
    proc, log, tmp_log, tmp, out, cmd = started
    try:
        rc = proc.wait()
    finally:
        log.close()
        tail = tmp_log.read_text()[-4000:]
        os.replace(tmp_log, log_path(name))   # the last build's log, failed or not
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({rc}) building {name}: {' '.join(cmd)}\n{tail}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Build every named source, all ``nvcc`` processes at once."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.coma_cuda_error_string.restype = ctypes.c_char_p
                lib.coma_cuda_error_string.argtypes = [ctypes.c_int]
                _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.coma_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(name: str, t, device, shape) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the state on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
