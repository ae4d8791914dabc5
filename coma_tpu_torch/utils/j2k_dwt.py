"""JPEG 2000 reconstruction as OpenJPEG 2.5.4 does it: the inverse wavelet
transforms, the inverse component transforms and the DC level shift.

- The 5/3 integer inverse DWT (``opj_idwt53_h``/``_v``): each level's rows,
  then its columns, lifted in place with whole-sample symmetric extension;
  ``cas``, the parity of the level's first coordinate, says whether the
  first sample is low- or high-pass; a lone high-pass sample is halved with
  C's truncating division, a lone low-pass one kept.
- The 9/7 float32 lifting of ``opj_v8dwt_decode``: low samples times K
  (1.230174105), high samples times ``two_invK`` (1.625732422, which
  OpenJPEG's step sizes make up for), then the delta, gamma, beta and alpha
  steps, each ``x + (left + right) * c`` in float32 with no fused multiply;
  a row or column of one sample is left as it is.
- The RCT (``opj_mct_decode``) and the float32 ICT (``opj_mct_decode_real``).
- ``opj_tcd_dc_level_shift_decode``: the reversible path adds the level
  shift and clamps to the component's range; the irreversible one rounds
  with ``lrintf`` (half to even) first.

The plain numpy versions here are the references of
``native/src/j2k_decode.cpp``.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
K = F32(1.230174105)
TWO_INV_K = F32(1.625732422)
ALPHA, BETA = F32(-1.586134342), F32(-0.052980118)
GAMMA, DELTA = F32(0.882911075), F32(0.443506852)


def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """(rows, n) with the sn low-pass samples first -> samples in place:
    low-pass at the even positions (cas 0) or the odd ones (cas 1)."""
    out = np.empty_like(a)
    out[:, cas::2] = a[:, :sn]
    out[:, 1 - cas::2] = a[:, sn:]
    return out


def _neighbours(x: np.ndarray, pos: np.ndarray):
    """The left and right neighbours of positions ``pos`` of the rows of
    ``x``, mirrored at the ends (x[-1] = x[1], x[n] = x[n - 2])."""
    n = x.shape[1]
    left = np.abs(pos - 1)
    right = np.where(pos + 1 < n, pos + 1, 2 * (n - 1) - (pos + 1))
    return x[:, left], x[:, right]


def idwt53_1d(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """One level of the 5/3 inverse along the last axis of (rows, n) int32."""
    n = a.shape[1]
    if n == 1:
        if cas:
            return (np.trunc(a / 2)).astype(np.int32) if a.size else a
        return a
    x = _interleave(a.astype(np.int64), sn, cas)
    low = np.arange(cas, n, 2)
    high = np.arange(1 - cas, n, 2)
    left, right = _neighbours(x, low)
    x[:, low] -= (left + right + 2) >> 2
    left, right = _neighbours(x, high)
    x[:, high] += (left + right) >> 1
    return x.astype(np.int32)


def idwt97_1d(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """One level of the 9/7 inverse along the last axis of (rows, n) float32."""
    n = a.shape[1]
    if n == 1:
        return a
    x = _interleave(a.astype(F32), sn, cas)
    low = np.arange(cas, n, 2)
    high = np.arange(1 - cas, n, 2)
    x[:, low] *= K
    x[:, high] *= TWO_INV_K
    for pos, c in ((low, -DELTA), (high, -GAMMA), (low, -BETA), (high, -ALPHA)):
        left, right = _neighbours(x, pos)
        x[:, pos] = x[:, pos] + (left + right) * c
    return x


def idwt2d(data: np.ndarray, resolutions, reversible: bool) -> np.ndarray:
    """``opj_dwt_decode_tile``: ``data`` (H, W) holds the lowest resolution
    top-left and each level's three bands beside it; ``resolutions`` lists
    each resolution's (x0, y0, x1, y1), lowest first. Returns the
    reconstructed full resolution (int32 or float32)."""
    out = data.copy()
    step = idwt53_1d if reversible else idwt97_1d
    x0, y0, x1, y1 = resolutions[0]
    rw, rh = x1 - x0, y1 - y0
    for x0, y0, x1, y1 in resolutions[1:]:
        sn, sv = rw, rh
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            out[:rh, :rw] = step(out[:rh, :rw], sn, x0 % 2)
            out[:rh, :rw] = step(out[:rh, :rw].T.copy(), sv, y0 % 2).T
    return out


def rct_inverse(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray):
    """``opj_mct_decode`` on int32 planes -> (r, g, b)."""
    g = c0 - ((c1 + c2) >> 2)
    return c2 + g, g, c1 + g


def ict_inverse(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray):
    """``opj_mct_decode_real`` on float32 planes -> (r, g, b)."""
    y, u, v = c0.astype(F32), c1.astype(F32), c2.astype(F32)
    r = y + v * F32(1.402)
    g = (y - u * F32(0.34413)) - v * F32(0.71414)
    b = y + u * F32(1.772)
    return r, g, b


def level_shift(plane: np.ndarray, prec: int, sgnd: bool, reversible: bool) -> np.ndarray:
    """``opj_tcd_dc_level_shift_decode`` -> int32."""
    shift = 0 if sgnd else 1 << (prec - 1)
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    if reversible:
        v = plane.astype(np.int64) + shift
    else:
        f = plane.astype(F32)
        with np.errstate(invalid="ignore"):
            # lrintf of NaN is the most negative integer, clamped to the minimum
            v = np.where(f > F32(2 ** 31), hi, np.where(
                (f < F32(-2 ** 31)) | np.isnan(f), lo,
                np.rint(np.nan_to_num(f)).astype(np.int64) + shift))
    return np.clip(v, lo, hi).astype(np.int32)
