"""PIL's ``Image.resize(size, Image.BILINEAR)`` of a uint8 image, in numpy.

The textured OBJ loader resizes ``map_Kd`` images with it, as
``coma_tpu/geometry/mesh.py`` does through PIL, which the card does not
have. Pillow's two-pass resampler (``libImaging/Resample.c``) is reproduced
step by step, so the result is PIL's to the bit:

- a triangle filter of support 1, widened by the scale when the image
  shrinks (so shrinking averages, antialiased), sampled at pixel centres;
- each output's weights normalised, then held in fixed point with 22
  fractional bits, rounded half away from zero;
- the horizontal pass first, rounded back to uint8, then the vertical pass.
"""
from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """(first input index (out,), fixed-point weights (out, taps)), one row
    per output sample; taps past an output's window weigh 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(0.0, 1.0 - np.abs((x + xmin - center + 0.5) / filterscale))
        total = w.sum()
        weights[xx, :xmax] = w / total if total != 0.0 else w
        first[xx] = xmin
    fixed = weights * (1 << _PRECISION_BITS)
    return first, np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)


def _resample(image: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    in_size = image.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    taps = weights.shape[1]
    index = np.minimum(first[:, None] + np.arange(taps), in_size - 1)   # (out, taps)
    x = np.moveaxis(image, axis, 0).astype(np.int64)
    gathered = x[index]                                                  # (out, taps, ...)
    w = weights.reshape(weights.shape + (1,) * (x.ndim - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + (gathered * w).sum(axis=1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(image: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W[, C]) -> (height, width[, C]) for ``size = (width,
    height)``, PIL's argument order."""
    width, height = size
    out = np.asarray(image, np.uint8)
    if width != out.shape[1]:
        out = _resample(out, 1, width)
    if height != out.shape[0]:
        out = _resample(out, 0, height)
    return out
