"""Little CMS 2.17's Lab -> sRGB transform, as Pillow 12.1.0's ``convert``
builds it for a "LAB" image.

Pillow's ``Image.convert("RGB")`` of a "LAB" image builds
``ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
"LAB", "RGB")``: ``cmsCreateLab2Profile(NULL)`` (D50, an abstract profile
used as a device link) to ``cmsCreate_sRGBProfile()``, 8-bit Lab to 8-bit
RGB, perceptual intent, no flags. Little CMS does not evaluate that
pipeline pixel by pixel. It optimises an 8-bit transform by resampling the
pipeline into a 33 x 33 x 33 CLUT of 16-bit nodes and evaluates the CLUT
with its tetrahedral 16-bit interpolation. So does :func:`lab_to_rgb`:

- the pipeline left after ``PreOptimize`` (the Lab profile's identity CLUT
  and its V4/V2 pair removed): ``EvaluateLab2XYZ`` (V4 rules, D50, scaled
  by 1 / 1.99997), the sRGB profile's inverse colorant matrix (scaled by
  1.99997) with a float64 accumulator, and the inverse of the sRGB
  parametric curve (type -4), each stage stored as float32;
- each node's input is ``_cmsQuantizeVal`` and its output
  ``_cmsQuickSaturateWord(v * 65535)``, with Little CMS's fast floor (the
  value rounded to a 2^-16 step first);
- a pixel's bytes are widened as ``x * 257`` (``UnrollChunkyBytes``) with a
  and b held as PIL's "LAB" memory holds them (the array's byte ^ 128),
  interpolated by ``TetrahedralInterp16`` and narrowed by
  ``FROM_16_TO_8``.

All 2^24 inputs give Pillow's bytes (``tests/test_torch_lab.py``).
:func:`lab_to_rgb` takes the C++ twin of the interpolation
(``native/src/image_codecs.cpp``, ``lab_tetra_interp``) where it builds, else
:func:`tetra_interp_python`, its reference.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

GRID = 33
# the colorants of Little CMS's built-in sRGB profile (D65 primaries adapted
# to D50 by Bradford), as ``cmsReadTag`` gives them: rXYZ, gXYZ, bXYZ
_COLORANTS = (
    (float.fromhex("0x1.be81990d9764dp-2"), float.fromhex("0x1.c7a5f98135a95p-3"),
     float.fromhex("0x1.c822fef8ccacbp-7")),
    (float.fromhex("0x1.8a5b09f494ef4p-2"), float.fromhex("0x1.6f0e2eb5eb556p-1"),
     float.fromhex("0x1.8d96607b798afp-4")),
    (float.fromhex("0x1.24f53752144c5p-3"), float.fromhex("0x1.f0852e9c740a1p-5"),
     float.fromhex("0x1.6d85f2e99e747p-1")),
)
_D50 = (0.9642, 1.0, 0.8249)
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
# the sRGB curve's parameters (g, a, b, c, d)
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _quick_saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: d + 0.5 floored by the 16.16 magic-number
    floor (so rounded to a 2^-16 step first), saturated to 0..65535."""
    d = np.asarray(d, np.float64) + 0.5
    floor = np.floor(np.rint(d * 65536.0) / 65536.0)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


def _inverse(a: np.ndarray) -> np.ndarray:
    """``_cmsMAT3inverse``, in its order of operations."""
    c0 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
    c1 = -a[1, 0] * a[2, 2] + a[1, 2] * a[2, 0]
    c2 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
    det = a[0, 0] * c0 + a[0, 1] * c1 + a[0, 2] * c2
    return np.array([
        [c0 / det, (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) / det,
         (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) / det],
        [c1 / det, (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) / det,
         (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) / det],
        [c2 / det, (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) / det,
         (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) / det]])


def _f_1(t: np.ndarray) -> np.ndarray:
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)


def pipeline(lab16: np.ndarray) -> np.ndarray:
    """(..., 3) 16-bit Lab (V4 encoding) -> (..., 3) 16-bit sRGB:
    ``cmsPipelineEval16`` of the pipeline Little CMS resamples."""
    f = lab16.astype(np.float32) / np.float32(65535.0)
    lab_l = f[..., 0].astype(np.float64) * 100.0
    lab_a = f[..., 1].astype(np.float64) * 255.0 - 128.0
    lab_b = f[..., 2].astype(np.float64) * 255.0 - 128.0
    y = (lab_l + 16.0) / 116.0
    x = y + 0.002 * lab_a
    z = y - 0.005 * lab_b
    xyz = [(_f_1(t) * w / _MAX_ENCODEABLE_XYZ).astype(np.float32)
           for t, w in zip((x, y, z), _D50)]
    matrix = _inverse(np.array(_COLORANTS).T) * _MAX_ENCODEABLE_XYZ
    g, a, b, c, d = _SRGB
    disc = (a * d + b) ** g
    out = []
    for i in range(3):
        acc = np.zeros(lab16.shape[:-1])
        for j in range(3):
            acc = acc + xyz[j].astype(np.float64) * matrix[i, j]
        r = acc.astype(np.float32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            v = np.where(r >= disc, (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a, r / c)
        out.append(_quick_saturate_word(v.astype(np.float32).astype(np.float64) * 65535.0))
    return np.stack(out, -1)


@lru_cache(maxsize=1)
def clut() -> np.ndarray:
    """(33 * 33 * 33 * 3,) int32: the 16-bit CLUT Little CMS samples, L
    slowest, b fastest, the three outputs of a node together."""
    nodes = _quick_saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1))
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1)
    return np.ascontiguousarray(pipeline(grid).reshape(-1), np.int32)


def tetra_interp_python(inputs: np.ndarray, table: np.ndarray, grid: int = GRID) -> np.ndarray:
    """(N, 3) 16-bit inputs -> (N, 3) 16-bit outputs: ``TetrahedralInterp16``
    on a (grid^3, 3) table. The reference of ``native/codecs.lab_tetra_interp``."""
    inputs = inputs.astype(np.int64)
    opta = (3, 3 * grid, 3 * grid * grid)        # b, a, L strides
    fixed = inputs * (grid - 1)
    fixed = fixed + (fixed + 0x7FFF) // 0xFFFF   # _cmsToFixedDomain
    node, rest = fixed >> 16, fixed & 0xFFFF
    base = node[:, 0] * opta[2] + node[:, 1] * opta[1] + node[:, 2] * opta[0]
    step = [np.where(inputs[:, k] == 0xFFFF, 0, opta[2 - k]) for k in range(3)]
    rx, ry, rz = rest[:, 0], rest[:, 1], rest[:, 2]
    # the six tetrahedra of lcms's branches, each as its order of axes
    cases = ((rx >= ry) & (ry >= rz), (0, 1, 2)), \
        ((rx >= ry) & (ry < rz) & (rz >= rx), (2, 0, 1)), \
        ((rx >= ry) & (ry < rz) & (rz < rx), (0, 2, 1)), \
        ((rx < ry) & (rx >= rz), (1, 0, 2)), \
        ((rx < ry) & (rx < rz) & (ry >= rz), (1, 2, 0)), \
        ((rx < ry) & (rx < rz) & (ry < rz), (2, 1, 0))
    table = table.astype(np.int64)
    out = np.zeros(inputs.shape, np.int64)
    for mask, order in cases:
        idx = np.flatnonzero(mask)
        b = base[idx]
        p1 = b + step[order[0]][idx]
        p2 = p1 + step[order[1]][idx]
        p3 = p2 + step[order[2]][idx]
        r = [rest[idx, k] for k in order]
        for ch in range(3):
            c0, c1, c2, c3 = table[b + ch], table[p1 + ch], table[p2 + ch], table[p3 + ch]
            total = (c1 - c0) * r[0] + (c2 - c1) * r[1] + (c3 - c2) * r[2] + 0x8001
            out[idx, ch] = (c0 + ((total + (total >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray, native=None) -> np.ndarray:
    """(..., 3) uint8, PIL's "LAB" array -> (..., 3) uint8, its
    ``convert("RGB")``. ``native`` None takes the C++ interpolation where it
    builds; True or False force one."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    flat = np.ascontiguousarray(lab, np.uint8).reshape(-1, 3) ^ np.array([0, 128, 128], np.uint8)
    if native:
        out = codecs.lab_tetra_interp(flat, clut(), GRID)
    else:
        out = np.zeros(flat.shape, np.uint8)
        for start in range(0, len(flat), 1 << 16):
            out16 = tetra_interp_python(flat[start:start + (1 << 16)].astype(np.int64) * 257,
                                        clut())
            out[start:start + (1 << 16)] = (out16 * 65281 + 8388608) >> 24   # FROM_16_TO_8
    return out.reshape(np.shape(lab))
