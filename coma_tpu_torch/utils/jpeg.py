"""A baseline JPEG round trip in numpy: what ``PIL.Image.save(buf, "JPEG",
quality=q)`` followed by ``PIL.Image.open(buf)`` does to an RGB image.

Pillow calls libjpeg(-turbo) with its defaults; this reproduces each lossy
step of that path in integer arithmetic, as libjpeg writes it:

- encode: fixed-point RGB -> YCbCr (``jccolor.c``), 4:2:0 chroma by the
  h2v2 box downsample with alternating bias (``jcsample.c``), the standard
  luminance and chrominance tables scaled by ``jpeg_quality_scaling(q)``
  (``jcparam.c``), ``jpeg_fdct_islow`` (``jfdctint.c``) on level-shifted
  8x8 blocks and quantisation rounding half away from zero
  (``jcdctmgr.c``);
- decode: dequantisation and ``jpeg_idct_islow`` (``jidctint.c``) with its
  range-limit table, "fancy" h2v2 (triangle) upsampling (``jdsample.c``),
  fixed-point YCbCr -> RGB (``jdcolor.c``).

Huffman coding is lossless, so it is left out. Edges are padded by
replication as libjpeg pads to whole MCUs. The card machine has no PIL; the
training data's corruption (``models/synthetic_person.sd_corrupt``) uses
this.
"""
from __future__ import annotations

import numpy as np

_STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_STD_CHROMINANCE = np.full((8, 8), 99, np.int64)
_STD_CHROMINANCE[:4, :4] = np.array([
    17, 18, 24, 47,
    18, 21, 26, 66,
    24, 26, 56, 99,
    47, 66, 99, 99,
]).reshape(4, 4)

CONST_BITS, PASS1_BITS = 13, 2


def _fix13(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


FIX_0_298631336 = _fix13(0.298631336)
FIX_0_390180644 = _fix13(0.390180644)
FIX_0_541196100 = _fix13(0.541196100)
FIX_0_765366865 = _fix13(0.765366865)
FIX_0_899976223 = _fix13(0.899976223)
FIX_1_175875602 = _fix13(1.175875602)
FIX_1_501321110 = _fix13(1.501321110)
FIX_1_847759065 = _fix13(1.847759065)
FIX_1_961570560 = _fix13(1.961570560)
FIX_2_053119869 = _fix13(2.053119869)
FIX_2_562915447 = _fix13(2.562915447)
FIX_3_072711026 = _fix13(3.072711026)

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def jpeg_quality_scaling(quality: int) -> int:
    """libjpeg's quality -> percentage scale factor."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def quant_tables(quality: int):
    """(luminance, chrominance) (8, 8) tables at ``quality``, baseline
    (each entry in [1, 255])."""
    scale = jpeg_quality_scaling(quality)
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMINANCE, _STD_CHROMINANCE))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, final: bool):
    """One pass of ``jpeg_fdct_islow`` over the last axis (8 values)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS + PASS1_BITS if final else CONST_BITS - PASS1_BITS
    out = [None] * 8
    if final:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
    out[6] = _descale(z1 + tmp12 * (-FIX_1_847759065), shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=-1)


def _idct_1d(d, final: bool):
    """One pass of ``jpeg_idct_islow`` over the last axis (8 values); the
    all-zero-AC shortcuts of ``jidctint.c`` give the same values."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (d[..., 0] + d[..., 4]) << CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    shift = CONST_BITS + PASS1_BITS + 3 if final else CONST_BITS - PASS1_BITS
    return np.stack([
        _descale(tmp10 + tmp3, shift), _descale(tmp11 + tmp2, shift),
        _descale(tmp12 + tmp1, shift), _descale(tmp13 + tmp0, shift),
        _descale(tmp13 - tmp0, shift), _descale(tmp12 - tmp1, shift),
        _descale(tmp11 - tmp2, shift), _descale(tmp10 - tmp3, shift),
    ], axis=-1)


def _idct_range_limit() -> np.ndarray:
    """``IDCT_range_limit``: the 1024-entry table indexed by ``x & 1023``
    (x the centred output): x + 128 for x in [-128, 127], 255 above up to
    511, 0 below down to -512, wrapping beyond."""
    v = np.arange(1024)
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896)))


_IDCT_LIMIT = _idct_range_limit()


def _blocks(plane: np.ndarray) -> np.ndarray:
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    nby, nbx = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)


def _code_plane(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Level shift, forward DCT, quantise, dequantise, inverse DCT and range
    limit of one component (H, W multiples of 8) -> uint8-valued int64."""
    data = _blocks(plane - 128)
    data = _fdct_1d(data, final=False)                            # rows
    data = _fdct_1d(data.swapaxes(-1, -2), final=True).swapaxes(-1, -2)   # columns
    qval = table << 3                                             # the islow DCT's scale 8
    half = qval >> 1
    coef = np.where(data < 0, -((-data + half) // qval), (data + half) // qval)
    coef = coef * table                                           # dequantised
    ws = _idct_1d(coef.swapaxes(-1, -2), final=False).swapaxes(-1, -2)   # columns
    out = _idct_1d(ws, final=True)                                # rows
    return _IDCT_LIMIT[_unblocks(out) & 1023]


def _upsample_h2v2_fancy(c: np.ndarray, H: int, W: int) -> np.ndarray:
    """``h2v2_fancy_upsample``: a triangle filter, 3/4 of the nearer chroma
    sample and 1/4 of the farther in each direction, edges replicated;
    rounding biases 8 and 7 alternate by column."""
    h, w = (H + 1) // 2, (W + 1) // 2
    c = c[:h, :w]
    above = np.concatenate([c[:1], c[:-1]], axis=0)
    below = np.concatenate([c[1:], c[-1:]], axis=0)
    out = np.empty((2 * h, 2 * w), np.int64)
    for v, other in ((0, above), (1, below)):
        s = 3 * c + other                                         # column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * s + left + 8) >> 4
        out[v::2, 1::2] = (3 * s + right + 7) >> 4
    return out[:H, :W]


def jpeg_roundtrip(image: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> the (H, W, 3) uint8 RGB that Pillow decodes
    after saving it as a baseline JPEG at ``quality`` with its defaults."""
    rgb = np.asarray(image)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16       # whole MCUs
    # rows to an even count and columns to whole MCUs by replication
    # (``jcprepct.c``, ``jcsample.c expand_right_edge``)
    x = np.pad(rgb, ((0, H % 2), (0, Wp - W), (0, 0)), mode="edge").astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    # jccolor.c rgb_ycc_convert (Cb and Cr round with 0.5 - epsilon)
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + ONE_HALF) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + (128 << 16) + ONE_HALF - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + (128 << 16) + ONE_HALF - 1) >> 16

    # jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along the row
    bias = np.tile([1, 2], Wp // 4)[None, :]

    def down(p):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2

    def to_mcu_rows(p, rows):
        # the last row of each component is replicated to a whole iMCU
        return np.pad(p, ((0, rows - p.shape[0]), (0, 0)), mode="edge")

    lum, chrom = quant_tables(quality)
    y = _code_plane(to_mcu_rows(y, Hp), lum)[:H, :W]
    cb = _upsample_h2v2_fancy(_code_plane(to_mcu_rows(down(cb), Hp // 2), chrom), H, W)
    cr = _upsample_h2v2_fancy(_code_plane(to_mcu_rows(down(cr), Hp // 2), chrom), H, W)

    # jdcolor.c ycc_rgb_convert
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * cr + ONE_HALF) >> 16)
    g = y + ((-_fix16(0.34414) * cb + ONE_HALF - _fix16(0.71414) * cr) >> 16)
    b = y + ((_fix16(1.77200) * cb + ONE_HALF) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
