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

import ctypes
import re

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
    return _idct_samples(coef * table)                            # dequantised


def _idct_samples(coef: np.ndarray) -> np.ndarray:
    """Dequantised (nby, nbx, 8, 8) blocks -> samples (nby*8, nbx*8): the
    inverse DCT (columns, then rows) and the range limit."""
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


def _upsample_h2v1_fancy(c: np.ndarray, H: int, W: int) -> np.ndarray:
    """``h2v1_fancy_upsample``: 3/4 of the nearer sample and 1/4 of the
    farther along the row, edges replicated; biases 1 and 2 alternate."""
    c = c[:H, :(W + 1) // 2].astype(np.int64)
    left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    out = np.empty((H, 2 * c.shape[1]), np.int64)
    out[:, 0::2] = (3 * c + left + 1) >> 2
    out[:, 1::2] = (3 * c + right + 2) >> 2
    return out[:, :W]


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c ycc_rgb_convert`` of full-size planes -> (H, W, 3) uint8."""
    y, cb, cr = (np.asarray(p, np.int64) for p in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * cr + ONE_HALF) >> 16)
    g = y + ((-_fix16(0.34414) * cb + ONE_HALF - _fix16(0.71414) * cr) >> 16)
    b = y + ((_fix16(1.77200) * cb + ONE_HALF) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


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

    return _ycc_to_rgb(y, cb, cr)


# ---------------------------------------------------------------------------
# The decoder: what ``np.asarray(PIL.Image.open(path))`` gives for a JPEG file
# ---------------------------------------------------------------------------

# zig-zag index -> natural (row-major) index, padded as libjpeg pads it so a
# corrupt run stays inside the block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)
_NATURAL_LIST = _NATURAL.tolist()

_SOF_REFUSED = {
    0xC3: "lossless (SOF3) coding", 0xC5: "hierarchical (SOF5) coding",
    0xC6: "hierarchical (SOF6) coding", 0xC7: "hierarchical lossless (SOF7) coding",
    0xC9: "arithmetic (SOF9) coding", 0xCA: "arithmetic progressive (SOF10) coding",
    0xCB: "arithmetic lossless (SOF11) coding", 0xCD: "arithmetic hierarchical (SOF13) coding",
    0xCE: "arithmetic hierarchical (SOF14) coding",
    0xCF: "arithmetic hierarchical lossless (SOF15) coding",
    0xCC: "arithmetic coding (DAC)",
}
# the end of a scan's entropy-coded data: a marker other than RSTn (fill bytes
# 0xFF may precede it; 0xFF 0x00 is a stuffed data byte)
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_TABLE_BYTES = 1 + 16 + 256        # present, counts of code lengths 1..16, values


class JpegCoefficients:
    """A JPEG file's frame and its quantised DCT coefficients after every
    scan: ``coef[i]`` is component i's (block rows, blocks per row, 64) int16
    array in natural order, padded to whole MCUs; ``quant[i]`` its (8, 8)
    table (latched at the component's first scan, as libjpeg does)."""

    def __init__(self, name: str, height: int, width: int, components: list,
                 progressive: bool):
        self.name, self.height, self.width = name, height, width
        self.progressive = progressive
        self.ids = [c[0] for c in components]
        self.sampling = [(c[1], c[2]) for c in components]
        self.table_ids = [c[3] for c in components]
        self.max_h = max(h for h, _ in self.sampling)
        self.max_v = max(v for _, v in self.sampling)
        self.mcus_x = -(-width // (8 * self.max_h))
        self.mcus_y = -(-height // (8 * self.max_v))
        self.coef = [np.zeros((self.mcus_y * v, self.mcus_x * h, 64), np.int16)
                     for h, v in self.sampling]
        self.quant = [None] * len(components)
        self.coef_bits = np.full((len(components), 64), -1)   # libjpeg's coef_bits
        self.jfif = False
        self.adobe_transform = None

    def component_size(self, i: int):
        """(rows, columns) of component i's samples: ``downsampled_height``
        and ``downsampled_width``."""
        h, v = self.sampling[i]
        return (-(-self.height * v // self.max_v), -(-self.width * h // self.max_h))


class _ScanSpec:
    """One scan: its components (frame indices), spectral range, successive
    approximation bits, restart interval and Huffman tables."""

    def __init__(self, frame: JpegCoefficients, comps: list, dc_ids: list, ac_ids: list,
                 ss: int, se: int, ah: int, al: int, restart: int, tables: np.ndarray):
        self.frame, self.comps, self.dc_ids, self.ac_ids = frame, comps, dc_ids, ac_ids
        self.ss, self.se, self.ah, self.al, self.restart = ss, se, ah, al, restart
        self.tables = tables               # (8, _TABLE_BYTES): DC 0-3, AC 4-7

    def units(self) -> list:
        """The blocks of each MCU in coding order: per MCU a list of
        (position in ``comps``, flat block index)."""
        f = self.frame
        if len(self.comps) == 1:
            ci = self.comps[0]
            rows, cols = (-(-n // 8) for n in f.component_size(ci))
            bw = f.coef[ci].shape[1]
            return [[(0, y * bw + x)] for y in range(rows) for x in range(cols)]
        out = []
        for my in range(f.mcus_y):
            for mx in range(f.mcus_x):
                mcu = []
                for j, ci in enumerate(self.comps):
                    h, v = f.sampling[ci]
                    bw = f.coef[ci].shape[1]
                    mcu += [(j, (my * v + y) * bw + mx * h + x)
                            for y in range(v) for x in range(h)]
                out.append(mcu)
        return out


def _lookup(spec: np.ndarray, name: str) -> list:
    """A Huffman table as a 65536-entry list indexed by the next 16 bits:
    ``(length << 8) | symbol``, 0 where no code starts with those bits."""
    if not spec[0]:
        raise ValueError(f"{name}: a scan uses a Huffman table that was never defined")
    counts, values = spec[1:17], spec[17:]
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            if code >= 1 << length:
                raise ValueError(f"{name}: a Huffman table with more codes than fit")
            lut[code << (16 - length):(code + 1) << (16 - length)] = length << 8 | int(values[k])
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


class _Bits:
    """Bits of one restart interval's data, high bit first; zeros past its
    end (libjpeg fills its bit buffer with zeros at a marker)."""

    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf, self.pos = data + bytes(8), 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p, b = self.pos, self.buf
        i = p >> 3
        if i + 3 > len(b):
            self.buf = b = b + bytes(len(b))
        self.pos = p + n
        return ((b[i] << 16 | b[i + 1] << 8 | b[i + 2]) >> (24 - (p & 7) - n)) & ((1 << n) - 1)

    def symbol(self, lut: list, name: str) -> int:
        p, b = self.pos, self.buf
        i = p >> 3
        if i + 3 > len(b):
            self.buf = b = b + bytes(len(b))
        entry = lut[((b[i] << 16 | b[i + 1] << 8 | b[i + 2]) >> (8 - (p & 7))) & 0xFFFF]
        if not entry:
            raise ValueError(f"{name}: a Huffman code that no table entry starts (corrupt data)")
        self.pos = p + (entry >> 8)
        return entry & 0xFF


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _entropy_python(scan: _ScanSpec, segments: list) -> None:
    """The plain entropy decoder: ``jdhuff.c``'s sequential and ``jdphuff.c``'s
    progressive block decoders, written into ``scan.frame.coef``. The
    reference of the native one (``native/src/jpeg_decode.cpp``)."""
    f, name, nat = scan.frame, scan.frame.name, _NATURAL_LIST
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    coefs = [memoryview(f.coef[ci]).cast("B").cast("h") for ci in scan.comps]
    dc = [_lookup(scan.tables[t], name) if not f.progressive or (ss == 0 and ah == 0)
          else None for t in scan.dc_ids]
    ac = [_lookup(scan.tables[4 + t], name) if not f.progressive or ss > 0 else None
          for t in scan.ac_ids]
    units = scan.units()
    per = scan.restart or len(units)
    if len(segments) < -(-len(units) // per):
        raise ValueError(f"{name}: {len(segments)} restart intervals, expected "
                         f"{-(-len(units) // per)}")
    p1, m1 = 1 << al, -1 << al
    for m, mcu in enumerate(units):
        if m % per == 0:
            bits, pred, eobrun = _Bits(segments[m // per]), [0] * len(scan.comps), 0
        for j, blk in mcu:
            c, base = coefs[j], blk * 64
            if not f.progressive:
                s = bits.symbol(dc[j], name)
                pred[j] += _extend(bits.get(s), s) if s else 0
                c[base] = _wrap16(pred[j])
                k = 1
                while k < 64:
                    rs = bits.symbol(ac[j], name)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        c[base + nat[k]] = _extend(bits.get(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:                                          # DC scans
                if ah == 0:
                    s = bits.symbol(dc[j], name)
                    pred[j] += _extend(bits.get(s), s) if s else 0
                    c[base] = _wrap16(pred[j] << al)
                elif bits.get(1):
                    c[base] = c[base] | p1
            elif ah == 0:                                          # AC first
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = bits.symbol(ac[j], name)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        c[base + nat[k]] = _wrap16(_extend(bits.get(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + bits.get(r) - 1
                        break
                    k += 1
            else:                                                  # AC refine
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = bits.symbol(ac[j], name)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if bits.get(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + bits.get(r)
                            break
                        while k <= se:
                            pos = base + nat[k]
                            if c[pos] != 0:
                                if bits.get(1) and c[pos] & p1 == 0:
                                    c[pos] += p1 if c[pos] >= 0 else m1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            c[base + nat[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        pos = base + nat[k]
                        if c[pos] != 0 and bits.get(1) and c[pos] & p1 == 0:
                            c[pos] += p1 if c[pos] >= 0 else m1
                        k += 1
                    eobrun -= 1


def _wrap16(x: int) -> int:
    """C's conversion of an int to ``JCOEF`` (int16)."""
    return (x + 0x8000) % 0x10000 - 0x8000


def _declare(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_decode_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,           # data, starts, count
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # MCUs x, y, RI, comps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # comp, coef, tables
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # Ss, Se, Ah, Al
        ctypes.c_int,                                             # progressive
    ]
    lib.jpeg_reconstruct.restype = None
    lib.jpeg_reconstruct.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,   # H, W, comps, comp
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,              # coef, quant, colour
        ctypes.c_void_p,                                             # out
    ]


def _native():
    """The ctypes library of ``native/src/jpeg_decode.cpp``, built with
    ``g++`` at first use; None without a toolchain."""
    from coma_tpu_torch import native

    return native.load_library(native.JPEG_DECODE_SRC, _declare)


def native_available() -> bool:
    """Whether the native decoder builds and loads in this process."""
    return _native() is not None


_NATIVE_ERRORS = {1: "a Huffman code that no table entry starts (corrupt data)",
                  2: "a scan uses a Huffman table that was never defined",
                  3: "fewer restart intervals than the scan's MCUs need",
                  4: "a Huffman table with more codes than fit"}


def _entropy_native(scan: _ScanSpec, segments: list) -> None:
    lib = _native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available (no g++)")
    f = scan.frame
    starts = np.zeros(len(segments) + 1, np.int64)
    starts[1:] = np.cumsum([len(s) for s in segments])
    data = np.frombuffer(b"".join(segments) + bytes(8), np.uint8)
    comp = np.array([[*f.sampling[ci], f.coef[ci].shape[1],
                      *(-(-n // 8) for n in f.component_size(ci)[::-1]), d, a]
                     for ci, d, a in zip(scan.comps, scan.dc_ids, scan.ac_ids)], np.int32)
    pointers = _pointers([f.coef[ci] for ci in scan.comps])
    tables = np.ascontiguousarray(scan.tables, np.uint8)
    status = lib.jpeg_decode_scan(
        data.ctypes.data, starts.ctypes.data, len(segments), f.mcus_x, f.mcus_y, scan.restart,
        len(scan.comps), comp.ctypes.data, ctypes.cast(pointers, ctypes.c_void_p),
        tables.ctypes.data, scan.ss, scan.se, scan.ah, scan.al, int(f.progressive))
    if status:
        raise ValueError(f"{f.name}: {_NATIVE_ERRORS.get(status, f'status {status}')}")


def _pointers(arrays: list):
    """A C array of pointers to C-contiguous int16 coefficient arrays."""
    for a in arrays:
        if a.dtype != np.int16 or not a.flags.c_contiguous:
            raise ValueError(f"coefficients must be C-contiguous int16, got {a.dtype}")
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def decode_coefficients(data: bytes, name: str = "<bytes>", native=None) -> JpegCoefficients:
    """Parse a JPEG file and entropy-decode every scan. ``native``: True the
    C++ decoder, False the plain Python one, None the C++ one where it
    builds. Files libjpeg reads that this does not (arithmetic, lossless,
    hierarchical, 12-bit, CMYK/YCCK, other sampling factors, a progressive
    file whose scans leave libjpeg to smooth the blocks) raise a
    ``ValueError`` naming ``name`` and the feature."""
    if native is None:
        native = native_available()
    entropy = _entropy_native if native else _entropy_python
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    frame, restart, quant, jfif, adobe = None, 0, {}, False, None
    tables = np.zeros((8, _TABLE_BYTES), np.uint8)
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:      # libjpeg skips extraneous bytes
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{name}: the file ends before its EOI marker (truncated)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                         # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:               # RSTn, TEM: no body
            continue
        if pos + 2 > n:
            raise ValueError(f"{name}: the file ends inside a marker (truncated)")
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{name}: marker 0x{marker:02X} runs past the end of the file")
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{name}: {_SOF_REFUSED[marker]} is not read")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{name}: a second frame header")
            frame = _frame(body, marker == 0xC2, name)
        elif marker == 0xC4:
            _define_huffman(body, tables, name)
        elif marker == 0xDB:
            _define_quant(body, quant, name)
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            scan = _scan(body, frame, quant, restart, tables.copy(), name)
            end = _SCAN_END.search(data, pos)
            if end is None:
                raise ValueError(f"{name}: the file ends inside a scan (truncated)")
            segments = [s.replace(b"\xff\x00", b"\xff")
                        for s in _RESTART.split(data[pos:end.start()])]
            entropy(scan, segments)
            pos = end.start()
        elif marker == 0xDC:
            raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read")
        # APPn, COM and the rest carry nothing the pixels need
        if marker == 0xD8:
            raise ValueError(f"{name}: a second SOI marker")
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    frame.jfif, frame.adobe_transform = jfif, adobe
    if any(q is None for q in frame.quant):
        raise ValueError(f"{name}: a component appears in no scan")
    if frame.progressive:
        # libjpeg smooths the blocks (jdcoefct.c) while any of the first nine
        # AC coefficients is not fully refined, provided every DC is known
        bits = frame.coef_bits
        if (bits[:, 0] >= 0).all() and (bits[:, 1:10] != 0).any():
            raise ValueError(f"{name}: the progressive scans leave coefficients unrefined; "
                             "libjpeg's block smoothing is not reproduced")
    return frame


def _frame(body: bytes, progressive: bool, name: str) -> JpegCoefficients:
    """SOF0/1/2: precision, size and components."""
    if len(body) < 6:
        raise ValueError(f"{name}: a short frame header")
    precision, height, width, count = body[0], *((body[1] << 8) | body[2],
                                                  (body[3] << 8) | body[4]), body[5]
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit samples are not read (8-bit only)")
    if height == 0:
        raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read")
    if width == 0 or len(body) < 6 + 3 * count:
        raise ValueError(f"{name}: a frame header with width {width}, {count} components")
    if count == 4:
        raise ValueError(f"{name}: a 4-component (CMYK/YCCK) JPEG is not read")
    if count not in (1, 3):
        raise ValueError(f"{name}: a {count}-component JPEG is not read")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
             for i in range(count)]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) or t > 3 for _, h, v, t in comps):
        raise ValueError(f"{name}: bad sampling factors or table ids {comps}")
    if count == 1:                 # one component: its own factors set the MCU
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    max_h, max_v = max(c[1] for c in comps), max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if max_h % h or max_v % v or (max_h // h, max_v // v) not in _UPSAMPLE:
            raise ValueError(f"{name}: sampling factors {[(c[1], c[2]) for c in comps]} are "
                             "not read (4:4:4, 4:2:2 and 4:2:0 only)")
    return JpegCoefficients(name, height, width, comps, progressive)


def _define_huffman(body: bytes, tables: np.ndarray, name: str) -> None:
    pos = 0
    while pos < len(body):
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = np.frombuffer(body[pos + 1:pos + 17], np.uint8)
        total = int(counts.sum()) if len(counts) == 16 else -1
        if tc > 1 or th > 3 or total < 0 or total > 256 or pos + 17 + total > len(body):
            raise ValueError(f"{name}: a bad Huffman table definition")
        row = tables[4 * tc + th]
        row[:] = 0
        row[0], row[1:17] = 1, counts
        row[17:17 + total] = np.frombuffer(body[pos + 17:pos + 17 + total], np.uint8)
        pos += 17 + total


def _define_quant(body: bytes, quant: dict, name: str) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + size > len(body):
            raise ValueError(f"{name}: a bad quantisation table definition")
        values = np.frombuffer(body[pos + 1:pos + 1 + size], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.int64)
        table[_NATURAL[:64]] = values
        quant[tq] = table.reshape(8, 8)
        pos += 1 + size


def _scan(body: bytes, frame: JpegCoefficients, quant: dict, restart: int,
          tables: np.ndarray, name: str) -> _ScanSpec:
    """SOS: the scan's components, tables and spectral selection; latches the
    quantisation tables of components seen for the first time."""
    count = body[0] if body else 0
    if not 1 <= count <= 4 or len(body) < 4 + 2 * count:
        raise ValueError(f"{name}: a bad scan header")
    comps, dc_ids, ac_ids = [], [], []
    for i in range(count):
        cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{name}: a scan names component {cid}, not in the frame")
        comps.append(frame.ids.index(cid))
        dc_ids.append(td_ta >> 4)
        ac_ids.append(td_ta & 15)
    if max(dc_ids + ac_ids) > 3:
        raise ValueError(f"{name}: a scan names a Huffman table beyond 3")
    ss, se, ah, al = body[1 + 2 * count], body[2 + 2 * count], \
        body[3 + 2 * count] >> 4, body[3 + 2 * count] & 15
    if frame.progressive:
        dc_scan = ss == 0
        if (dc_scan and se != 0) or (not dc_scan and (se < ss or se > 63 or count != 1)) \
                or al > 13 or (ah and ah != al + 1):
            raise ValueError(f"{name}: a bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, "
                             f"Al {al}, {count} components)")
        frame.coef_bits[np.ix_(comps, range(ss, se + 1))] = al
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        raise ValueError(f"{name}: a sequential scan with Ss {ss}, Se {se}, Ah {ah}, Al {al}")
    for ci in comps:
        if frame.quant[ci] is None:
            t = frame.table_ids[ci]
            if t not in quant:
                raise ValueError(f"{name}: component {frame.ids[ci]} uses quantisation "
                                 f"table {t}, never defined")
            frame.quant[ci] = quant[t]
    return _ScanSpec(frame, comps, dc_ids, ac_ids, ss, se, ah, al, restart, tables)


# (max_h / h, max_v / v) -> upsampling of a component's samples to full size
_UPSAMPLE = {(1, 1), (2, 1), (2, 2)}


def _component_samples(frame: JpegCoefficients, i: int) -> np.ndarray:
    """Component i's samples at full size: dequantisation, ``jpeg_idct_islow``,
    the crop to ``downsampled_width`` x ``downsampled_height`` and libjpeg's
    upsampling (fancy where the component is wider than 2 samples)."""
    coef = frame.coef[i]
    blocks = np.zeros(coef.shape[:2] + (8, 8), np.int64)
    blocks.reshape(coef.shape)[...] = coef
    rows, cols = frame.component_size(i)
    nby, nbx = -(-rows // 8), -(-cols // 8)
    samples = _idct_samples(blocks[:nby, :nbx] * frame.quant[i])[:rows, :cols]
    H, W = frame.height, frame.width
    h, v = frame.sampling[i]
    ratio = (frame.max_h // h, frame.max_v // v)
    if ratio == (1, 1):
        return samples
    if cols <= 2:                                   # h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(samples, ratio[1], axis=0), 2, axis=1)[:H, :W]
    if ratio == (2, 1):
        return _upsample_h2v1_fancy(samples, H, W)
    return _upsample_h2v2_fancy(samples, H, W)


def _colour(frame: JpegCoefficients) -> int:
    """0 one gray plane, 1 YCbCr, 2 RGB: the colour space libjpeg infers
    (JFIF, component ids 1, 2, 3 or an Adobe transform 1: YCbCr; an Adobe
    transform 0 or ids 'R', 'G', 'B': RGB; otherwise YCbCr)."""
    if len(frame.coef) == 1:
        return 0
    if frame.jfif:
        return 1
    if frame.adobe_transform is not None:
        return 2 if frame.adobe_transform == 0 else 1
    return 2 if frame.ids == [82, 71, 66] else 1


def reconstruct(frame: JpegCoefficients, native=None) -> np.ndarray:
    """The coefficients -> (H, W, 3) uint8 RGB, or (H, W, 1) for one
    component: libjpeg's islow IDCT, upsampling and YCbCr -> RGB. ``native``
    as in :func:`decode_coefficients`: the C++ reconstruction
    (``jpeg_reconstruct``) or this plain numpy one, equal to the bit."""
    if native is None:
        native = native_available()
    colour = _colour(frame)
    if native:
        return _reconstruct_native(frame, colour)
    planes = [_component_samples(frame, i) for i in range(len(frame.coef))]
    if colour == 0:
        return planes[0].astype(np.uint8)[..., None]
    if colour == 2:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _reconstruct_native(frame: JpegCoefficients, colour: int) -> np.ndarray:
    lib = _native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available (no g++)")
    n = len(frame.coef)
    comp = np.array([[frame.max_h // h, frame.max_v // v, frame.coef[i].shape[1],
                      *frame.component_size(i)] for i, (h, v) in enumerate(frame.sampling)],
                    np.int32)
    quant = np.ascontiguousarray(np.stack([q.reshape(64) for q in frame.quant]), np.int64)
    pointers = _pointers(frame.coef)
    out = np.empty((frame.height, frame.width, n), np.uint8)
    lib.jpeg_reconstruct(frame.height, frame.width, n, comp.ctypes.data,
                         ctypes.cast(pointers, ctypes.c_void_p), quant.ctypes.data, colour,
                         out.ctypes.data)
    return out


def decode_jpeg(data: bytes, name: str = "<bytes>", native=None) -> np.ndarray:
    """A JPEG file's bytes -> what Pillow (libjpeg-turbo) decodes: (H, W, 3)
    uint8 for a colour file, (H, W, 1) for a grayscale one. Baseline,
    extended sequential and progressive Huffman coding, restart intervals,
    4:4:4, 4:2:2 and 4:2:0 sampling; anything else raises a ``ValueError``
    naming ``name``. ``native`` as in :func:`decode_coefficients`, for both
    halves."""
    if native is None:
        native = native_available()
    return reconstruct(decode_coefficients(data, name, native), native)


def read_jpeg(path: str, native=None) -> np.ndarray:
    """:func:`decode_jpeg` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), str(path), native)
