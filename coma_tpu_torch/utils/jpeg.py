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

# frame markers libjpeg(-turbo) refuses (Pillow then raises too)
_SOF_REFUSED = {
    0xC5: "hierarchical (SOF5) coding", 0xC6: "hierarchical (SOF6) coding",
    0xC7: "hierarchical lossless (SOF7) coding", 0xCB: "arithmetic lossless (SOF11) coding",
    0xCD: "arithmetic hierarchical (SOF13) coding", 0xCE: "arithmetic hierarchical (SOF14) coding",
    0xCF: "arithmetic hierarchical lossless (SOF15) coding", 0xDE: "hierarchical coding (DHP)",
}
# SOFn read: (progressive, arithmetic, lossless)
_SOF_READ = {0xC0: (False, False, False), 0xC1: (False, False, False),
             0xC2: (True, False, False), 0xC3: (False, False, True),
             0xC9: (False, True, False), 0xCA: (True, True, False)}
# the end of a scan's entropy-coded data: a marker other than RSTn (fill bytes
# 0xFF may precede it; 0xFF 0x00 is a stuffed data byte)
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_TABLE_BYTES = 1 + 16 + 256        # present, counts of code lengths 1..16, values


class JpegCoefficients:
    """A JPEG file's frame and its quantised DCT coefficients after every
    scan: ``coef[i]`` is component i's (block rows, blocks per row, 64) int16
    array in natural order, padded to whole MCUs; ``quant[i]`` its (8, 8)
    table (latched at the component's first scan, as libjpeg does). A
    lossless (SOF3) frame holds samples instead: ``coef[i]`` is (rows,
    columns) int32, padded to whole MCUs, undifferenced scan by scan."""

    def __init__(self, name: str, height: int, width: int, components: list,
                 progressive: bool, arithmetic: bool = False, lossless: bool = False):
        self.name, self.height, self.width = name, height, width
        self.progressive, self.arithmetic, self.lossless = progressive, arithmetic, lossless
        self.ids = [c[0] for c in components]
        # libjpeg's sampling factors; one component is its own MCU, so its
        # factors only shape the iMCU rows (block smoothing reads them)
        self.raw_sampling = [(c[1], c[2]) for c in components]
        self.sampling = [(1, 1)] if len(components) == 1 else list(self.raw_sampling)
        self.table_ids = [c[3] for c in components]
        self.max_h = max(h for h, _ in self.sampling)
        self.max_v = max(v for _, v in self.sampling)
        unit = 1 if lossless else 8
        self.mcus_x = -(-width // (unit * self.max_h))
        self.mcus_y = -(-height // (unit * self.max_v))
        if lossless:
            self.coef = [np.zeros((self.mcus_y * v, self.mcus_x * h), np.int32)
                         for h, v in self.sampling]
        else:
            self.coef = [np.zeros((self.mcus_y * v, self.mcus_x * h, 64), np.int16)
                         for h, v in self.sampling]
        self.quant = [None] * len(components)
        self.coef_bits = np.full((len(components), 64), -1)   # libjpeg's coef_bits
        self.seen = [False] * len(components)
        self.jfif = False
        self.adobe_transform = None
        # DAC conditioning per table: DC (L, U), AC K (libjpeg's defaults)
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16

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
        """The blocks (a lossless scan: samples) of each MCU in coding order:
        per MCU a list of (position in ``comps``, flat block index)."""
        f = self.frame
        if len(self.comps) == 1:
            ci = self.comps[0]
            unit = 1 if f.lossless else 8
            rows, cols = (-(-n // unit) for n in f.component_size(ci))
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


# jaricom.c's jpeg_aritab: per state, Qe, then Next_Index_LPS with the
# Switch_MPS flag in bit 7, then Next_Index_MPS (JPEG's Table D.2; state 113
# is the fixed 0.5 estimate)
_ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]
_QE = [q for q, _, _, _ in _ARITAB]
_NEXT_LPS = [lps | switch << 7 for _, lps, _, switch in _ARITAB]
_NEXT_MPS = [mps for _, _, mps, _ in _ARITAB]
_FIXED_BIN = 113


class _ArithDecoder:
    """``jdarith.c``'s ``arith_decode``: the QM decoder over one restart
    interval's bytes (stuffing removed), zeros past their end (as libjpeg
    supplies zeros at a marker)."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def bit(self, stats: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:                       # renormalisation and input, D.2.6
            ct -= 1
            if ct < 0:
                byte = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        qe = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                          # conditional exchange, D.2.4
                stats[i] = (sv & 0x80) ^ _NEXT_MPS[sv & 0x7F]
            else:
                stats[i] = (sv & 0x80) ^ _NEXT_LPS[sv & 0x7F]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ _NEXT_LPS[sv & 0x7F]
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ _NEXT_MPS[sv & 0x7F]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_value(dec: _ArithDecoder, stats: bytearray, st: int, sign: int, big: int,
                 name: str) -> int:
    """Figures F.23 and F.24: the magnitude category from bin ``st`` (then
    ``big`` onwards) and the magnitude bits, as a signed value."""
    m = dec.bit(stats, st)
    if m:
        if dec.bit(stats, st):
            m = 2
            st = big
            while dec.bit(stats, st):
                m <<= 1
                if m == 0x8000:
                    raise ValueError(f"{name}: an arithmetic-coded magnitude overflows "
                                     "(corrupt data)")
                st += 1
    v = m
    st += 14
    while m > 1:
        m >>= 1
        if dec.bit(stats, st):
            v |= m
    v += 1
    return -v if sign else v


def _arith_dc_diff(dec, stats: bytearray, ctx: list, j: int, lo: int, hi: int, name: str) -> int:
    """Figure F.19 with the DC conditioning of F.1.4.4.1.2: one DC
    difference (0 or signed), updating component j's context."""
    st = ctx[j]
    if dec.bit(stats, st) == 0:
        ctx[j] = 0
        return 0
    sign = dec.bit(stats, st + 1)
    st += 2 + sign
    m = dec.bit(stats, st)
    if m:
        st = 20
        while dec.bit(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{name}: an arithmetic-coded magnitude overflows "
                                 "(corrupt data)")
            st += 1
    if m < (1 << lo) >> 1:
        ctx[j] = 0
    elif m > (1 << hi) >> 1:
        ctx[j] = 12 + sign * 4
    else:
        ctx[j] = 4 + sign * 4
    v = m
    st += 14
    while m > 1:
        m >>= 1
        if dec.bit(stats, st):
            v |= m
    v += 1
    return -v if sign else v


def _arith_ac(dec, stats: bytearray, fixed: bytearray, k: int, se: int, kx: int,
              name: str):
    """Figure F.20 from position ``k``: None at an end of block, else
    (position, value) of the next nonzero coefficient."""
    st = 3 * (k - 1)
    if dec.bit(stats, st):
        return None
    while dec.bit(stats, st + 1) == 0:
        st += 3
        k += 1
        if k > se:
            raise ValueError(f"{name}: an arithmetic-coded block runs past its band "
                             "(corrupt data)")
    sign = dec.bit(fixed, 0)
    return k, _arith_value(dec, stats, st + 2, sign, 189 if k <= kx else 217, name)


def _entropy_arith_python(scan: _ScanSpec, segments: list) -> None:
    """The plain arithmetic decoder: ``jdarith.c``'s sequential and
    progressive MCU decoders (statistics reset per scan and restart
    interval, DC and AC conditioning from DAC), written into
    ``scan.frame.coef``. The reference of the native one."""
    f, name, nat = scan.frame, scan.frame.name, _NATURAL_LIST
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    coefs = [memoryview(f.coef[ci]).cast("B").cast("h") for ci in scan.comps]
    units = scan.units()
    per = scan.restart or len(units)
    if len(segments) < -(-len(units) // per):
        raise ValueError(f"{name}: {len(segments)} restart intervals, expected "
                         f"{-(-len(units) // per)}")
    p1, m1 = 1 << al, -1 << al
    sequential = not f.progressive
    for m, mcu in enumerate(units):
        if m % per == 0:
            dec = _ArithDecoder(segments[m // per])
            dc_stats = {t: bytearray(64) for t in scan.dc_ids}
            ac_stats = {t: bytearray(256) for t in scan.ac_ids}
            fixed = bytearray([_FIXED_BIN])
            pred, ctx = [0] * len(scan.comps), [0] * len(scan.comps)
        for j, blk in mcu:
            c, base = coefs[j], blk * 64
            if sequential or (ss == 0 and ah == 0):                # DC
                t = scan.dc_ids[j]
                diff = _arith_dc_diff(dec, dc_stats[t], ctx, j, f.dc_l[t], f.dc_u[t], name)
                if sequential:
                    pred[j] = (pred[j] + diff) & 0xFFFF
                    c[base] = _wrap16(pred[j])
                else:
                    pred[j] += diff
                    c[base] = _wrap16(pred[j] << al)
            elif ss == 0:                                          # DC refine
                if dec.bit(fixed, 0):
                    c[base] = c[base] | p1
            if sequential or (ss > 0 and ah == 0):                 # AC (first)
                t = scan.ac_ids[j]
                stats, kx = ac_stats[t], f.ac_k[t]
                k, last = (1, 63) if sequential else (ss, se)
                while k <= last:
                    hit = _arith_ac(dec, stats, fixed, k, last, kx, name)
                    if hit is None:
                        break
                    k, v = hit
                    c[base + nat[k]] = v if sequential else _wrap16(v << al)
                    k += 1
            elif ss > 0:                                           # AC refine
                stats = ac_stats[scan.ac_ids[j]]
                kex = se
                while kex > 0 and c[base + nat[kex]] == 0:
                    kex -= 1
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if k > kex and dec.bit(stats, st):
                        break
                    while True:
                        pos = base + nat[k]
                        if c[pos]:
                            if dec.bit(stats, st + 2):
                                c[pos] += m1 if c[pos] < 0 else p1
                            break
                        if dec.bit(stats, st + 1):
                            c[pos] = m1 if dec.bit(fixed, 0) else p1
                            break
                        st += 3
                        k += 1
                        if k > se:
                            raise ValueError(f"{name}: an arithmetic-coded block runs past "
                                             "its band (corrupt data)")
                    k += 1


def _lossless_python(scan: _ScanSpec, segments: list) -> None:
    """The plain lossless decoder: ``jdlhuff.c``'s sample differences, then
    ``jdlossls.c``'s undifferencing (the first row of the scan and of each
    restart interval predicts from the left, the first column from above)
    and the point transform, written into ``scan.frame.coef``."""
    f, name = scan.frame, scan.frame.name
    diffs = [np.zeros(f.coef[ci].shape, np.int64) for ci in scan.comps]
    flat = [d.reshape(-1) for d in diffs]
    tables = [_lookup(scan.tables[t], name) for t in scan.dc_ids]
    units = scan.units()
    per = scan.restart or len(units)
    if len(segments) < -(-len(units) // per):
        raise ValueError(f"{name}: {len(segments)} restart intervals, expected "
                         f"{-(-len(units) // per)}")
    for m, mcu in enumerate(units):
        if m % per == 0:
            bits = _Bits(segments[m // per])
        for j, idx in mcu:
            s = bits.symbol(tables[j], name)
            flat[j][idx] = 32768 if s == 16 else (_extend(bits.get(s), s) if s else 0)
    for j, ci in enumerate(scan.comps):
        f.coef[ci][...] = _undifference(diffs[j], f.component_size(ci),
                                        _restart_rows(scan, ci), scan.ss, scan.al)


def _restart_rows(scan: _ScanSpec, ci: int) -> int:
    """Sample rows of component ``ci`` per restart interval of a lossless
    scan (0: none); libjpeg takes only whole rows of MCUs."""
    f = scan.frame
    if not scan.restart:
        return 0
    if len(scan.comps) == 1:
        per_row, rows_per_mcu_row = f.component_size(ci)[1], 1
    else:
        per_row, rows_per_mcu_row = f.mcus_x, f.sampling[ci][1]
    if scan.restart % per_row:
        raise ValueError(f"{f.name}: a lossless restart interval of {scan.restart} MCUs is "
                         f"not a whole number of MCU rows ({per_row})")
    return scan.restart // per_row * rows_per_mcu_row


def _undifference(diff: np.ndarray, size: tuple, restart_rows: int, predictor: int,
                  pt: int) -> np.ndarray:
    """Differences (padded) -> samples: prediction with ``predictor`` 1-7,
    sums modulo 2^16, then ``<< pt`` truncated to 8 bits."""
    rows, cols = size
    out = np.zeros(diff.shape, np.int32)
    d = diff.tolist()
    prev = None
    for y in range(rows):
        row, cur = d[y], [0] * cols
        if prev is None or (restart_rows and y % restart_rows == 0):
            ra = (row[0] + (1 << (7 - pt))) & 0xFFFF        # the first row: from the left
            cur[0] = ra
            for x in range(1, cols):
                ra = (row[x] + ra) & 0xFFFF
                cur[x] = ra
        else:
            rb = prev[0]
            ra = (row[0] + rb) & 0xFFFF                      # the first column: from above
            cur[0] = ra
            for x in range(1, cols):
                rc, rb = rb, prev[x]
                p = (ra if predictor == 1 else rb if predictor == 2 else rc
                     if predictor == 3 else ra + rb - rc if predictor == 4
                     else ra + ((rb - rc) >> 1) if predictor == 5
                     else rb + ((ra - rc) >> 1) if predictor == 6 else (ra + rb) >> 1)
                ra = (row[x] + p) & 0xFFFF
                cur[x] = ra
        out[y, :cols] = np.asarray(cur, np.int64) << pt & 0xFF
        prev = cur
    return out


def _declare(lib: ctypes.CDLL) -> None:
    scan_args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,           # data, starts, count
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # MCUs x, y, RI, comps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # comp, coef, tables
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # Ss, Se, Ah, Al
        ctypes.c_int,                                             # progressive
    ]
    for fn in (lib.jpeg_decode_scan, lib.jpeg_decode_scan_arith, lib.jpeg_decode_scan_lossless):
        fn.restype = ctypes.c_int
        fn.argtypes = scan_args
    lib.jpeg_smooth.restype = None
    lib.jpeg_smooth.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # in, out, bw, rows held
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # hb, wb, v
        ctypes.c_void_p, ctypes.c_void_p,                               # quant, bits
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
                  4: "a Huffman table with more codes than fit",
                  5: "an arithmetic-coded value overflows its band (corrupt data)"}


def _entropy_native(scan: _ScanSpec, segments: list) -> None:
    """The C++ entropy decoders of ``native/src/jpeg_decode.cpp``: Huffman,
    arithmetic or lossless as the frame is coded. For a lossless scan the
    comp rows carry (rows, columns, restart rows) and the predictor rides
    in Ss, the point transform in Al, as in the scan header."""
    lib = _native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available (no g++)")
    f = scan.frame
    starts = np.zeros(len(segments) + 1, np.int64)
    starts[1:] = np.cumsum([len(s) for s in segments])
    data = np.frombuffer(b"".join(segments) + bytes(8), np.uint8)
    unit = 1 if f.lossless else 8
    comp = np.array([[*f.sampling[ci], f.coef[ci].shape[1],
                      *(-(-n // unit) for n in f.component_size(ci)[::-1]), d, a,
                      *f.component_size(ci), _restart_rows(scan, ci) if f.lossless else 0]
                     for ci, d, a in zip(scan.comps, scan.dc_ids, scan.ac_ids)], np.int32)
    pointers = _pointers([f.coef[ci] for ci in scan.comps])
    if f.arithmetic:
        tables = np.array(f.dc_l + f.dc_u + f.ac_k, np.int32)
        fn = lib.jpeg_decode_scan_arith
    else:
        tables = np.ascontiguousarray(scan.tables, np.uint8)
        fn = lib.jpeg_decode_scan_lossless if f.lossless else lib.jpeg_decode_scan
    status = fn(data.ctypes.data, starts.ctypes.data, len(segments), f.mcus_x, f.mcus_y,
                scan.restart, len(scan.comps), comp.ctypes.data,
                ctypes.cast(pointers, ctypes.c_void_p), tables.ctypes.data, scan.ss, scan.se,
                scan.ah, scan.al, int(f.progressive))
    if status:
        raise ValueError(f"{f.name}: {_NATIVE_ERRORS.get(status, f'status {status}')}")


def _pointers(arrays: list):
    """A C array of pointers to C-contiguous coefficient (int16) or
    lossless sample (int32) arrays."""
    for a in arrays:
        if a.dtype not in (np.int16, np.int32) or not a.flags.c_contiguous:
            raise ValueError(f"coefficients must be C-contiguous int16, got {a.dtype}")
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def decode_coefficients(data: bytes, name: str = "<bytes>", native=None) -> JpegCoefficients:
    """Parse a JPEG file and entropy-decode every scan. ``native``: True the
    C++ decoder, False the plain Python one, None the C++ one where it
    builds. Files libjpeg-turbo refuses (hierarchical, arithmetic lossless,
    12-bit, a DNL height, sampling ratios that are not whole numbers) raise
    a ``ValueError`` naming ``name`` and the feature, as Pillow raises."""
    if native is None:
        native = native_available()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    frame, restart, quant, jfif, adobe = None, 0, {}, False, None
    tables = np.zeros((8, _TABLE_BYTES), np.uint8)
    conditioning = ([0] * 16, [1] * 16, [5] * 16)          # DAC: DC L, DC U, AC K
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
            raise ValueError(f"{name}: {_SOF_REFUSED[marker]} is not read (libjpeg refuses it)")
        if marker in _SOF_READ:
            if frame is not None:
                raise ValueError(f"{name}: a second frame header")
            frame = _frame(body, *_SOF_READ[marker], name)
            frame.dc_l, frame.dc_u, frame.ac_k = conditioning
        elif marker == 0xC4:
            _define_huffman(body, tables, name)
        elif marker == 0xCC:
            _define_conditioning(body, conditioning, name)
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
            if native:
                _entropy_native(scan, segments)
            elif frame.lossless:
                _lossless_python(scan, segments)
            elif frame.arithmetic:
                _entropy_arith_python(scan, segments)
            else:
                _entropy_python(scan, segments)
            pos = end.start()
        elif marker == 0xDC:
            raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read "
                             "(libjpeg refuses it)")
        # APPn, COM and the rest carry nothing the pixels need
        if marker == 0xD8:
            raise ValueError(f"{name}: a second SOI marker")
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    frame.jfif, frame.adobe_transform = jfif, adobe
    if not all(frame.seen):
        raise ValueError(f"{name}: a component appears in no scan")
    return frame


def _frame(body: bytes, progressive: bool, arithmetic: bool, lossless: bool,
           name: str) -> JpegCoefficients:
    """SOF0/1/2/3/9/10: precision, size and components."""
    if len(body) < 6:
        raise ValueError(f"{name}: a short frame header")
    precision, height, width, count = body[0], *((body[1] << 8) | body[2],
                                                  (body[3] << 8) | body[4]), body[5]
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit samples are not read (8-bit only, as "
                         "Pillow)")
    if height == 0:
        raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read "
                         "(libjpeg refuses it)")
    if width == 0 or len(body) < 6 + 3 * count:
        raise ValueError(f"{name}: a frame header with width {width}, {count} components")
    if count not in (1, 3, 4):
        raise ValueError(f"{name}: a {count}-component JPEG is not read (Pillow reads 1, 3 "
                         "and 4)")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
             for i in range(count)]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) or t > 3 for _, h, v, t in comps):
        raise ValueError(f"{name}: bad sampling factors or table ids {comps}")
    max_h, max_v = max(c[1] for c in comps), max(c[2] for c in comps)
    if count > 1:
        factors = [(c[1], c[2]) for c in comps]
        if any(max_h % h or max_v % v for h, v in factors):
            raise ValueError(f"{name}: sampling factors {factors} are not whole ratios "
                             "(libjpeg refuses them)")
        if sum(h * v for h, v in factors) > 10:
            raise ValueError(f"{name}: sampling factors {factors} put more than 10 blocks "
                             "in an MCU (libjpeg refuses them)")
    return JpegCoefficients(name, height, width, comps, progressive, arithmetic, lossless)


def _define_conditioning(body: bytes, conditioning: tuple, name: str) -> None:
    """DAC: per table, the DC conditioning bounds (L, U) or the AC K."""
    dc_l, dc_u, ac_k = conditioning
    for pos in range(0, len(body) - 1, 2):
        index, value = body[pos], body[pos + 1]
        if index >= 32:
            raise ValueError(f"{name}: a bad arithmetic conditioning table {index}")
        if index >= 16:
            ac_k[index - 16] = value
        else:
            dc_l[index], dc_u[index] = value & 15, value >> 4
            if dc_l[index] > dc_u[index]:
                raise ValueError(f"{name}: arithmetic DC conditioning with L > U")


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
    if count > 1 and sum(h * v for h, v in (frame.sampling[ci] for ci in comps)) > 10:
        raise ValueError(f"{name}: a scan with more than 10 blocks in an MCU (libjpeg refuses "
                         "it)")
    ss, se, ah, al = body[1 + 2 * count], body[2 + 2 * count], \
        body[3 + 2 * count] >> 4, body[3 + 2 * count] & 15
    if frame.lossless:
        if not 1 <= ss <= 7 or se or ah or al > 7:
            raise ValueError(f"{name}: a bad lossless scan (predictor {ss}, Se {se}, Ah {ah}, "
                             f"Pt {al})")
    elif frame.progressive:
        dc_scan = ss == 0
        if (dc_scan and se != 0) or (not dc_scan and (se < ss or se > 63 or count != 1)) \
                or al > 13 or (ah and ah != al + 1):
            raise ValueError(f"{name}: a bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, "
                             f"Al {al}, {count} components)")
        frame.coef_bits[np.ix_(comps, range(ss, se + 1))] = al
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        raise ValueError(f"{name}: a sequential scan with Ss {ss}, Se {se}, Ah {ah}, Al {al}")
    for ci in comps:
        frame.seen[ci] = True
        if frame.quant[ci] is None and not frame.lossless:
            t = frame.table_ids[ci]
            if t not in quant:
                raise ValueError(f"{name}: component {frame.ids[ci]} uses quantisation "
                                 f"table {t}, never defined")
            frame.quant[ci] = quant[t]
    return _ScanSpec(frame, comps, dc_ids, ac_ids, ss, se, ah, al, restart, tables)


def smoothing_wanted(frame: JpegCoefficients) -> bool:
    """``jdcoefct.c smoothing_ok``: libjpeg smooths a progressive frame's
    blocks when every component's DC is known and its table's first ten
    entries are nonzero, and some component's first nine AC coefficients
    are not fully refined."""
    if not frame.progressive:
        return False
    for i, q in enumerate(frame.quant):
        if (q.reshape(64)[:10] == 0).any() or frame.coef_bits[i, 0] < 0:
            return False
    return bool((frame.coef_bits[:, 1:10] != 0).any())


def _smoothing_rows(hb: int, v: int, padded: int) -> np.ndarray:
    """(5, hb) block rows whose DC values ``decompress_smooth_data`` reads
    for each block row, two above to two below. Measured against
    libjpeg-turbo 3.1.3 (through Pillow 12.1.0) on seeded files: the edges
    repeat; two below reaches into the padding rows of the component's
    buffer (``padded`` rows, whole iMCU rows of ``v``), which hold zeros,
    unless the row is in the last iMCU row; and in a frame of two iMCU rows
    whose last holds one block row, that row's second neighbour above is
    its first."""
    r = np.arange(hb)
    last_start = (hb - 1) // v * v            # the last iMCU row's first block row
    prev = np.maximum(r - 1, 0)
    prev2 = np.maximum(r - 2, 0)
    if last_start == v and hb == v + 1:
        prev2[-1] = prev[-1]
    nxt = np.minimum(r + 1, hb - 1)
    below2 = (r + 2 < hb) | ((r < last_start) & (r + 2 < padded))
    return np.stack([prev2, prev, r, nxt, np.where(below2, r + 2, nxt)])


def _smoothing_cols(wb: int) -> np.ndarray:
    """(5, wb) block columns, two left to two right, edges repeated."""
    return np.stack([np.clip(np.arange(wb) + d, 0, wb - 1) for d in (-2, -1, 0, 1, 2)])


# natural positions of the coefficients block smoothing estimates, by zig-zag
# index 1..9: AC01 AC10 AC20 AC11 AC02 AC03 AC12 AC21 AC30
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
# DC weights of each estimate over the 5 x 5 window (row-major DC01..DC25),
# with and without DC interpolation (libjpeg-turbo >= 2.1)
_SMOOTH_PLAIN = {
    1: {11: -7, 12: 50, 14: -50, 15: 7},
    8: {3: -7, 8: 50, 18: -50, 23: 7},
    16: {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
    9: {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10,
        9: -10},
    2: {11: -1, 12: 13, 13: -24, 14: 13, 15: -1},
}
_SMOOTH_DC = {
    1: {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38,
        15: 3, 16: -3, 17: 13, 19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1},
    8: {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1,
        17: -13, 18: -38, 19: -13, 20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1},
    16: {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1},
    9: {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    2: {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2},
    3: {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1},
    10: {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    17: {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1},
    24: {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1},
    0: {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8, 12: 42,
        13: 152, 14: 42, 15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6,
        23: -8, 24: -6, 25: -2},
}


def _smooth_component(frame: JpegCoefficients, i: int) -> np.ndarray:
    """Component i's coefficients as ``decompress_smooth_data`` hands them
    to the IDCT: each still-zero coefficient among the first nine ACs whose
    bits are not all known takes an estimate from the 5 x 5 neighbourhood
    of DC values (clamped below 2^Al); with no AC data at all the DC is
    re-estimated too and four more ACs filled."""
    coef = frame.coef[i]
    rows, cols = frame.component_size(i)
    hb, wb = -(-rows // 8), -(-cols // 8)
    v = frame.raw_sampling[i][1]
    padded = -(-hb // v) * v              # libjpeg's buffer rows; padding rows stay 0
    dc = np.zeros((padded, wb), np.int64)
    rows_held = min(padded, coef.shape[0])
    dc[:rows_held] = coef[:rows_held, :wb, 0]
    rsel, csel = _smoothing_rows(hb, v, padded), _smoothing_cols(wb)
    window = {5 * a + b + 1: dc[rsel[a]][:, csel[b]] for a in range(5) for b in range(5)}
    q = frame.quant[i].reshape(64).astype(np.int64)
    bits = frame.coef_bits[i]
    change_dc = bool((bits[1:10] == -1).all())
    out = coef.copy()
    block = out[:hb, :wb]
    weights = _SMOOTH_DC if change_dc else _SMOOTH_PLAIN
    for k, pos in enumerate(_SMOOTH_POS, start=1):
        al = int(bits[k])
        if pos not in weights or al == 0:
            continue
        num = q[0] * sum(w * window[d] for d, w in weights[pos].items())
        pred = np.where(num >= 0, ((q[pos] << 7) + num) // (q[pos] << 8),
                        ((q[pos] << 7) - num) // (q[pos] << 8))
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        target = block[..., pos]
        block[..., pos] = np.where(target == 0, pred, target)
    if change_dc:
        num = q[0] * sum(w * window[d] for d, w in weights[0].items())
        block[..., 0] = np.where(num >= 0, ((q[0] << 7) + num) // (q[0] << 8),
                                 -(((q[0] << 7) - num) // (q[0] << 8)))
    return out


def _upsample(samples: np.ndarray, rh: int, rv: int, H: int, W: int,
              fancy: bool) -> np.ndarray:
    """libjpeg-turbo's ``jdsample.c`` of one component's (rows, cols)
    samples to H x W: the triangle filters h2v1 and h2v2 (over more than 2
    columns) and h1v2, else ``int_upsample``'s replication (every other
    ratio, and every ratio of a lossless frame)."""
    c = samples.astype(np.int64)
    if (rh, rv) == (1, 1):
        return c[:H, :W]
    if fancy and (rh, rv) == (2, 1) and c.shape[1] > 2:
        return _upsample_h2v1_fancy(c, H, W)
    if fancy and (rh, rv) == (2, 2) and c.shape[1] > 2:
        return _upsample_h2v2_fancy(c, H, W)
    if fancy and (rh, rv) == (1, 2):
        above = np.concatenate([c[:1], c[:-1]], axis=0)
        below = np.concatenate([c[1:], c[-1:]], axis=0)
        out = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
        out[0::2] = (3 * c + above + 1) >> 2
        out[1::2] = (3 * c + below + 2) >> 2
        return out[:H, :W]
    return np.repeat(np.repeat(c, rv, axis=0), rh, axis=1)[:H, :W]


def _component_samples(frame: JpegCoefficients, i: int) -> np.ndarray:
    """Component i's samples at full size: dequantisation, ``jpeg_idct_islow``
    (of the smoothed blocks where libjpeg smooths), the crop to
    ``downsampled_width`` x ``downsampled_height`` and the upsampling; a
    lossless frame's samples go straight to the upsampling."""
    rows, cols = frame.component_size(i)
    if frame.lossless:
        samples = frame.coef[i][:rows, :cols]
    else:
        coef = _smooth_component(frame, i) if smoothing_wanted(frame) else frame.coef[i]
        blocks = np.zeros(coef.shape[:2] + (8, 8), np.int64)
        blocks.reshape(coef.shape)[...] = coef
        nby, nbx = -(-rows // 8), -(-cols // 8)
        samples = _idct_samples(blocks[:nby, :nbx] * frame.quant[i])[:rows, :cols]
    h, v = frame.sampling[i]
    return _upsample(samples, frame.max_h // h, frame.max_v // v, frame.height, frame.width,
                     not frame.lossless)


GRAY, YCC, RGB, CMYK, YCCK = range(5)


def _colour(frame: JpegCoefficients) -> int:
    """The colour space libjpeg infers (``jdapimin.c``): one component gray;
    three: JFIF or an Adobe transform 1 YCbCr, an Adobe transform 0 or ids
    'R', 'G', 'B' RGB, otherwise YCbCr (RGB for a lossless frame); four: an
    Adobe transform 2 (or other than 0) YCCK, else CMYK."""
    if len(frame.coef) == 1:
        return GRAY
    if len(frame.coef) == 4:
        return CMYK if frame.adobe_transform in (None, 0) else YCCK
    if frame.jfif:
        return YCC
    if frame.adobe_transform is not None:
        return RGB if frame.adobe_transform == 0 else YCC
    # libjpeg-turbo 3 takes a lossless frame without markers as RGB
    return RGB if frame.ids == [82, 71, 66] or frame.lossless else YCC


def reconstruct(frame: JpegCoefficients, native=None, colour=None) -> np.ndarray:
    """The coefficients -> Pillow's pixels: (H, W, 3) uint8 RGB, (H, W, 1)
    gray, or (H, W, 4) CMYK as Pillow holds it (``CMYK;I``: libjpeg's CMYK,
    YCCK converted by ``ycck_cmyk_convert``, inverted). libjpeg's islow
    IDCT, block smoothing, upsampling and colour conversion. ``native`` as
    in :func:`decode_coefficients`: the C++ reconstruction
    (``jpeg_reconstruct``) or this plain numpy one, equal to the bit.
    ``colour`` (``YCC``, ``RGB``, ...) overrides the colour space libjpeg
    would infer, as a caller setting ``jpeg_color_space`` does (libtiff)."""
    if native is None:
        native = native_available()
    if colour is None:
        colour = _colour(frame)
    if native:
        return _reconstruct_native(frame, colour)
    planes = [_component_samples(frame, i) for i in range(len(frame.coef))]
    if colour == GRAY:
        return planes[0].astype(np.uint8)[..., None]
    if colour in (RGB, CMYK):
        out = np.stack(planes, axis=-1).astype(np.uint8)
    else:
        out = _ycc_to_rgb(*planes[:3])
        if colour == YCCK:
            # ycck_cmyk_convert is 255 - the RGB of Y, Cb, Cr; Pillow's
            # inversion undoes it, and inverts K
            return np.concatenate([out, 255 - planes[3].astype(np.uint8)[..., None]], -1)
    return 255 - out if colour == CMYK else out


def _reconstruct_native(frame: JpegCoefficients, colour: int) -> np.ndarray:
    lib = _native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available (no g++)")
    n = len(frame.coef)
    coefs = frame.coef
    if not frame.lossless and smoothing_wanted(frame):
        coefs = []
        for i, c in enumerate(frame.coef):
            rows, cols = frame.component_size(i)
            out = c.copy()
            quant = np.ascontiguousarray(frame.quant[i].reshape(64), np.int64)
            bits = np.ascontiguousarray(frame.coef_bits[i, :10], np.int32)
            lib.jpeg_smooth(c.ctypes.data, out.ctypes.data, c.shape[1], c.shape[0],
                            -(-rows // 8), -(-cols // 8), frame.raw_sampling[i][1],
                            quant.ctypes.data, bits.ctypes.data)
            coefs.append(out)
    comp = np.array([[frame.max_h // h, frame.max_v // v, coefs[i].shape[1],
                      *frame.component_size(i), int(frame.lossless)]
                     for i, (h, v) in enumerate(frame.sampling)], np.int32)
    quant = np.zeros((n, 64), np.int64)
    if not frame.lossless:
        quant[...] = np.stack([q.reshape(64) for q in frame.quant])
    pointers = _pointers(coefs)
    out = np.empty((frame.height, frame.width, 1 if n == 1 else 4 if n == 4 else 3), np.uint8)
    lib.jpeg_reconstruct(frame.height, frame.width, n, comp.ctypes.data,
                         ctypes.cast(pointers, ctypes.c_void_p), quant.ctypes.data, colour,
                         out.ctypes.data)
    return out


def decode_jpeg(data: bytes, name: str = "<bytes>", native=None) -> np.ndarray:
    """A JPEG file's bytes -> what Pillow (libjpeg-turbo) decodes: (H, W, 3)
    uint8 for a colour file, (H, W, 1) for a grayscale one, (H, W, 4) for a
    CMYK or YCCK one (Pillow's inverted CMYK). Baseline, extended and
    progressive, Huffman or arithmetic coded, lossless (SOF3), restart
    intervals, every sampling libjpeg takes, block smoothing; what libjpeg
    refuses raises a ``ValueError`` naming ``name``. ``native`` as in
    :func:`decode_coefficients`, for both halves."""
    if native is None:
        native = native_available()
    return reconstruct(decode_coefficients(data, name, native), native)


def read_jpeg(path: str, native=None) -> np.ndarray:
    """:func:`decode_jpeg` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), str(path), native)
