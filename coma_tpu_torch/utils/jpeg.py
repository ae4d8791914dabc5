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


def _wrap(x: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return (x + half) % (1 << bits) - half


def _idct_pass(d: np.ndarray, shift: int) -> np.ndarray:
    """One pass of libjpeg-turbo's SIMD ``jsimd_idct_islow`` (the AVX2 and
    SSE2 kernels, bit-exact with ``jpeg_idct_islow`` while values stay in
    range) over the last axis of int16-valued ``d``: the even part's in0 ±
    in4 and the odd part's in7 + in3 and in5 + in1 in 16-bit lanes, the
    products (``pmaddwd``) and sums in 32-bit ones, the descale, and the
    outputs saturated to int16 (``packssdw``)."""
    i0, i1, i2, i3, i4, i5, i6, i7 = (d[..., k] for k in range(8))
    tmp3 = _wrap(i2 * (FIX_0_541196100 + FIX_0_765366865) + i6 * FIX_0_541196100, 32)
    tmp2 = _wrap(i2 * FIX_0_541196100 + i6 * (FIX_0_541196100 - FIX_1_847759065), 32)
    tmp0 = _wrap(i0 + i4, 16) << CONST_BITS
    tmp1 = _wrap(i0 - i4, 16) << CONST_BITS
    tmp10, tmp13 = _wrap(tmp0 + tmp3, 32), _wrap(tmp0 - tmp3, 32)
    tmp11, tmp12 = _wrap(tmp1 + tmp2, 32), _wrap(tmp1 - tmp2, 32)
    z3, z4 = _wrap(i7 + i3, 16), _wrap(i5 + i1, 16)
    z3, z4 = (_wrap(z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602, 32),
              _wrap(z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644), 32))
    t0 = _wrap(_wrap(i7 * (FIX_0_298631336 - FIX_0_899976223) - i1 * FIX_0_899976223, 32) + z3, 32)
    t3 = _wrap(_wrap(-i7 * FIX_0_899976223 + i1 * (FIX_1_501321110 - FIX_0_899976223), 32) + z4,
               32)
    t1 = _wrap(_wrap(i5 * (FIX_2_053119869 - FIX_2_562915447) - i3 * FIX_2_562915447, 32) + z4, 32)
    t2 = _wrap(_wrap(-i5 * FIX_2_562915447 + i3 * (FIX_3_072711026 - FIX_2_562915447), 32) + z3,
               32)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([np.clip(_wrap(_wrap(x, 32) + (1 << (shift - 1)), 32) >> shift, -32768, 32767)
                     for x in out], axis=-1)


def _idct_samples(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Quantised (nby, nbx, 8, 8) blocks and their (8, 8) table -> samples
    (nby*8, nbx*8), as libjpeg-turbo's SIMD islow IDCT gives them: the
    products wrapped to 16 bits (``pmullw``), the columns, then the rows, the
    samples saturated to [-128, 127] and centred. A block whose rows 1-7
    are all zero takes the kernel's shortcut: its columns are the
    dequantised first row shifted left by 2 in 16-bit lanes."""
    coef = np.asarray(coef, np.int64)
    deq = _wrap(coef * np.asarray(table, np.int64), 16)
    ws = _idct_pass(deq.swapaxes(-1, -2), CONST_BITS - PASS1_BITS).swapaxes(-1, -2)  # columns
    flat = ~(coef[..., 1:, :] != 0).any(axis=(-1, -2))
    shortcut = np.broadcast_to(_wrap(deq[..., :1, :] << PASS1_BITS, 16), deq.shape)
    ws = np.where(flat[..., None, None], shortcut, ws)
    out = _idct_pass(ws, CONST_BITS + PASS1_BITS + 3)                                 # rows
    return np.clip(_unblocks(out), -128, 127) + 128


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
    return _idct_samples(coef, table)


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
#
# The file is read as libjpeg-turbo 3.1.3 reads it through Pillow 12.1.0's
# decoder: its markers in order (``jdmarker.c``), then each scan's
# entropy-coded data from where its header ends, with libjpeg's bit buffer,
# restart handling and recovery from corrupt data:
#
# - a marker met inside the data supplies zero bits; once a bit past the data
#   is used, the MCUs left in the restart interval are not decoded
#   (``insufficient_data``), and a restart that stops before a marker other
#   than the expected RSTn keeps that state;
# - a wrong, missing or extra RSTn is met by ``jpeg_resync_to_restart``'s
#   three actions;
# - a Huffman code no table entry starts decodes as symbol 0 after 17 bits;
# - arithmetic-coded data that overflows stops the interval (``ct = -1``);
# - Huffman DC and AC tables 0 and 1 that a sequential frame never defines
#   are the standard ones (``std_huff_tables``);
# - unknown markers, bad lengths and undefined tables are errors, which Pillow
#   raises as "broken data stream"; scan parameters a sequential frame does
#   not use and an inconsistent progression are only warnings.
#
# Pillow hands the file to libjpeg ``CHUNK`` bytes at a time; libjpeg
# suspends where a block runs dry and starts the MCU again with the next. At
# the end of the file it wants more, and Pillow raises "image file is
# truncated", unless a single-scan frame has been decoded whole (Pillow then
# ignores the end of ``jpeg_finish_decompress``). libtiff hands over a
# whole strip and supplies an EOI marker past its end (``libtiff=True``).

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
    0xC7: "hierarchical lossless (SOF7) coding", 0xC8: "the reserved JPG marker",
    0xCB: "arithmetic lossless (SOF11) coding", 0xCD: "arithmetic hierarchical (SOF13) coding",
    0xCE: "arithmetic hierarchical (SOF14) coding",
    0xCF: "arithmetic hierarchical lossless (SOF15) coding",
}
# SOFn read: (progressive, arithmetic, lossless)
_SOF_READ = {0xC0: (False, False, False), 0xC1: (False, False, False),
             0xC2: (True, False, False), 0xC3: (False, False, True),
             0xC9: (False, True, False), 0xCA: (True, True, False)}
_TABLE_BYTES = 1 + 16 + 256        # present, counts of code lengths 1..16, values
CHUNK = 65536                      # Pillow's ImageFile.load reads a file in blocks of this
_MASK64 = (1 << 64) - 1
_MIN_GET_BITS = 57                 # libjpeg-turbo's 64-bit buffer filled to 64 - 7 bits


def _spec(counts: list, values: bytes) -> np.ndarray:
    row = np.zeros(_TABLE_BYTES, np.uint8)
    row[0], row[1:17] = 1, counts
    row[17:17 + len(values)] = np.frombuffer(values, np.uint8)
    return row


# jstdhuff.c's tables (JPEG Annex K.3): DC 0, DC 1, AC 0, AC 1
_STD_TABLES = {
    0: _spec([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    1: _spec([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    4: _spec([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0243362"
        "7282090a161718191a25262728292a3435363738393a434445464748494a535455565758"
        "595a636465666768696a737475767778797a838485868788898a92939495969798999aa2"
        "a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1"
        "e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    5: _spec([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272"
        "d10a162434e125f11718191a262728292a35363738393a434445464748494a5354555657"
        "58595a636465666768696a737475767778797a82838485868788898a9293949596979899"
        "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9"
        "dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


class JpegCoefficients:
    """A JPEG file's frame and its quantised DCT coefficients after every
    scan: ``coef[i]`` is component i's (block rows, blocks per row, 64) int16
    array in natural order, padded to whole MCUs; ``quant[i]`` its (8, 8)
    table (latched at the component's first scan, as libjpeg does; None for
    a component no scan names, whose blocks stay zero). A lossless (SOF3)
    frame holds samples instead: ``coef[i]`` is (rows, columns) int32, padded
    to whole MCUs, undifferenced scan by scan."""

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
        # coef_bits before each component's latest progressive scan, the scans
        # read, and the last iMCU row the latest scan began with data in hand
        # (libjpeg smooths the rows below it with the earlier bits)
        self.prev_bits = np.full((len(components), 64), -1)
        self.scans = 0
        self.last_good = 0
        self.jfif = False
        self.adobe_transform = None
        self.resync_failed = None      # the MCU where a resync was refused (``resync=False``)
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

    def imcu_row(self, m: int) -> int:
        """The iMCU row of MCU ``m`` (libjpeg's ``input_iMCU_row``)."""
        if len(self.comps) > 1:
            return m // self.frame.mcus_x
        return m // self.mcus_per_row() // self.frame.raw_sampling[self.comps[0]][1]

    def mcus_per_row(self) -> int:
        f = self.frame
        if len(self.comps) == 1:
            return -(-f.component_size(self.comps[0])[1] // (1 if f.lossless else 8))
        return f.mcus_x

    def uses(self) -> tuple:
        """Whether the scan decodes DC and AC symbols with Huffman tables."""
        f = self.frame
        if f.lossless:
            return True, False
        if not f.progressive:
            return True, True
        return self.ss == 0 and self.ah == 0, self.ss > 0


# ------------------------------------------------------------------ the input

class _Suspend(Exception):
    """libjpeg's source ran dry inside an MCU: it is decoded again from its
    start once Pillow has handed over the next block."""


class _Truncated(ValueError):
    """The file ends where libjpeg wants more bytes."""


class _NoResync(ValueError):
    """A marker other than the RSTn due where the source allows no resync."""


class _Source:
    """The bytes libjpeg's data source hands it, from ``pos``. ``end`` is the
    end of what Pillow has handed over so far; ``unread`` libjpeg's
    ``unread_marker``; ``restart`` the RSTn expected next."""

    __slots__ = ("data", "size", "name", "pos", "end", "unread", "restart", "libtiff", "resync")

    def __init__(self, data: bytes, name: str, libtiff: bool, resync: bool = True):
        self.data, self.size, self.name, self.libtiff = data, len(data), name, libtiff
        self.resync = resync
        self.pos = self.unread = self.restart = 0
        self.end = self.size if libtiff else min(self.size, CHUNK)

    def byte(self, in_mcu: bool = False) -> int:
        """``INPUT_BYTE``: past ``end`` libjpeg suspends (inside an MCU the
        MCU starts again); past the file, Pillow's file is truncated and
        libtiff's source supplies FF D9."""
        p = self.pos
        if p >= self.end:
            if self.libtiff:
                self.pos = p + 1
                return 0xFF if (p - self.size) % 2 == 0 else 0xD9
            if self.end >= self.size:
                raise _Truncated(f"{self.name}: the file ends where libjpeg wants more data "
                                 "(truncated)")
            self.end = min(self.end + CHUNK, self.size)
            if in_mcu:
                raise _Suspend
        self.pos = p + 1
        return self.data[p]

    def arith_byte(self) -> int:
        """``jdarith.c get_byte``: libjpeg cannot suspend there."""
        if self.pos >= self.end and not self.libtiff:
            where = "end of the file" if self.end >= self.size else "bytes Pillow hands over"
            raise ValueError(f"{self.name}: arithmetic-coded data runs past the {where} "
                             "(libjpeg cannot suspend there)")
        return self.byte()

    def u16(self) -> int:
        """``INPUT_2BYTES``."""
        high = self.byte()
        return high << 8 | self.byte()

    def take(self, n: int) -> bytes:
        """``n`` bytes (``INPUT_BYTE`` n times; a skip)."""
        if self.libtiff and self.pos + n > self.size:
            return bytes(self.byte() for _ in range(n))
        while self.pos + n > self.end:
            if self.end >= self.size:
                raise _Truncated(f"{self.name}: the file ends inside a marker segment "
                                 "(truncated)")
            self.end = min(self.end + CHUNK, self.size)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def next_marker(self, can_suspend: bool = True) -> None:
        """``next_marker``: skip to the next marker, past stuffed FF 00."""
        get = self.byte if can_suspend else self.arith_byte
        while True:
            c = get()
            while c != 0xFF:
                c = get()
            c = get()
            while c == 0xFF:
                c = get()
            if c:
                break
        self.unread = c

    def read_restart_marker(self, can_suspend: bool = True) -> None:
        """``read_restart_marker`` and ``jpeg_resync_to_restart``."""
        if not self.unread:
            self.next_marker(can_suspend)
        desired = self.restart
        if self.unread == 0xD0 + desired:
            self.unread = 0
        else:
            if not self.resync:
                raise _NoResync(f"{self.name}: {_NATIVE_ERRORS[3]}")
            marker = self.unread
            while True:
                if marker < 0xC0:
                    action = 2                      # not a marker libjpeg knows: skip it
                elif not 0xD0 <= marker <= 0xD7:
                    action = 3                      # a marker: the interval is empty
                elif marker in (0xD0 + (desired + 1) % 8, 0xD0 + (desired + 2) % 8):
                    action = 3                      # one of the next two RSTn
                elif marker in (0xD0 + (desired - 1) % 8, 0xD0 + (desired - 2) % 8):
                    action = 2                      # an earlier RSTn: skip ahead
                else:
                    action = 1                      # take it as the expected one
                if action == 1:
                    self.unread = 0
                    break
                if action == 3:
                    break
                self.next_marker(can_suspend)
                marker = self.unread
        self.restart = (desired + 1) % 8


# ------------------------------------------------------------- Huffman coding

class _Table:
    """``jpeg_make_d_derived_tbl``: the 8-bit lookahead (``(length << 8) |
    symbol``, 9 << 8 for a longer code) and the canonical walk's tables."""

    __slots__ = ("look", "maxcode", "valoffset", "huffval")


def _derive(tables: np.ndarray, which: int, dc: bool, lossless: bool, name: str) -> _Table:
    kind = "DC" if dc else "AC"
    if which > 3 or not tables[which + (0 if dc else 4)][0]:
        raise ValueError(f"{name}: a scan uses {kind} Huffman table {which}, never defined")
    spec = tables[which + (0 if dc else 4)]
    counts = [int(x) for x in spec[1:17]]
    n = sum(counts)
    huffval = [int(x) for x in spec[17:17 + n]] + [0] * (256 - n)
    sizes = [length for length in range(1, 17) for _ in range(counts[length - 1])]
    codes, code, p = [], 0, 0
    si = sizes[0] if sizes else 0
    while p < n:
        while p < n and sizes[p] == si:
            codes.append(code)
            code, p = code + 1, p + 1
        if code >= 1 << si:
            raise ValueError(f"{name}: a bad Huffman table ({kind} {which}: more codes than "
                             "fit)")
        code, si = code << 1, si + 1
    if dc and any(v > (16 if lossless else 15) for v in huffval[:n]):
        raise ValueError(f"{name}: a bad Huffman table ({kind} {which}: a symbol above "
                         f"{16 if lossless else 15})")
    t = _Table()
    t.maxcode, t.valoffset, t.huffval = [0] * 18, [0] * 18, huffval
    p = 0
    for length in range(1, 17):
        if counts[length - 1]:
            t.valoffset[length] = p - codes[p]
            p += counts[length - 1]
            t.maxcode[length] = codes[p - 1]
        else:
            t.maxcode[length] = -1
    t.maxcode[17] = 0xFFFFF
    t.look = [9 << 8] * 256
    p = 0
    for length in range(1, 9):
        for _ in range(counts[length - 1]):
            first = codes[p] << (8 - length)
            t.look[first:first + (1 << (8 - length))] = \
                [length << 8 | huffval[p]] * (1 << (8 - length))
            p += 1
    return t


class _Bits:
    """libjpeg-turbo's bit reader (``jdhuff.c``/``jdhuff.h``): a 64-bit
    buffer of ``left`` bits, filled to 57 at need (``jpeg_fill_bit_buffer``)
    or by six bytes when it holds 16 or fewer (``decode_mcu_fast``); zeros
    past a marker, and ``insufficient`` once a bit past the data is used."""

    __slots__ = ("src", "buf", "left", "insufficient")

    def __init__(self, src: _Source):
        self.src, self.buf, self.left, self.insufficient = src, 0, 0, False

    def fill(self, nbits: int) -> None:
        src = self.src
        if not src.unread:
            while self.left < _MIN_GET_BITS:
                c = src.byte(True)
                if c == 0xFF:
                    c = src.byte(True)
                    while c == 0xFF:
                        c = src.byte(True)
                    if c:
                        src.unread = c
                        break
                    c = 0xFF
                self.buf = (self.buf << 8 | c) & _MASK64
                self.left += 8
            else:
                return
        if nbits > self.left:
            self.insufficient = True
            self.buf = self.buf << (_MIN_GET_BITS - self.left) & _MASK64
            self.left = _MIN_GET_BITS

    def fill_fast(self) -> None:
        if self.left > 16:
            return
        src, buf = self.src, self.buf
        d, p = src.data, src.pos
        for _ in range(6):
            c0, c1 = d[p], d[p + 1]
            p += 1
            buf = buf << 8 | c0
            if c0 == 0xFF:
                p += 1
                if c1:                       # a marker: zeros, and the MCU again slowly
                    src.unread = c1
                    p -= 2
                    buf &= ~0xFF
        self.buf, self.left, src.pos = buf & _MASK64, self.left + 48, p

    def get(self, n: int) -> int:
        if self.left < n:
            self.fill(n)
        self.left -= n
        return self.buf >> self.left & ((1 << n) - 1)

    def get_fast(self, n: int) -> int:
        self.fill_fast()
        self.left -= n
        return self.buf >> self.left & ((1 << n) - 1)

    def decode(self, t: _Table) -> int:
        """``HUFF_DECODE`` and ``jpeg_huff_decode``."""
        if self.left < 8:
            self.fill(0)
            if self.left < 8:
                return self._walk(t, 1)
        e = t.look[self.buf >> (self.left - 8) & 0xFF]
        if e >> 8 <= 8:
            self.left -= e >> 8
            return e & 0xFF
        return self._walk(t, 9)

    def _walk(self, t: _Table, length: int) -> int:
        code = self.get(length)
        while code > t.maxcode[length]:
            code = code << 1 | self.get(1)
            length += 1
        return 0 if length > 16 else t.huffval[code + t.valoffset[length]]

    def decode_fast(self, t: _Table) -> int:
        """``HUFF_DECODE_FAST``."""
        self.fill_fast()
        e = t.look[self.buf >> (self.left - 8) & 0xFF]
        nb = e >> 8
        self.left -= nb
        if nb <= 8:
            return e & 0xFF
        s = self.buf >> self.left & ((1 << nb) - 1)
        while s > t.maxcode[nb]:
            self.left -= 1
            s = s << 1 | (self.buf >> self.left & 1)
            nb += 1
        return 0 if nb > 16 else t.huffval[(s + t.valoffset[nb]) & 0xFF]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _wrap16(x: int) -> int:
    """C's conversion of an int to ``JCOEF`` (int16)."""
    return (x + 0x8000) % 0x10000 - 0x8000


def _sequential_mcu(bits: _Bits, fast: bool, mcu: list, coefs: list, dc: list, ac: list,
                    pred: list) -> None:
    """``decode_mcu_fast`` / ``decode_mcu_slow``."""
    decode, get = (bits.decode_fast, bits.get_fast) if fast else (bits.decode, bits.get)
    nat = _NATURAL_LIST
    for j, blk in mcu:
        c, base = coefs[j], blk * 64
        s = decode(dc[j])
        if s:
            s = _extend(get(s), s)
        pred[j] += s
        c[base] = _wrap16(pred[j])
        k, table = 1, ac[j]
        while k < 64:
            rs = decode(table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                c[base + nat[k]] = _extend(get(s), s)
            elif r != 15:
                break
            else:
                k += 15
            k += 1


def _progressive_mcu(bits: _Bits, scan: _ScanSpec, mcu: list, coefs: list, dc: list,
                     ac: _Table, state: list) -> None:
    """``jdphuff.c``'s four MCU decoders; ``state`` is the DC predictions
    then the end-of-band run."""
    ss, se, ah, al, nat = scan.ss, scan.se, scan.ah, scan.al, _NATURAL_LIST
    p1, m1 = 1 << al, -1 << al
    if ss == 0:
        for j, blk in mcu:
            c, base = coefs[j], blk * 64
            if ah == 0:
                s = bits.decode(dc[j])
                if s:
                    s = _extend(bits.get(s), s)
                state[j] += s
                c[base] = _wrap16(state[j] << al)
            elif bits.get(1):
                c[base] = c[base] | p1
        return
    c, base = coefs[0], mcu[0][1] * 64
    if ah == 0:                                                # AC first
        if state[-1] > 0:
            state[-1] -= 1
            return
        k = ss
        while k <= se:
            rs = bits.decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                c[base + nat[k]] = _wrap16(_extend(bits.get(s), s) << al)
            elif r == 15:
                k += 15
            else:
                state[-1] = (1 << r) + (bits.get(r) if r else 0) - 1
                break
            k += 1
        return
    k, eobrun, newly = ss, state[-1], []                       # AC refine
    try:
        if eobrun == 0:
            while k <= se:
                rs = bits.decode(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.get(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (bits.get(r) if r else 0)
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
                    newly.append(base + nat[k])
                k += 1
        if eobrun > 0:
            while k <= se:
                pos = base + nat[k]
                if c[pos] != 0 and bits.get(1) and c[pos] & p1 == 0:
                    c[pos] += p1 if c[pos] >= 0 else m1
                k += 1
            eobrun -= 1
    except _Suspend:
        for pos in newly:                   # libjpeg undoes the newly nonzero ones
            c[pos] = 0
        raise
    state[-1] = eobrun


def _huffman_scan(scan: _ScanSpec, src: _Source) -> None:
    """A Huffman-coded scan: ``jdhuff.c`` (sequential, with its fast path)
    and ``jdphuff.c`` (progressive), written into ``scan.frame.coef``."""
    f, name = scan.frame, scan.frame.name
    need_dc, need_ac = scan.uses()
    dc = [_derive(scan.tables, t, True, False, name) if need_dc else None for t in scan.dc_ids]
    ac = [_derive(scan.tables, t, False, False, name) if need_ac else None for t in scan.ac_ids]
    coefs = [memoryview(f.coef[ci]).cast("B").cast("h") for ci in scan.comps]
    units = scan.units()
    blocks = len(units[0]) if units else 0
    restart, to_go = scan.restart, scan.restart
    bits = _Bits(src)
    state = [0] * (len(scan.comps) + 1)             # DC predictions, then the EOB run
    refine_dc = f.progressive and scan.ss == 0 and scan.ah > 0
    for m, mcu in enumerate(units):
        if not bits.insufficient:
            f.last_good = scan.imcu_row(m)
        if restart and to_go == 0:                  # process_restart
            bits.left = 0
            try:
                src.read_restart_marker()
            except _NoResync:
                f.resync_failed = m                 # the caller keeps what came before
                return
            state = [0] * len(state)
            to_go = restart
            if not src.unread:
                bits.insufficient = False
        while True:
            saved = (bits.buf, bits.left, src.pos, src.unread, state[:])
            try:
                if bits.insufficient and not refine_dc:
                    pass                            # the rest of the interval stays as it was
                elif f.progressive:
                    _progressive_mcu(bits, scan, mcu, coefs, dc, ac[0], state)
                elif not restart and not src.unread and src.end - src.pos >= 512 * blocks:
                    _sequential_mcu(bits, True, mcu, coefs, dc, ac, state)
                    if src.unread:                  # the fast path met a marker
                        bits.buf, bits.left, src.pos, _, state[:] = saved
                        src.unread = 0
                        _sequential_mcu(bits, False, mcu, coefs, dc, ac, state)
                else:
                    _sequential_mcu(bits, False, mcu, coefs, dc, ac, state)
                break
            except _Suspend:
                bits.buf, bits.left, src.pos, src.unread, state[:] = saved
        to_go -= 1


# -------------------------------------------------------- arithmetic coding

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


class _BadArith(Exception):
    """``JWRN_ARITH_BAD_CODE``: libjpeg sets ``ct = -1`` and decodes nothing
    more until the next restart."""


class _ArithDecoder:
    """``jdarith.c``'s ``arith_decode``: the QM decoder reading the scan's
    bytes (stuffing removed), zeros once it meets a marker."""

    __slots__ = ("src", "c", "a", "ct")

    def __init__(self, src: _Source):
        self.src, self.c, self.a, self.ct = src, 0, 0, -16

    def bit(self, stats: bytearray, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:                       # renormalisation and input, D.2.6
            ct -= 1
            if ct < 0:
                src = self.src
                if src.unread:
                    byte = 0
                else:
                    byte = src.arith_byte()
                    if byte == 0xFF:
                        byte = src.arith_byte()
                        while byte == 0xFF:
                            byte = src.arith_byte()
                        if byte:
                            src.unread, byte = byte, 0
                        else:
                            byte = 0xFF
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


def _arith_value(dec: _ArithDecoder, stats: bytearray, st: int, sign: int, big: int) -> int:
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
                    raise _BadArith
                st += 1
    v = m
    st += 14
    while m > 1:
        m >>= 1
        if dec.bit(stats, st):
            v |= m
    v += 1
    return -v if sign else v


def _arith_dc_diff(dec, stats: bytearray, ctx: list, j: int, lo: int, hi: int) -> int:
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
                raise _BadArith
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


def _arith_ac(dec, stats: bytearray, fixed: bytearray, k: int, se: int, kx: int):
    """Figure F.20 from position ``k``: None at an end of block, else
    (position, value) of the next nonzero coefficient."""
    st = 3 * (k - 1)
    if dec.bit(stats, st):
        return None
    while dec.bit(stats, st + 1) == 0:
        st += 3
        k += 1
        if k > se:
            raise _BadArith
    sign = dec.bit(fixed, 0)
    return k, _arith_value(dec, stats, st + 2, sign, 189 if k <= kx else 217)


def _arith_mcu(dec: _ArithDecoder, scan: _ScanSpec, mcu: list, coefs: list, st: dict) -> None:
    """``jdarith.c``'s MCU decoders (sequential and the four progressive
    ones); ``st`` holds the statistics, predictions and contexts."""
    f, nat = scan.frame, _NATURAL_LIST
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -1 << al
    sequential = not f.progressive
    pred, ctx, fixed = st["pred"], st["ctx"], st["fixed"]
    for j, blk in mcu:
        c, base = coefs[j], blk * 64
        if sequential or (ss == 0 and ah == 0):                # DC
            t = scan.dc_ids[j]
            diff = _arith_dc_diff(dec, st["dc"][t], ctx, j, f.dc_l[t], f.dc_u[t])
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
            stats, kx = st["ac"][t], f.ac_k[t]
            k, last = (1, 63) if sequential else (ss, se)
            while k <= last:
                hit = _arith_ac(dec, stats, fixed, k, last, kx)
                if hit is None:
                    break
                k, v = hit
                c[base + nat[k]] = v if sequential else _wrap16(v << al)
                k += 1
        elif ss > 0:                                           # AC refine
            stats = st["ac"][scan.ac_ids[j]]
            kex = se
            while kex > 0 and c[base + nat[kex]] == 0:
                kex -= 1
            k = ss
            while k <= se:
                s = 3 * (k - 1)
                if k > kex and dec.bit(stats, s):
                    break
                while True:
                    pos = base + nat[k]
                    if c[pos]:
                        if dec.bit(stats, s + 2):
                            c[pos] += m1 if c[pos] < 0 else p1
                        break
                    if dec.bit(stats, s + 1):
                        c[pos] = m1 if dec.bit(fixed, 0) else p1
                        break
                    s += 3
                    k += 1
                    if k > se:
                        raise _BadArith
                k += 1


def _arith_scan(scan: _ScanSpec, src: _Source) -> None:
    """An arithmetic-coded scan (``jdarith.c``): statistics reset per scan
    and restart interval, DC and AC conditioning from DAC."""
    f = scan.frame
    coefs = [memoryview(f.coef[ci]).cast("B").cast("h") for ci in scan.comps]
    restart, to_go = scan.restart, scan.restart
    dec = _ArithDecoder(src)

    def fresh():
        return dict(dc={t: bytearray(64) for t in scan.dc_ids},
                    ac={t: bytearray(256) for t in scan.ac_ids}, fixed=bytearray([_FIXED_BIN]),
                    pred=[0] * len(scan.comps), ctx=[0] * len(scan.comps))

    st = fresh()
    units = scan.units()
    f.last_good = scan.imcu_row(len(units) - 1) if units else 0
    for mcu in units:
        if restart:
            if to_go == 0:                          # process_restart
                src.read_restart_marker(can_suspend=False)
                st = fresh()
                dec.c, dec.a, dec.ct = 0, 0, -16
                to_go = restart
            to_go -= 1
        if dec.ct == -1:
            continue
        try:
            _arith_mcu(dec, scan, mcu, coefs, st)
        except _BadArith:
            dec.ct = -1


# ------------------------------------------------------------------ lossless

def _lossless_scan(scan: _ScanSpec, src: _Source) -> None:
    """A lossless scan: ``jdlhuff.c``'s sample differences, an MCU row at a
    time (a row that starts with the data run out is zeros, predicted
    afresh), then ``jdlossls.c``'s undifferencing and point transform."""
    f, name = scan.frame, scan.frame.name
    tables = [_derive(scan.tables, t, True, True, name) for t in scan.dc_ids]
    diffs = [np.zeros(f.coef[ci].shape, np.int64) for ci in scan.comps]
    flat = [d.reshape(-1) for d in diffs]
    units = scan.units()
    f.last_good = scan.imcu_row(len(units) - 1) if units else 0
    per_row = scan.mcus_per_row()
    rows = len(units) // per_row
    restart_rows = _restart_rows(scan)
    fresh = np.zeros(rows, bool)                # MCU rows predicted as a first row
    bits, to_go = _Bits(src), restart_rows
    for r in range(rows):
        if r == 0:
            fresh[r] = True
        if restart_rows:
            if to_go == 0:                      # process_restart; the predictors start again
                bits.left = 0
                src.read_restart_marker()
                to_go = restart_rows
                if not src.unread:
                    bits.insufficient = False
                fresh[r] = True
            to_go -= 1
        if bits.insufficient:                   # zero differences, predicted afresh
            fresh[r] = True
            continue
        for mcu in units[r * per_row:(r + 1) * per_row]:
            while True:
                saved = (bits.buf, bits.left, src.pos)
                try:
                    for j, idx in mcu:
                        s = bits.decode(tables[j])
                        flat[j][idx] = 32768 if s == 16 else (_extend(bits.get(s), s) if s else 0)
                    break
                except _Suspend:
                    bits.buf, bits.left, src.pos = saved
    for j, ci in enumerate(scan.comps):
        v = 1 if len(scan.comps) == 1 else f.sampling[ci][1]
        f.coef[ci][...] = _undifference(diffs[j], f.component_size(ci), np.repeat(fresh, v), v,
                                        scan.ss, scan.al)


def _restart_rows(scan: _ScanSpec) -> int:
    """MCU rows per restart interval of a lossless scan (0: none); libjpeg
    takes only whole rows of MCUs."""
    if not scan.restart:
        return 0
    per_row = scan.mcus_per_row()
    if scan.restart % per_row:
        raise ValueError(f"{scan.frame.name}: a lossless restart interval of {scan.restart} MCUs "
                         f"is not a whole number of MCU rows ({per_row})")
    return scan.restart // per_row


def _undifference(diff: np.ndarray, size: tuple, fresh: np.ndarray, v: int, predictor: int,
                  pt: int) -> np.ndarray:
    """Differences (padded) -> samples: prediction with ``predictor`` 1-7
    (the first row of each MCU row ``fresh[y // v]`` from the left), sums
    modulo 2^16, then ``<< pt`` truncated to 8 bits."""
    rows, cols = size
    out = np.zeros(diff.shape, np.int32)
    d = diff.tolist()
    prev = None
    for y in range(rows):
        row, cur = d[y], [0] * cols
        if fresh[y] and y % v == 0:
            ra = (row[0] + (1 << (7 - pt))) & 0xFFFF        # a first row: from the left
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


# -------------------------------------------------------------------- native

def _declare(lib: ctypes.CDLL) -> None:
    scan_args = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,   # data, size, tiff, state
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # MCUs x, y, RI, comps
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                # comp, coef, tables
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Ss, Se, Ah, Al
        ctypes.c_int,                                                     # progressive
    ]
    for fn in (lib.jpeg_decode_scan, lib.jpeg_decode_scan_arith, lib.jpeg_decode_scan_lossless):
        fn.restype = ctypes.c_int
        fn.argtypes = scan_args
    lib.jpeg_smooth.restype = None
    lib.jpeg_smooth.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # in, out, bw, rows held
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                       # hb, wb, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,                 # quant, bits, row
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


# the native decoders' statuses; a negative one names a table: -(1 + 4 * kind + table),
# kind 0 an undefined DC table, 1 an undefined AC table, 2 a bad DC table, 3 a bad AC table
_NATIVE_ERRORS = {1: "the file ends where libjpeg wants more data (truncated)",
                  2: "arithmetic-coded data runs past the bytes libjpeg is handed (libjpeg "
                     "cannot suspend there)",
                  3: "a restart marker out of place (libtiff's old-style JPEG reader fails "
                     "where libjpeg would resynchronise)"}


def _native_error(status: int) -> str:
    if status > 0:
        return _NATIVE_ERRORS.get(status, f"status {status}")
    kind, table = divmod(-status - 1, 4)
    if kind < 2:
        return f"a scan uses {'AC' if kind else 'DC'} Huffman table {table}, never defined"
    return f"a bad Huffman table ({'AC' if kind == 3 else 'DC'} {table})"


def _entropy_native(scan: _ScanSpec, src: _Source) -> None:
    """The C++ entropy decoders of ``native/src/jpeg_decode.cpp``: Huffman,
    arithmetic or lossless as the frame is coded, reading the file from
    ``src.pos`` as :func:`_huffman_scan`, :func:`_arith_scan` and
    :func:`_lossless_scan` do, and leaving ``src`` where libjpeg leaves it.
    For a lossless scan the comp rows carry (rows, columns, restart rows)
    and the predictor rides in Ss, the point transform in Al."""
    lib = _native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available (no g++)")
    f = scan.frame
    unit = 1 if f.lossless else 8
    restart_rows = _restart_rows(scan) if f.lossless else 0
    comp = np.array([[*f.sampling[ci], f.coef[ci].shape[1],
                      *(-(-n // unit) for n in f.component_size(ci)[::-1]), d, a,
                      *f.component_size(ci), restart_rows]
                     for ci, d, a in zip(scan.comps, scan.dc_ids, scan.ac_ids)], np.int32)
    if f.lossless:
        for ci in scan.comps:
            f.coef[ci][...] = 0
    pointers = _pointers([f.coef[ci] for ci in scan.comps])
    if f.arithmetic:
        tables = np.array(f.dc_l + f.dc_u + f.ac_k, np.int32)
        fn = lib.jpeg_decode_scan_arith
    else:
        tables = np.ascontiguousarray(scan.tables, np.uint8)
        fn = lib.jpeg_decode_scan_lossless if f.lossless else lib.jpeg_decode_scan
    state = np.array([src.pos, src.end, src.unread, src.restart, -1], np.int64)
    data = np.frombuffer(src.data, np.uint8) if src.size else np.zeros(1, np.uint8)
    status = fn(data.ctypes.data, src.size, int(src.libtiff) + int(not src.resync),
                state.ctypes.data, f.mcus_x,
                f.mcus_y, scan.restart, len(scan.comps), comp.ctypes.data,
                ctypes.cast(pointers, ctypes.c_void_p), tables.ctypes.data, scan.ss, scan.se,
                scan.ah, scan.al, int(f.progressive))
    src.pos, src.end, src.unread, src.restart = (int(x) for x in state[:4])
    n_units = len(scan.units()) if f.arithmetic or state[4] < 0 else 0
    f.last_good = scan.imcu_row(int(state[4]) if state[4] >= 0 else max(n_units - 1, 0))
    if status == 1:
        raise _Truncated(f"{f.name}: {_native_error(status)}")
    if status == 3 and not (f.arithmetic or f.lossless):
        f.resync_failed = int(state[4])
        return
    if status:
        raise ValueError(f"{f.name}: {_native_error(status)}")


def _pointers(arrays: list):
    """A C array of pointers to C-contiguous coefficient (int16) or
    lossless sample (int32) arrays."""
    for a in arrays:
        if a.dtype not in (np.int16, np.int32) or not a.flags.c_contiguous:
            raise ValueError(f"coefficients must be C-contiguous int16, got {a.dtype}")
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


# ------------------------------------------------------------------ markers

def _pillow_header(data: bytes, name: str) -> None:
    """The checks of Pillow's own parse of the markers before the first SOS
    (``JpegImagePlugin._open``, whose refusal Pillow raises before libjpeg
    sees the file): a marker code it does not know, segments cut short, a
    frame header it cannot read, a short quantisation table, a JFIF or
    Adobe segment too short for its fields."""
    def refuse(why: str):
        raise ValueError(f"{name}: {why} (Pillow's JPEG parse refuses it)")

    n, pos, s, size = len(data), 3, b"\xff", [0, 0]
    while True:
        if not s:
            refuse("the file ends before a start of scan")
        if s[0] != 0xFF:
            s, pos = data[pos:pos + 1], min(pos + 1, n)
            continue
        s, pos = s + data[pos:pos + 1], min(pos + 1, n)
        if len(s) < 2:
            refuse("the file ends inside a marker")
        marker = s[1]
        if 0xC0 <= marker <= 0xFE:
            if marker not in (0xC8, 0xD8, 0xD9) and not 0xD0 <= marker <= 0xD7 \
                    and not 0xF0 <= marker <= 0xFD:
                if pos + 2 > n:
                    refuse("the file ends inside a marker")
                length = (data[pos] << 8 | data[pos + 1]) - 2
                pos += 2
                if length > 0:
                    if pos + length > n:
                        refuse(f"marker 0x{marker:02X} runs past the end of the file")
                    body, pos = data[pos:pos + length], pos + length
                else:
                    body = b""
                _pillow_segment(marker, body, refuse, size)
            if marker == 0xDA:
                if size[0] * size[1] > 2 * 89478485:
                    refuse(f"a frame of {size[0]} x {size[1]} pixels (a decompression bomb)")
                return
            s, pos = data[pos:pos + 1], min(pos + 1, n)
        elif marker == 0xFF:
            s = b"\xff"
        elif marker == 0x00:
            s, pos = data[pos:pos + 1], min(pos + 1, n)
        else:
            refuse(f"no marker found (0xFF{marker:02X})")


def _pillow_segment(marker: int, s: bytes, refuse, size: list) -> None:
    """Pillow's handler of one segment: the reads that raise; a frame
    header's size into ``size``."""
    if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF,
                  0xDE):
        if len(s) < 5:
            refuse("a frame header too short for its size")
        if s[0] != 8:
            refuse(f"{s[0]}-bit samples")
        if len(s) < 6 or s[5] not in (1, 3, 4):
            refuse(f"a frame of {s[5] if len(s) > 5 else 'no'} layers")
        size[:] = (s[1] << 8 | s[2], s[3] << 8 | s[4])
    elif marker == 0xDB:
        while s:
            size = 1 + (64 if s[0] < 16 else 128)
            if len(s) < size:
                refuse("a bad quantization table marker")
            s = s[size:]
    elif marker == 0xE0 and s.startswith(b"JFIF") and len(s) < 7:
        refuse("a JFIF segment too short for its version")
    elif marker == 0xEE and s.startswith(b"Adobe") and len(s) < 7:
        refuse("an Adobe segment too short for its version")
    elif marker == 0xED and s.startswith(b"Photoshop 3.0\x00"):
        offset = 14
        while s[offset:offset + 4] == b"8BIM":
            offset += 4
            if offset + 2 > len(s):
                break
            offset += 2
            if offset >= len(s):
                refuse("a Photoshop resource cut inside its name")
            offset += 1 + s[offset]
            offset += offset & 1
            if offset + 4 > len(s):
                break
            size = int.from_bytes(s[offset:offset + 4], "big")
            offset += 4
            offset += size
            offset += offset & 1


def decode_coefficients(data: bytes, name: str = "<bytes>", native=None,
                        libtiff: bool = False, tables_stream=None,
                        resync: bool = True) -> JpegCoefficients:
    """Parse a JPEG file and entropy-decode every scan, as libjpeg-turbo
    reads it through Pillow. ``libtiff=True``: as libtiff's JPEG codec hands
    it a strip, after the abbreviated stream of its JPEGTables tag
    (``tables_stream``), which must hold tables only; an error past the
    scan's last line is then ignored, as libtiff ignores what
    ``jpeg_finish_decompress`` raises; ``resync=False``: a wrong marker
    where a restart marker is due fails, as libtiff's old-style JPEG source
    makes libjpeg's resync do, and decoding stops there with the MCU in
    ``resync_failed``. ``native``: True the C++ decoder,
    False the plain Python one, None the C++ one where it builds. What
    Pillow or libjpeg-turbo refuses (hierarchical, arithmetic lossless,
    12-bit, sampling ratios that are not whole numbers, unknown markers, bad
    lengths or tables, a file cut short) raises a ``ValueError`` naming
    ``name`` and the cause, as Pillow raises; corrupt entropy-coded data is
    recovered as libjpeg recovers it."""
    if native is None:
        native = native_available()
    if not libtiff:
        if data[:3] != b"\xff\xd8\xff":
            raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
        _pillow_header(data, name)
    streams = [data] if tables_stream is None else [bytes(tables_stream), data]
    src = _Source(streams.pop(0), name, libtiff, resync)
    in_tables = tables_stream is not None
    frame, quant, restart, jfif, adobe = None, {}, 0, False, None
    tables = np.zeros((8, _TABLE_BYTES), np.uint8)
    conditioning = ([0] * 16, [1] * 16, [5] * 16)          # DAC: DC L, DC U, AC K
    saw_soi, scans, single, complete = False, 0, False, False
    while True:
        try:
            if not src.unread:
                if not saw_soi:                            # first_marker
                    if (src.byte(), src.byte()) != (0xFF, 0xD8):
                        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
                    src.unread = 0xD8
                else:
                    src.next_marker()
            marker, src.unread = src.unread, 0
            if marker == 0xD8:
                if saw_soi:
                    raise ValueError(f"{name}: a second SOI marker")
                saw_soi, restart, jfif, adobe = True, 0, False, None
                conditioning = ([0] * 16, [1] * 16, [5] * 16)
            elif marker == 0xD9:
                if scans:
                    break
                if frame is not None:
                    raise ValueError(f"{name}: a frame header and no scan")
                saw_soi = False                            # a tables-only datastream
                if in_tables:                              # libtiff's JPEGTables: the strip next
                    src, in_tables = _Source(streams.pop(0), name, libtiff), False
            elif 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue                                   # RSTn, TEM: no body
            elif marker == 0xDA:
                if frame is None:
                    raise ValueError(f"{name}: a scan before the frame header")
                length, count = src.u16(), src.byte()          # get_sos
                if length != 2 * count + 6 or not 1 <= count <= 4:
                    raise ValueError(f"{name}: a bad scan header")
                body = bytes([count]) + src.take(2 * count + 3)
                if in_tables:
                    raise ValueError(f"{name}: a bogus JPEGTables field (a scan in it)")
                if single:
                    raise ValueError(f"{name}: a second scan in a single-scan frame")
                if not scans:
                    frame.jfif, frame.adobe_transform = jfif, adobe
                    frame.dc_l, frame.dc_u, frame.ac_k = conditioning
                    if not (frame.progressive or frame.arithmetic or frame.lossless):
                        for t, row in _STD_TABLES.items():     # std_huff_tables
                            if not tables[t][0]:
                                tables[t] = row
                frame.scans += 1
                scan = _scan(body, frame, quant, restart, tables.copy(), name)
                if not scans:
                    single = len(scan.comps) == len(frame.ids) and not frame.progressive
                scans += 1
                src.restart = 0
                if native:
                    _entropy_native(scan, src)
                elif frame.lossless:
                    _lossless_scan(scan, src)
                elif frame.arithmetic:
                    _arith_scan(scan, src)
                else:
                    _huffman_scan(scan, src)
                if frame.resync_failed is not None:
                    break                   # the caller takes the rows decoded before it
                complete = single
            elif marker in _SOF_REFUSED:
                raise ValueError(f"{name}: {_SOF_REFUSED[marker]} is not read (libjpeg "
                                 "refuses it)")
            elif marker in _SOF_READ:
                if frame is not None:
                    raise ValueError(f"{name}: a second frame header")
                frame = _read_sof(src, marker, name)
            elif marker == 0xC4:
                _read_dht(src, tables, name)
            elif marker == 0xCC:
                _read_dac(src, conditioning, name)
            elif marker == 0xDB:
                _read_dqt(src, quant, name)
            elif marker == 0xDD:
                if src.u16() != 4:                              # get_dri
                    raise ValueError(f"{name}: a DRI segment of a bad length")
                restart = src.u16()
            elif marker in (0xE0, 0xEE):                        # get_interesting_appn
                length = src.u16() - 2
                head = src.take(min(max(length, 0), 14))
                if length > 14:
                    src.take(length - 14)
                if marker == 0xE0 and len(head) >= 14 and head[:5] == b"JFIF\x00":
                    jfif = True
                elif marker == 0xEE and len(head) >= 12 and head[:5] == b"Adobe":
                    adobe = head[11]
            elif 0xE1 <= marker <= 0xEF or marker in (0xFE, 0xDC):   # skip_variable
                length = src.u16() - 2
                if length > 0:
                    src.take(length)
            else:
                raise ValueError(f"{name}: marker 0x{marker:02X} is not one libjpeg knows "
                                 "(it refuses the file)")
        except _Truncated:
            if complete:
                break                   # Pillow ignores jpeg_finish_decompress's wanting more
            raise
        except ValueError:
            if complete and libtiff:
                break                   # and libtiff what it raises
            raise
    return frame


def _frame(body, progressive: bool, arithmetic: bool, lossless: bool,
           name: str) -> JpegCoefficients:
    """SOF0/1/2/3/9/10: precision, size and components (``get_sof``)."""
    precision, height, width, count = body[0], *((body[1] << 8) | body[2],
                                                  (body[3] << 8) | body[4]), body[5]
    if height == 0:
        raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read "
                         "(libjpeg refuses a frame of height 0)")
    if width == 0 or count == 0:
        raise ValueError(f"{name}: an empty frame ({width} x {height}, {count} components; "
                         "libjpeg refuses it)")
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit samples are not read (8-bit only, as "
                         "Pillow)")
    if count not in (1, 3, 4):
        raise ValueError(f"{name}: a {count}-component JPEG is not read (Pillow reads 1, 3 "
                         "and 4)")
    if height > 65500 or width > 65500:
        raise ValueError(f"{name}: {width} x {height} is larger than libjpeg takes")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
             for i in range(count)]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) for _, h, v, _ in comps):
        raise ValueError(f"{name}: bad sampling factors {comps}")
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


def _read_sof(src: _Source, marker: int, name: str) -> JpegCoefficients:
    """SOFn (``get_sof``): an empty frame and a bad length are refused
    before the components are read."""
    length = src.u16()
    body = src.take(6)
    height, width, count = body[1] << 8 | body[2], body[3] << 8 | body[4], body[5]
    if height == 0:
        raise ValueError(f"{name}: a DNL marker (height defined after the scan) is not read "
                         "(libjpeg refuses a frame of height 0)")
    if width == 0 or count == 0:
        raise ValueError(f"{name}: an empty frame ({width} x {height}, {count} components; "
                         "libjpeg refuses it)")
    if length - 8 != 3 * count:
        raise ValueError(f"{name}: a frame header of a bad length")
    return _frame(body + src.take(3 * count), *_SOF_READ[marker], name)


def _read_dac(src: _Source, conditioning: tuple, name: str) -> None:
    """DAC (``get_dac``): per table, the DC conditioning bounds (L, U) or the
    AC K, in pairs until the length runs out, which must be exactly."""
    dc_l, dc_u, ac_k = conditioning
    length = src.u16() - 2
    while length > 0:
        index, value = src.byte(), src.byte()
        length -= 2
        if index >= 32:
            raise ValueError(f"{name}: a bad arithmetic conditioning table {index}")
        if index >= 16:
            ac_k[index - 16] = value
        else:
            dc_l[index], dc_u[index] = value & 15, value >> 4
            if dc_l[index] > dc_u[index]:
                raise ValueError(f"{name}: arithmetic DC conditioning with L > U")
    if length:
        raise ValueError(f"{name}: a DAC segment of a bad length")


def _read_dht(src: _Source, tables: np.ndarray, name: str) -> None:
    """DHT (``get_dht``): tables while more than 16 bytes are left, which
    must then be none."""
    length = src.u16() - 2
    while length > 16:
        index = src.byte()
        counts = np.frombuffer(src.take(16), np.uint8)
        total = int(counts.sum())
        length -= 17
        if total > 256 or total > length:
            raise ValueError(f"{name}: a bad Huffman table definition")
        values = src.take(total)
        length -= total
        row = index - 0x10 + 4 if index & 0x10 else index
        if (index & ~0x10) > 3:
            raise ValueError(f"{name}: a Huffman table index {index & ~0x10} (libjpeg has 4)")
        tables[row] = 0
        tables[row][0], tables[row][1:17] = 1, counts
        tables[row][17:17 + total] = np.frombuffer(values, np.uint8)
    if length:
        raise ValueError(f"{name}: a DHT segment of a bad length")


def _read_dqt(src: _Source, quant: dict, name: str) -> None:
    """DQT (``get_dqt``): 8-bit tables, or 16-bit where the precision
    nibble is not 0, until the length runs out, which must be exactly."""
    length = src.u16() - 2
    while length > 0:
        head = src.byte()
        pq, tq = head >> 4, head & 15
        if tq > 3:
            raise ValueError(f"{name}: a bad quantisation table index {tq}")
        size = 128 if pq else 64
        values = np.frombuffer(src.take(size), ">u2" if pq else np.uint8)
        table = np.zeros(64, np.int64)
        table[_NATURAL[:64]] = values
        quant[tq] = table.reshape(8, 8)
        length -= 1 + size
    if length:
        raise ValueError(f"{name}: a DQT segment of a bad length")


def _scan(body, frame: JpegCoefficients, quant: dict, restart: int,
          tables: np.ndarray, name: str) -> _ScanSpec:
    """SOS (``get_sos``) and the checks of the scan's start (``per_scan_setup``,
    ``latch_quant_tables``, the entropy decoders' ``start_pass``): the scan's
    components, tables and spectral selection; latches the quantisation
    tables of components seen for the first time."""
    count = body[0] if body else 0
    if not 1 <= count <= 4 or len(body) != 4 + 2 * count:
        raise ValueError(f"{name}: a bad scan header")
    slots = [None] * 4                  # libjpeg's cur_comp_info, by scan position
    comps, dc_ids, ac_ids = [], [], []
    for i in range(count):
        cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
        # the first frame component with this id whose slot is free
        found = next((ci for ci in range(min(len(frame.ids), 4))
                      if frame.ids[ci] == cid and slots[ci] is None), None)
        if found is None or found in comps:
            raise ValueError(f"{name}: a scan names component {cid}, not in the frame")
        slots[i] = found
        comps.append(found)
        dc_ids.append(td_ta >> 4)
        ac_ids.append(td_ta & 15)
    if count > 1 and sum(h * v for h, v in (frame.sampling[ci] for ci in comps)) > 10:
        raise ValueError(f"{name}: a scan with more than 10 blocks in an MCU (libjpeg refuses "
                         "it)")
    ss, se, ah, al = body[1 + 2 * count], body[2 + 2 * count], \
        body[3 + 2 * count] >> 4, body[3 + 2 * count] & 15
    for ci in comps:
        if frame.quant[ci] is None and not frame.lossless:
            t = frame.table_ids[ci]
            if t not in quant:
                raise ValueError(f"{name}: component {frame.ids[ci]} uses quantisation "
                                 f"table {t}, never defined")
            frame.quant[ci] = quant[t]
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
        if not frame.arithmetic:                # jdphuff.c's prev_coef_bits
            lo, hi = min(ss, 1), max(se, 9) + 1
            frame.prev_bits[np.ix_(comps, range(lo, hi))] = \
                frame.coef_bits[np.ix_(comps, range(lo, hi))] if frame.scans > 1 else 0
        frame.coef_bits[np.ix_(comps, range(ss, se + 1))] = al
    # a sequential scan's Ss, Se, Ah and Al are not used (JWRN_NOT_SEQUENTIAL)
    return _ScanSpec(frame, comps, dc_ids, ac_ids, ss, se, ah, al, restart, tables)


def smoothing_wanted(frame: JpegCoefficients) -> bool:
    """``jdcoefct.c smoothing_ok``: libjpeg smooths a progressive frame's
    blocks when every component's DC is known and its table's first ten
    entries are nonzero, and some component's first nine AC coefficients
    are not fully refined."""
    if not frame.progressive:
        return False
    for i, q in enumerate(frame.quant):
        if q is None or (q.reshape(64)[:10] == 0).any() or frame.coef_bits[i, 0] < 0:
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


def _smoothing_bits(frame: JpegCoefficients, i: int):
    """(coef_bits, the earlier coef_bits, the first block row smoothed with
    the earlier ones) of component i, as ``smoothing_ok`` latches them: rows
    of iMCU rows below the last one the latest scan began with data in hand
    take the bits from before each component's latest scan (-1 for a file
    of one scan)."""
    prev = frame.prev_bits[i] if frame.scans > 1 else np.full(64, -1)
    return frame.coef_bits[i], prev, (frame.last_good + 1) * frame.raw_sampling[i][1]


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
    bits, prev, first_prev = _smoothing_bits(frame, i)
    out = coef.copy()
    for lo, hi, b in ((0, min(first_prev, hb), bits), (first_prev, hb, prev)):
        if lo < hi:
            out[lo:hi, :wb] = _smoothed(coef[lo:hi, :wb], {k: w[lo:hi] for k, w in window.items()},
                                        q, b)
    return out


def _smoothed(block: np.ndarray, window: dict, q: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """The blocks ``block`` smoothed with ``bits`` (their DC windows in
    ``window``)."""
    block = block.copy()
    change_dc = bool((bits[1:10] == -1).all())
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
    return block


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
        q = frame.quant[i] if frame.quant[i] is not None else np.zeros((8, 8), np.int64)
        samples = _idct_samples(blocks[:nby, :nbx], q)[:rows, :cols]
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
            bits, prev, first_prev = _smoothing_bits(frame, i)
            bits = np.ascontiguousarray(np.concatenate([bits[:10], prev[:10]]), np.int32)
            lib.jpeg_smooth(c.ctypes.data, out.ctypes.data, c.shape[1], c.shape[0],
                            -(-rows // 8), -(-cols // 8), frame.raw_sampling[i][1],
                            quant.ctypes.data, bits.ctypes.data, int(first_prev))
            coefs.append(out)
    comp = np.array([[frame.max_h // h, frame.max_v // v, coefs[i].shape[1],
                      *frame.component_size(i), int(frame.lossless)]
                     for i, (h, v) in enumerate(frame.sampling)], np.int32)
    quant = np.zeros((n, 64), np.int64)
    if not frame.lossless:
        for i, q in enumerate(frame.quant):
            if q is not None:                   # a component no scan names: zeros
                quant[i] = q.reshape(64)
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
    frame = decode_coefficients(data, name, native)
    if frame.lossless and _colour(frame) in (YCC, YCCK):
        raise ValueError(f"{name}: a lossless frame in YCbCr (libjpeg-turbo converts no "
                         "lossless colour; Pillow refuses it)")
    return reconstruct(frame, native)


def read_jpeg(path: str, native=None) -> np.ndarray:
    """:func:`decode_jpeg` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), str(path), native)
