"""WebP's lossy bitstream (a VP8 key frame, RFC 6386), as libwebp's
``vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c`` and ``frame_dec.c`` decode
it: the plain Python reference of ``native/src/webp_decode.cpp``.

- the boolean decoder, the frame header (segments with their quantisers and
  filter levels, the filter type, level and sharpness, the reference and
  mode loop-filter deltas), the token partitions, the dequantisation
  (libwebp's ``* 155 / 100`` of the second-order AC, at least 8) and the
  coefficient probabilities with their updates;
- per macroblock: its segment, skip flag, 16x16 or 4x4 luma modes (the
  sub-block modes through their context tree) and chroma mode; the tokens
  with their above/left non-zero contexts; the inverse WHT and DCT with
  libwebp's 20091/35468 constants;
- prediction from the unfiltered reconstruction: 127 above the frame, 129
  left of it, DC without top or left as libwebp narrows it, and the 4x4
  sub-blocks' above-right pixels taken, on the macroblock's right column,
  from the row above the macroblock (replicated from its last pixel on the
  frame's right edge);
- the simple or normal loop filter in macroblock order, with libwebp's
  strengths (no filtering at all when the frame's level is 0).

:func:`decode` gives the Y, U and V planes cropped to the picture; a
malformed stream raises ``ValueError``.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.vp8_tables import (AC_TABLE, BMODES_PROBA, COEFFS_PROBA0,
                                             COEFFS_UPDATE_PROBA, DC_TABLE)

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the sub-block mode tree, libwebp's kYModesIntra4: a leaf is -mode
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
DC, TM, VE, HE = 0, 1, 2, 3


class BoolDecoder:
    """RFC 6386's boolean entropy decoder over ``data[start:end]``, zeros
    past the end. libwebp's reader (``VP8GetBit``) refuses the partition
    (``eof_``) when a bit is wanted after more than 8 * size - 8 shifts;
    its ``VP8GetSigned`` (:meth:`sign`) always shifts once, where the RFC's
    decoder may not until the next bit, so ``ahead`` holds that shift."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value = self._byte() << 8 | self._byte()
        self.range, self.count = 255, 0
        self.shifts, self.ahead, self.limit = 0, 0, 8 * (end - start) - 8

    def _byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1] if self.pos <= self.end else 0

    def sign(self) -> int:
        """``VP8GetSigned``'s bit: one of probability 1/2."""
        before = self.shifts
        bit = self.bit(128)
        self.ahead = int(self.shifts == before)
        return bit

    def bit(self, prob: int) -> int:
        if self.shifts + self.ahead > self.limit:
            raise ValueError("a VP8 partition ends early (libwebp: premature end of data)")
        self.ahead = 0
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range, self.value = 1, self.range - split, self.value - big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.shifts += 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self._byte()
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def frame_info(data: bytes) -> tuple:
    """A ``VP8 `` chunk's (width, height), or a ``ValueError``."""
    if len(data) < 10:
        raise ValueError("a VP8 frame shorter than its header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise ValueError("not a displayable VP8 key frame")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a VP8 key frame without its start code")
    width = (data[6] | data[7] << 8) & 0x3FFF
    height = (data[8] | data[9] << 8) & 0x3FFF
    if not width or not height:
        raise ValueError("a VP8 frame of size 0")
    return width, height


def _clip(v: int, top: int) -> int:
    return 0 if v < 0 else top if v > top else v


class _Header:
    pass


def _parse_header(data: bytes) -> _Header:
    h = _Header()
    h.width, h.height = frame_info(data)
    part0 = (data[0] | data[1] << 8 | data[2] << 16) >> 5
    if 10 + part0 > len(data):
        raise ValueError("the first VP8 partition runs past the frame")
    br = BoolDecoder(data, 10, 10 + part0)
    h.br = br
    br.literal(2)                                       # colour space, clamping type
    h.use_segment = br.bit(128)
    h.update_map, h.absolute = 0, 1
    h.quantizer, h.strength = [0] * 4, [0] * 4
    h.segment_proba = [255, 255, 255]
    if h.use_segment:
        h.update_map = br.bit(128)
        if br.bit(128):
            h.absolute = br.bit(128)
            h.quantizer = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            h.strength = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if h.update_map:
            h.segment_proba = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    h.simple = br.bit(128)
    h.level = br.literal(6)
    h.sharpness = br.literal(3)
    h.ref_delta, h.mode_delta = [0] * 4, [0] * 4
    h.use_lf_delta = br.bit(128)
    if h.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                h.ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                h.mode_delta[i] = br.signed(6)
    h.filter_type = 0 if h.level == 0 else 1 if h.simple else 2
    # the token partitions
    last = (1 << br.literal(2)) - 1
    start = 10 + part0
    if len(data) - start < 3 * last:
        raise ValueError("the VP8 partition sizes run past the frame")
    at, left = start + 3 * last, len(data) - start - 3 * last
    h.parts = []
    for p in range(last):
        size = min(data[start + 3 * p] | data[start + 3 * p + 1] << 8
                   | data[start + 3 * p + 2] << 16, left)
        h.parts.append(BoolDecoder(data, at, at + size))
        at, left = at + size, left - size
    if at >= len(data):
        raise ValueError("the last VP8 partition is empty")
    h.parts.append(BoolDecoder(data, at, len(data)))
    # the dequantisation of each segment
    base = br.literal(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]   # y1 dc, y2 dc, y2 ac, uv dc, ac
    h.quant = []
    for s in range(4):
        q = (h.quantizer[s] + (0 if h.absolute else base)) if h.use_segment else base
        y2ac = max((AC_TABLE[_clip(q + dq[2], 127)] * 101581) >> 16, 8)
        h.quant.append(((DC_TABLE[_clip(q + dq[0], 127)], AC_TABLE[_clip(q, 127)]),
                        (DC_TABLE[_clip(q + dq[1], 127)] * 2, y2ac),
                        (DC_TABLE[_clip(q + dq[3], 117)], AC_TABLE[_clip(q + dq[4], 127)])))
    br.bit(128)                                         # refresh the entropy probabilities
    proba = list(COEFFS_PROBA0)
    for i in range(len(proba)):
        if br.bit(COEFFS_UPDATE_PROBA[i]):
            proba[i] = br.literal(8)
    h.proba = [[[[proba[((t * 8 + b) * 3 + c) * 11 + p] for p in range(11)] for c in range(3)]
                for b in range(8)] for t in range(4)]
    h.use_skip = br.bit(128)
    h.skip_proba = br.literal(8) if h.use_skip else 0
    return h


def _filter_strengths(h: _Header) -> list:
    """libwebp's ``PrecomputeFilterStrengths``: per segment and per 4x4-or-not,
    (limit, inner level, hev threshold), limit 0 when not filtered."""
    out = []
    for s in range(4):
        base = (h.strength[s] + (0 if h.absolute else h.level)) if h.use_segment else h.level
        row = []
        for i4x4 in (0, 1):
            level = base
            if h.use_lf_delta:
                level += h.ref_delta[0] + (h.mode_delta[0] if i4x4 else 0)
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if h.sharpness > 0:
                    ilevel >>= 2 if h.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - h.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15
                            else 0))
            else:
                row.append((0, 0, 0))
        out.append(row)
    return out


def _coeffs(br: BoolDecoder, proba, ctx: int, dq, n: int, out: np.ndarray) -> int:
    """libwebp's ``GetCoeffs``: tokens from position ``n`` into ``out``
    (dequantised, in raster order); the position after the last one read."""
    p = proba[BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = proba[BANDS[n]][0]
        if not br.bit(p[2]):
            v, p = 1, proba[BANDS[n + 1]][1]
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                bit1 = br.bit(p[8])
                cat = 2 * bit1 + br.bit(p[9 + bit1])
                v = 0
                for prob in CATS[cat]:
                    v = v + v + br.bit(prob)
                v += 3 + (8 << cat)
            p = proba[BANDS[n + 1]][2]
        # libwebp keeps the dequantised coefficient in an int16_t
        out[ZIGZAG[n]] = ((-v if br.sign() else v) * dq[n > 0] + 0x8000) % 0x10000 - 0x8000
        n += 1
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct_add(coeffs: np.ndarray, dst: np.ndarray) -> None:
    """libwebp's ``TransformOne``: ``dst`` (4x4 uint8 view) plus the inverse
    DCT of ``coeffs`` (16, raster), clipped."""
    x = coeffs.reshape(4, 4).astype(np.int64)
    a, b = x[0] + x[2], x[0] - x[2]
    c, d = _mul2(x[1]) - _mul1(x[3]), _mul1(x[1]) + _mul2(x[3])
    v = np.stack([a + d, b + c, b - c, a - d])                # [row, col]
    dc = v[:, 0] + 4
    a, b = dc + v[:, 2], dc - v[:, 2]
    c, d = _mul2(v[:, 1]) - _mul1(v[:, 3]), _mul1(v[:, 1]) + _mul2(v[:, 3])
    res = np.stack([a + d, b + c, b - c, a - d], 1) >> 3
    dst[:] = np.clip(dst.astype(np.int64) + res, 0, 255)


def _w16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _pass_sse2(r0, r1, r2, r3) -> tuple:
    """One pass of libwebp's ``Transform_SSE2`` over rows r0..r3 (4 lanes):
    every sum in 16-bit lanes, the constants' products by ``mulhi``."""
    a, b = _w16(r0 + r2), _w16(r0 - r2)
    c = _w16(_w16(r1 - r3) + _w16(((r1 * -30068) >> 16) - ((r3 * 20091) >> 16)))
    d = _w16(_w16(r1 + r3) + _w16(((r1 * 20091) >> 16) + ((r3 * -30068) >> 16)))
    return _w16(a + d), _w16(b + c), _w16(b - c), _w16(a - d)


def idct_add_sse2(coeffs: np.ndarray, dst: np.ndarray) -> None:
    """libwebp's ``Transform_SSE2`` (the full transform on x86): as
    :func:`idct_add` while values stay in 16 bits, else wrapped there."""
    x = coeffs.reshape(4, 4).astype(np.int64)
    v = np.stack(_pass_sse2(x[0], x[1], x[2], x[3]))          # [row, col]
    out = _pass_sse2(_w16(v[:, 0] + 4), v[:, 1], v[:, 2], v[:, 3])
    res = np.stack([o >> 3 for o in out], 1)
    dst[:] = np.clip(dst.astype(np.int64) + res, 0, 255)


def _transform(coeffs: np.ndarray, dst: np.ndarray, kind: int) -> None:
    """libwebp's ``DoTransform`` by the block's class: 3 the full (SSE2)
    transform, 2 and 1 ``TransformAC3``/``TransformDC`` (C, as the full one
    in int arithmetic), 0 none."""
    if kind == 3:
        idct_add_sse2(coeffs, dst)
    elif kind:
        idct_add(coeffs, dst)


def _nz_class(nz: int, dc: int) -> int:
    """libwebp's ``NzCodeBits``."""
    return 3 if nz > 3 else 2 if nz > 1 else int(dc != 0)


def iwht(dc: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformWHT``: 16 second-order coefficients -> the 16 DCs."""
    x = dc.reshape(4, 4).astype(np.int64)
    a0, a1, a2, a3 = x[0] + x[3], x[1] + x[2], x[1] - x[2], x[0] - x[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])
    d = t[:, 0] + 3
    a0, a1, a2, a3 = d + t[:, 3], t[:, 1] + t[:, 2], t[:, 1] - t[:, 2], d - t[:, 3]
    return (np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1) >> 3).reshape(16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _predict4(mode: int, w: np.ndarray, y: int, x: int) -> None:
    """libwebp's ``VP8PredLuma4[mode]`` into ``w[y:y+4, x:x+4]`` from its
    top row (8 pixels), left column and corner."""
    top = [int(v) for v in w[y - 1, x:x + 8]]
    left = [int(v) for v in w[y:y + 4, x - 1]]
    X = int(w[y - 1, x - 1])
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    out = np.zeros((4, 4), np.int64)
    if mode == DC:
        out[:] = (sum(top[:4]) + sum(left) + 4) >> 3
    elif mode == TM:
        out[:] = np.clip(np.array(left)[:, None] + np.array(top[:4])[None] - X, 0, 255)
    elif mode == VE:
        out[:] = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
    elif mode == HE:
        out[:] = np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)])[:, None]
    else:
        P = {}
        if mode == 4:                               # RD, down-right
            P = {(0, 3): _avg3(J, K, L), (1, 3): _avg3(I, J, K), (0, 2): _avg3(I, J, K),
                 (2, 3): _avg3(X, I, J), (1, 2): _avg3(X, I, J), (0, 1): _avg3(X, I, J),
                 (3, 2): _avg3(B, A, X), (2, 1): _avg3(B, A, X), (1, 0): _avg3(B, A, X),
                 (3, 1): _avg3(C, B, A), (2, 0): _avg3(C, B, A), (3, 0): _avg3(D, C, B)}
            for k in range(4):
                P[(k, k)] = _avg3(A, X, I)
        elif mode == 5:                             # VR, vertical-right
            P = {(0, 0): _avg2(X, A), (1, 2): _avg2(X, A), (1, 0): _avg2(A, B),
                 (2, 2): _avg2(A, B), (2, 0): _avg2(B, C), (3, 2): _avg2(B, C),
                 (3, 0): _avg2(C, D), (0, 3): _avg3(K, J, I), (0, 2): _avg3(J, I, X),
                 (0, 1): _avg3(I, X, A), (1, 3): _avg3(I, X, A), (1, 1): _avg3(X, A, B),
                 (2, 3): _avg3(X, A, B), (2, 1): _avg3(A, B, C), (3, 3): _avg3(A, B, C),
                 (3, 1): _avg3(B, C, D)}
        elif mode == 6:                             # LD, down-left
            vals = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                    _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
            P = {(i, j): vals[i + j] for i in range(4) for j in range(4)}
        elif mode == 7:                             # VL, vertical-left
            P = {(0, 0): _avg2(A, B), (1, 0): _avg2(B, C), (0, 2): _avg2(B, C),
                 (2, 0): _avg2(C, D), (1, 2): _avg2(C, D), (3, 0): _avg2(D, E),
                 (2, 2): _avg2(D, E), (0, 1): _avg3(A, B, C), (1, 1): _avg3(B, C, D),
                 (0, 3): _avg3(B, C, D), (2, 1): _avg3(C, D, E), (1, 3): _avg3(C, D, E),
                 (3, 1): _avg3(D, E, F), (2, 3): _avg3(D, E, F), (3, 2): _avg3(E, F, G),
                 (3, 3): _avg3(F, G, H)}
        elif mode == 8:                             # HD, horizontal-down
            P = {(0, 0): _avg2(I, X), (2, 1): _avg2(I, X), (0, 1): _avg2(J, I),
                 (2, 2): _avg2(J, I), (0, 2): _avg2(K, J), (2, 3): _avg2(K, J),
                 (0, 3): _avg2(L, K), (3, 0): _avg3(A, B, C), (2, 0): _avg3(X, A, B),
                 (1, 0): _avg3(I, X, A), (3, 1): _avg3(I, X, A), (1, 1): _avg3(J, I, X),
                 (3, 2): _avg3(J, I, X), (1, 2): _avg3(K, J, I), (3, 3): _avg3(K, J, I),
                 (1, 3): _avg3(L, K, J)}
        else:                                       # HU, horizontal-up
            P = {(0, 0): _avg2(I, J), (2, 0): _avg2(J, K), (0, 1): _avg2(J, K),
                 (2, 1): _avg2(K, L), (0, 2): _avg2(K, L), (1, 0): _avg3(I, J, K),
                 (3, 0): _avg3(J, K, L), (1, 1): _avg3(J, K, L), (3, 1): _avg3(K, L, L),
                 (1, 2): _avg3(K, L, L)}
            for k in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
                P[k] = L
        for (px, py), val in P.items():             # keys are (x, y), as libwebp's DST
            out[py, px] = val
    w[y:y + 4, x:x + 4] = out


def _predict_block(mode: int, w: np.ndarray, size: int, mb_x: int, mb_y: int) -> None:
    """16x16 luma or 8x8 chroma prediction into ``w[1:, 1:]`` (``w[0]`` the
    row above, ``w[:, 0]`` the column left); DC narrowed at the frame's
    top and left edges as libwebp's ``CheckMode``."""
    top = w[0, 1:size + 1].astype(np.int64)
    left = w[1:size + 1, 0].astype(np.int64)
    shift = 5 if size == 16 else 4
    if mode == DC:
        if mb_x == 0 and mb_y == 0:
            val = 0x80
        elif mb_y == 0:
            val = (int(left.sum()) + (size >> 1)) >> (shift - 1)
        elif mb_x == 0:
            val = (int(top.sum()) + (size >> 1)) >> (shift - 1)
        else:
            val = (int(top.sum() + left.sum()) + size) >> shift
        w[1:size + 1, 1:size + 1] = val
    elif mode == TM:
        w[1:size + 1, 1:size + 1] = np.clip(left[:, None] + top[None] - int(w[0, 0]), 0, 255)
    elif mode == VE:
        w[1:size + 1, 1:size + 1] = top[None]
    else:
        w[1:size + 1, 1:size + 1] = left[:, None]


def decode(data: bytes) -> tuple:
    """A ``VP8 `` chunk's payload -> (Y (H, W), U, V ((H+1)//2, (W+1)//2)) uint8."""
    h = _parse_header(data)
    br = h.br
    mbw, mbh = (h.width + 15) >> 4, (h.height + 15) >> 4
    Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
    U = np.zeros((mbh * 8, mbw * 8), np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), np.uint8)
    strengths = _filter_strengths(h)
    finfo = np.zeros((mbh, mbw, 4), np.int64)           # limit, ilevel, hev, inner
    intra_t = [DC] * (4 * mbw)
    nz_top, nzdc_top = [0] * mbw, [0] * mbw
    for mb_y in range(mbh):
        tb = h.parts[mb_y & (len(h.parts) - 1)]
        intra_l = [DC] * 4
        nz_left = nzdc_left = 0
        for mb_x in range(mbw):
            # the modes, in the first partition
            segment = 0
            if h.update_map:
                p = h.segment_proba
                segment = br.bit(p[1]) if not br.bit(p[0]) else 2 + br.bit(p[2])
            skip = br.bit(h.skip_proba) if h.use_skip else 0
            is4 = not br.bit(145)
            if not is4:
                ymode = (TM if br.bit(128) else HE) if br.bit(156) else (VE if br.bit(163) else DC)
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        base = (intra_t[4 * mb_x + x] * 10 + ymode) * 9
                        i = YMODES_INTRA4[br.bit(BMODES_PROBA[base])]
                        while i > 0:
                            i = YMODES_INTRA4[2 * i + br.bit(BMODES_PROBA[base + i])]
                        ymode = -i
                        intra_t[4 * mb_x + x] = ymode
                    modes.extend(intra_t[4 * mb_x:4 * mb_x + 4])
                    intra_l[y] = ymode
            uvmode = DC if not br.bit(142) else VE if not br.bit(114) else \
                TM if br.bit(183) else HE
            # the residuals, in the row's token partition
            coeffs = np.zeros((24, 16), np.int64)
            kinds = [0] * 24                                    # each block's NzCodeBits
            y1q, y2q, uvq = h.quant[segment]
            if not skip:
                if not is4:
                    dc = np.zeros(16, np.int64)
                    nz = _coeffs(tb, h.proba[1], nzdc_top[mb_x] + nzdc_left, y2q, 0, dc)
                    nzdc_top[mb_x] = nzdc_left = int(nz > 0)
                    coeffs[:, 0][:16] = ((iwht(dc) if nz > 1 else (int(dc[0]) + 3) >> 3)
                                         + 0x8000) % 0x10000 - 0x8000     # int16_t
                    first, ac = 1, h.proba[0]
                else:
                    first, ac = 0, h.proba[3]
                tnz, lnz = nz_top[mb_x] & 0x0F, nz_left & 0x0F
                any_nz = 0
                for y in range(4):
                    l = lnz & 1
                    for x in range(4):
                        blk = coeffs[4 * y + x]
                        nz = _coeffs(tb, ac, l + (tnz & 1), y1q, first, blk)
                        kinds[4 * y + x] = _nz_class(nz, blk[0])
                        l = int(nz > first)
                        tnz = (tnz >> 1) | (l << 7)
                        any_nz |= int(nz > 1 or blk[0] != 0)      # libwebp's NzCodeBits
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz, lnz = nz_top[mb_x] >> (4 + ch), nz_left >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            blk = coeffs[16 + 2 * ch + 2 * y + x]
                            nz = _coeffs(tb, h.proba[2], l + (tnz & 1), uvq, 0, blk)
                            kinds[16 + 2 * ch + 2 * y + x] = _nz_class(nz, blk[0])
                            l = int(nz > 0)
                            tnz = (tnz >> 1) | (l << 3)
                            any_nz |= int(nz > 1 or blk[0] != 0)
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                nz_top[mb_x], nz_left = out_t, out_l
                skip = not any_nz
            else:
                nz_top[mb_x] = nz_left = 0
                if not is4:
                    nzdc_top[mb_x] = nzdc_left = 0
            if h.filter_type:
                limit, ilevel, hev = strengths[segment][int(is4)]
                finfo[mb_y, mb_x] = (limit, ilevel, hev, int(is4) | int(not skip))
            _reconstruct(Y, U, V, mb_x, mb_y, mbw, is4, modes if is4 else ymode, uvmode, coeffs,
                         kinds)
    if h.filter_type:
        _loop_filter(Y, U, V, finfo, h.filter_type)
    cw, ch_ = (h.width + 1) >> 1, (h.height + 1) >> 1
    return Y[:h.height, :h.width], U[:ch_, :cw], V[:ch_, :cw]


def _reconstruct(Y, U, V, mb_x, mb_y, mbw, is4, ymodes, uvmode, coeffs, kinds) -> None:
    """Predict and add the residuals of one macroblock into the unfiltered
    planes, from a work block with the row above (and, for luma, 4 pixels
    above-right) and the column left, as libwebp's ``ReconstructRow``; each
    block's transform by its class (``kinds``), a chroma plane's four by the
    full transform where one needs more than its DC (``DoUVTransform``)."""
    y0, x0 = 16 * mb_y, 16 * mb_x
    w = np.zeros((17, 21), np.int64)
    if mb_y > 0:
        w[0, 1:17] = Y[y0 - 1, x0:x0 + 16]
        w[0, 0] = Y[y0 - 1, x0 - 1] if mb_x > 0 else 129
        w[0, 17:21] = Y[y0 - 1, x0 + 16:x0 + 20] if mb_x < mbw - 1 else Y[y0 - 1, x0 + 15]
    else:
        w[0, :] = 127
    w[1:, 0] = Y[y0:y0 + 16, x0 - 1] if mb_x > 0 else 129
    if is4:
        for r in (4, 8, 12):                           # the above-right of the right column
            w[r, 17:21] = w[0, 17:21]
        for n in range(16):
            by, bx = 1 + 4 * (n >> 2), 1 + 4 * (n & 3)
            _predict4(ymodes[n], w, by, bx)
            _transform(coeffs[n], w[by:by + 4, bx:bx + 4], kinds[n])
    else:
        _predict_block(ymodes, w, 16, mb_x, mb_y)
        for n in range(16):
            by, bx = 1 + 4 * (n >> 2), 1 + 4 * (n & 3)
            _transform(coeffs[n], w[by:by + 4, bx:bx + 4], kinds[n])
    Y[y0:y0 + 16, x0:x0 + 16] = w[1:17, 1:17]
    for k, P in enumerate((U, V)):
        c0, r0 = 8 * mb_x, 8 * mb_y
        w = np.zeros((9, 9), np.int64)
        if mb_y > 0:
            w[0, 1:] = P[r0 - 1, c0:c0 + 8]
            w[0, 0] = P[r0 - 1, c0 - 1] if mb_x > 0 else 129
        else:
            w[0, :] = 127
        w[1:, 0] = P[r0:r0 + 8, c0 - 1] if mb_x > 0 else 129
        _predict_block(uvmode, w, 8, mb_x, mb_y)
        plane = kinds[16 + 4 * k:20 + 4 * k]
        for n in range(4):
            by, bx = 1 + 4 * (n >> 1), 1 + 4 * (n & 1)
            _transform(coeffs[16 + 4 * k + n], w[by:by + 4, bx:bx + 4],
                       3 if max(plane) >= 2 else plane[n])
        P[r0:r0 + 8, c0:c0 + 8] = w[1:, 1:]


def _filter_edge(P: np.ndarray, lines, horizontal: bool, at: int, thresh: int, ithresh: int,
                 hev_t: int, mb_edge: bool, simple: bool) -> None:
    """libwebp's filter of one edge: the pixels across it at ``at`` (a column
    when ``horizontal``, i.e. filtering left-right, else a row) on each of
    ``lines``, all lines at once."""
    idx = np.arange(-4, 4) + at
    seg = (P[lines][:, idx] if horizontal else P[idx][:, lines].T).astype(np.int64)
    p3, p2, p1, p0, q0, q1, q2, q3 = seg.T
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if not simple:
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh)
                 & (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh)
                 & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
    sclip1 = lambda v: np.clip(v, -128, 127)      # noqa: E731
    sclip2 = lambda v: np.clip(v, -16, 15)        # noqa: E731
    clip1 = lambda v: np.clip(v, 0, 255)          # noqa: E731
    # DoFilter2: outer taps, p0 and q0 only
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    f2 = (clip1(p0 + sclip2((a + 3) >> 3)), clip1(q0 - sclip2((a + 4) >> 3)))
    out = seg.copy()
    if simple:
        out[:, 3] = np.where(need, f2[0], p0)
        out[:, 4] = np.where(need, f2[1], q0)
    else:
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        if mb_edge:                                 # DoFilter6
            a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            other = {2: clip1(p1 + a2), 3: clip1(p0 + a1), 4: clip1(q0 - a1),
                     5: clip1(q1 - a2), 1: clip1(p2 + a3), 6: clip1(q2 - a3)}
        else:                                       # DoFilter4
            a = 3 * (q0 - p0)
            a1, a2 = sclip2((a + 4) >> 3), sclip2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            other = {2: clip1(p1 + a3), 3: clip1(p0 + a2), 4: clip1(q0 - a1), 5: clip1(q1 - a3)}
        for col, val in other.items():
            hv = f2[0] if col == 3 else f2[1] if col == 4 else seg[:, col]
            out[:, col] = np.where(need, np.where(hev, hv, val), seg[:, col])
    if horizontal:
        P[np.ix_(lines, idx)] = out
    else:
        P[np.ix_(idx, lines)] = out.T


def _loop_filter(Y, U, V, finfo, filter_type: int) -> None:
    """libwebp's ``DoFilter`` on every macroblock in raster order: left edge,
    inner vertical edges, top edge, inner horizontal edges."""
    mbh, mbw = finfo.shape[:2]
    simple = filter_type == 1
    for mb_y in range(mbh):
        for mb_x in range(mbw):
            limit, ilevel, hev_t, inner = (int(v) for v in finfo[mb_y, mb_x])
            if limit == 0:
                continue
            planes = [(Y, 16)] if simple else [(Y, 16), (U, 8), (V, 8)]
            for P, size in planes:
                y0, x0 = size * mb_y, size * mb_x
                rows, cols = np.arange(y0, y0 + size), np.arange(x0, x0 + size)
                steps = (4,) if size == 8 else (4, 8, 12)
                if mb_x > 0:
                    _filter_edge(P, rows, True, x0, limit + 4, ilevel, hev_t, True, simple)
                if inner:
                    for s in steps:
                        _filter_edge(P, rows, True, x0 + s, limit, ilevel, hev_t, False, simple)
                if mb_y > 0:
                    _filter_edge(P, cols, False, y0, limit + 4, ilevel, hev_t, True, simple)
                if inner:
                    for s in steps:
                        _filter_edge(P, cols, False, y0 + s, limit, ilevel, hev_t, False, simple)
