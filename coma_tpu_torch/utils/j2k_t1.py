"""JPEG 2000 tier-1 decoding, as OpenJPEG 2.5.4 decodes a code-block.

One code-block's segments (a list of ``(bytes, passes)``) to its samples,
kept with one extra fractional bit: a sample first found significant at
bit-plane p holds ``1.5 * 2^(p + 1)``, and each refinement moves it by half
the next plane, so it sits at the midpoint of what was decoded (truncated
quality layers included). The caller halves it (the reversible path, C's
truncating division) or multiplies it by half the step size (the
irreversible path).

- The MQ decoder of ``mqc.c``: ``opj_mqc_init_dec`` appends two 0xFF bytes
  to every segment, so a decoder that reads past the segment's end sees a
  marker and is fed 0xFF00 (``opj_mqc_bytein``); the raw (bypass) decoder
  reads ones there.
- The significance, refinement and cleanup passes, the cleanup's
  run-length mode (a whole column of four with nothing significant in its
  neighbourhood), the zero-coding contexts per band orientation (OpenJPEG's
  ``lut_ctxno_zc``: h and v swapped for band 1, HL), sign and magnitude
  contexts.
- The code-block styles: BYPASS (raw significance and refinement passes
  below the fourth plane), RESET (contexts reset after each pass), TERMALL
  (a segment per pass; the caller cuts them), VSC (a stripe's last row does
  not see the next stripe), PTERM (nothing to do when decoding) and SEGSYM
  (the four symbols after a cleanup pass, which only warn in OpenJPEG).
- The ROI shift (RGN's maxshift): ``roishift`` planes more, then every
  sample of at least ``2^roishift`` shifted down.

:func:`decode_cblk` is the plain reference of ``native/src/j2k_decode.cpp``'s
``j2k_t1_decode``.
"""
from __future__ import annotations

import numpy as np

# the MQ coder's states: (Qe, next on MPS, next on LPS, switch the MPS on LPS)
_STATES = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
QE = tuple(s[0] for s in _STATES)
NMPS = tuple(s[1] for s in _STATES)
NLPS = tuple(s[2] for s in _STATES)
SWITCH = tuple(s[3] for s in _STATES)

# contexts: zero coding 0-8, sign 9-13, magnitude 14-16, run 17, uniform 18
CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 9, 14, 17, 18
N_CTX = 19

# code-block styles (COD/COC's SPcod byte 3)
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64


def _zc(h: int, v: int, d: int, orient: int) -> int:
    """``t1_init_ctxno_zc``: the zero-coding context of h, v and d
    significant neighbours in a band of orientation ``orient``."""
    if orient == 1:
        h, v = v, h
    if orient in (0, 1, 2):
        if not h:
            if not v:
                return 0 if not d else (1 if d == 1 else 2)
            return 3 if v == 1 else 4
        if h == 1:
            if not v:
                return 5 if not d else 6
            return 7
        return 8
    hv = h + v
    if not d:
        return 0 if not hv else (1 if hv == 1 else 2)
    if d == 1:
        return 3 if not hv else (4 if hv == 1 else 5)
    if d == 2:
        return 6 if not hv else 7
    return 8


# ZC[orient][(h * 3 + v) * 5 + d]
ZC = tuple(tuple(_zc(h, v, d, o) for h in range(3) for v in range(3) for d in range(5))
           for o in range(4))


def _sc(hc: int, vc: int):
    """``t1_init_ctxno_sc`` and ``t1_init_spb``: (context, sign prediction
    bit) of the clipped horizontal and vertical sign contributions."""
    spb = 0 if not hc and not vc else int(not (hc > 0 or (not hc and vc > 0)))
    if hc < 0:
        hc, vc = -hc, -vc
    if not hc:
        n = 0 if not vc else 1
    else:
        n = {-1: 2, 0: 3, 1: 4}[vc]
    return CTX_SC + n, spb


# SC[(hc + 1) * 3 + vc + 1] -> (context, spb)
SC = tuple(_sc(hc, vc) for hc in (-1, 0, 1) for vc in (-1, 0, 1))


class MQDecoder:
    """``opj_mqc_t`` decoding one segment (``opj_mqc_init_dec``)."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = 0xFF << 16 if not data else data[0] << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000
        self.reset()

    def reset(self) -> None:
        """``opj_mqc_resetstates`` and the three states T1 sets."""
        self.state = [0] * N_CTX
        self.mps = [0] * N_CTX
        self.state[CTX_UNI], self.state[CTX_AGG], self.state[0] = 46, 3, 4

    def _bytein(self) -> None:
        buf, bp = self.buf, self.bp
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += buf[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += buf[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.state[cx]
        qe = QE[st]
        a = self.a - qe
        c = self.c
        if (c >> 16) < qe:
            if a < qe:
                d = self.mps[cx]
                self.state[cx] = NMPS[st]
            else:
                d = 1 - self.mps[cx]
                if SWITCH[st]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[st]
            a = qe
        else:
            c -= qe << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return self.mps[cx]
            if a < qe:
                d = 1 - self.mps[cx]
                if SWITCH[st]:
                    self.mps[cx] = d
                self.state[cx] = NLPS[st]
            else:
                d = self.mps[cx]
                self.state[cx] = NMPS[st]
        self.c = c
        while True:                      # opj_mqc_renormd
            if self.ct == 0:
                self._bytein()
            a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if a >= 0x8000:
                break
        self.a = a
        return d


class RawDecoder:
    """``opj_mqc_raw_init_dec`` and ``opj_mqc_raw_decode`` (BYPASS)."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = 0
        self.ct = 0

    def decode(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


class _Block:
    """A code-block's state: padded flat arrays of significance, sign
    (1 negative), visited this plane (OpenJPEG's PI) and refined (MU)."""

    def __init__(self, w: int, h: int, orient: int, vsc: bool):
        self.w, self.h, self.stride = w, h, w + 2
        n = (w + 2) * (h + 2)
        self.sig, self.neg, self.pi, self.mu = [0] * n, [0] * n, [0] * n, [0] * n
        self.data = [0] * n
        self.zc = ZC[orient]
        self.vsc = vsc

    def south_seen(self, y: int) -> bool:
        return not (self.vsc and (y & 3) == 3)

    def zc_ctx(self, p: int, y: int) -> int:
        s, W = self.sig, self.stride
        h = s[p - 1] + s[p + 1]
        v = s[p - W]
        d = s[p - W - 1] + s[p - W + 1]
        if self.south_seen(y):
            v += s[p + W]
            d += s[p + W - 1] + s[p + W + 1]
        return self.zc[(h * 3 + v) * 5 + d]

    def has_neighbour(self, p: int, y: int) -> bool:
        s, W = self.sig, self.stride
        if s[p - 1] or s[p + 1] or s[p - W] or s[p - W - 1] or s[p - W + 1]:
            return True
        return self.south_seen(y) and bool(s[p + W] or s[p + W - 1] or s[p + W + 1])

    def sc_ctx(self, p: int, y: int):
        s, n, W = self.sig, self.neg, self.stride

        def contrib(q):
            return s[q] * (1 - 2 * n[q])
        hc = max(-1, min(1, contrib(p - 1) + contrib(p + 1)))
        vs = contrib(p - W) + (contrib(p + W) if self.south_seen(y) else 0)
        vc = max(-1, min(1, vs))
        return SC[(hc + 1) * 3 + vc + 1]


def _samples(blk: _Block):
    """Stripe order: (y, p) of every sample, column by column within each
    stripe of four rows."""
    W = blk.stride
    for k in range(0, blk.h, 4):
        for x in range(blk.w):
            for y in range(k, min(k + 4, blk.h)):
                yield y, (y + 1) * W + x + 1


def _sigpass(blk: _Block, mq, bpno: int, raw: bool) -> None:
    oneplushalf = (1 << bpno) | (1 << bpno >> 1)
    sig, pi = blk.sig, blk.pi
    for y, p in _samples(blk):
        if sig[p] or pi[p] or not blk.has_neighbour(p, y):
            continue
        if raw:
            if mq.decode():
                v = mq.decode()
                blk.data[p] = -oneplushalf if v else oneplushalf
                sig[p], blk.neg[p] = 1, v
        elif mq.decode(blk.zc_ctx(p, y)):
            cx, spb = blk.sc_ctx(p, y)
            v = mq.decode(cx) ^ spb
            blk.data[p] = -oneplushalf if v else oneplushalf
            sig[p], blk.neg[p] = 1, v
        pi[p] = 1


def _refpass(blk: _Block, mq, bpno: int, raw: bool) -> None:
    poshalf = (1 << bpno) >> 1
    sig, pi, mu, data = blk.sig, blk.pi, blk.mu, blk.data
    for y, p in _samples(blk):
        if not sig[p] or pi[p]:
            continue
        if raw:
            v = mq.decode()
        else:
            cx = CTX_MAG + 2 if mu[p] else CTX_MAG + int(blk.has_neighbour(p, y))
            v = mq.decode(cx)
        data[p] += poshalf if (v ^ (data[p] < 0)) else -poshalf
        mu[p] = 1


def _clnpass(blk: _Block, mq, bpno: int, segsym: bool) -> None:
    oneplushalf = (1 << bpno) | (1 << bpno >> 1)
    sig, pi, W = blk.sig, blk.pi, blk.stride

    def significant(p, y):
        v = mq.decode(blk.zc_ctx(p, y))
        if v:
            sign(p, y)

    def sign(p, y):
        cx, spb = blk.sc_ctx(p, y)
        v = mq.decode(cx) ^ spb
        blk.data[p] = -oneplushalf if v else oneplushalf
        sig[p], blk.neg[p] = 1, v

    full = blk.h & ~3
    for k in range(0, blk.h, 4):
        for x in range(blk.w):
            ps = [(y, (y + 1) * W + x + 1) for y in range(k, min(k + 4, blk.h))]
            start = 0
            if k < full and all(not sig[p] and not pi[p] and not blk.has_neighbour(p, y)
                                for y, p in ps):
                if not mq.decode(CTX_AGG):
                    continue
                run = mq.decode(CTX_UNI) << 1
                run |= mq.decode(CTX_UNI)
                y, p = ps[run]
                sign(p, y)
                start = run + 1
                check = False
            else:
                check = True
            for y, p in ps[start:]:
                if check and (sig[p] or pi[p]):
                    continue
                significant(p, y)
            for _, p in ps:
                pi[p] = 0
    if segsym:
        for _ in range(4):
            mq.decode(CTX_UNI)           # a bad symbol only warns in OpenJPEG


def decode_cblk(segments, w: int, h: int, orient: int, numbps: int, roishift: int,
                cblksty: int) -> np.ndarray:
    """``opj_t1_decode_cblk``: a code-block's segments (``[(bytes,
    passes)]``) -> (h, w) int32 samples with their extra fractional bit, the
    ROI shift undone."""
    if cblksty & HT:
        raise ValueError("HTJ2K (JPEG 2000 Part 15) code-blocks are not read")
    blk = _Block(w, h, orient, bool(cblksty & VSC))
    bpno = roishift + numbps
    if bpno >= 31:
        raise ValueError(f"unsupported bpno_plus_one = {bpno} >= 31")
    passtype = 2
    mq = None
    for data, passes in segments:
        raw = (bpno <= numbps - 4 and passtype < 2 and cblksty & LAZY)
        if raw:
            dec = RawDecoder(data)
        else:
            # the contexts live on from segment to segment, as in OpenJPEG
            states = (mq.state, mq.mps) if mq is not None else None
            mq = dec = MQDecoder(data)
            if states is not None:
                mq.state, mq.mps = states
        for _ in range(passes):
            if bpno < 1:
                break
            if passtype == 0:
                _sigpass(blk, dec, bpno, raw)
            elif passtype == 1:
                _refpass(blk, dec, bpno, raw)
            else:
                _clnpass(blk, dec, bpno, bool(cblksty & SEGSYM))
            if cblksty & RESET and not raw:
                dec.reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    W = blk.stride
    out = np.array(blk.data, np.int64).reshape(h + 2, W)[1:h + 1, 1:w + 1]
    if roishift:
        if roishift >= 31:
            return np.zeros((h, w), np.int32)
        mag = np.abs(out)
        out = np.where(mag >= (1 << roishift), np.sign(out) * (mag >> roishift), out)
    return out.astype(np.int32)
