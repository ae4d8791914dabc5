"""The TIFF compressions of libtiff 4.7.1 that ``utils/tiff.py`` reads
beside LZW, PackBits, Deflate and JPEG, as Pillow 12.1.0 hands a strip to
them:

- CCITT (``tif_fax3.c``): modified Huffman with each row byte-aligned
  (compression 2) or word-aligned (32771, RLEW), T.4 (3) in 1-D or 2-D rows
  each after an EOL, and T.6 (4). Damaged rows follow libtiff's rules: a
  bad code word ends the row (the rest of it the colour at hand) and a
  premature end fails the strip, except in T.6 once a row is whole, where
  the rows after it are left as the strip buffer held them.
- ThunderScan (32809, ``tif_thunder.c``): 4-bit samples in runs, 2-bit and
  3-bit deltas.
- LZMA (34925, ``tif_lzma.c``): an xz stream, through Python's ``lzma``
  (the same liblzma).
- Zstandard (50000, ``tif_zstd.c``): the first frame of RFC 8878, decoded
  here: raw, RLE and compressed blocks, Huffman literals and FSE-coded
  sequences, the content checksum (XXH64), with libzstd 1.5.7's checks;
  for 4-stream literals the fast loop of the decoder ``HUF_selectDecoder``
  takes, single-symbol (with its tail) or double-symbol, is followed (a
  damaged stream read past its start).

The CCITT run decoder and the Zstandard frame decoder have native twins in
``native/src/tiff_codecs.cpp``; the plain versions here are their
references. Each decoder returns what libtiff writes into the strip buffer
and raises a ``ValueError`` where libtiff fails the strip.
"""
from __future__ import annotations

import lzma

import numpy as np

_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))

# ------------------------------------------------------------------ CCITT

# T.4's code words, most significant bit first: white and black terminating
# codes (runs 0-63), their make-up codes (64-1728) and the common make-up
# codes (1792-2560)
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_COMMON_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()

# libtiff's table states (tif_fax3.h)
S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, \
    S_MAKEUP, S_EOL = range(13)


def _table(bits: int, entries) -> np.ndarray:
    """``mkg3states``' ``FillTable``: (2^bits, 3) of (state, width, param),
    indexed by the next ``bits`` bits least significant first; a prefix no
    code word starts stays (S_NULL, 0, 0)."""
    table = np.zeros((1 << bits, 3), np.int32)
    for code, state, param in entries:
        width = len(code)
        table[int(code[::-1], 2)::1 << width] = (state, width, param)
    return table


def _run_entries(term, makeup, term_state, makeup_state):
    return ([(c, makeup_state, 64 * (k + 1)) for k, c in enumerate(makeup)]
            + [(c, S_MAKEUP, 1792 + 64 * k) for k, c in enumerate(_COMMON_MAKEUP)]
            + [(c, term_state, k) for k, c in enumerate(term)]
            + [("0" * 11, S_EOL, 0)])


WHITE_TABLE = _table(12, _run_entries(_WHITE_TERM, _WHITE_MAKEUP, S_TERMW, S_MAKEUPW))
BLACK_TABLE = _table(13, _run_entries(_BLACK_TERM, _BLACK_MAKEUP, S_TERMB, S_MAKEUPB))
MAIN_TABLE = _table(7, [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
                        ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
                        ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
                        ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)])
_TABLES = {12: WHITE_TABLE.tolist(), 13: BLACK_TABLE.tolist(), 7: MAIN_TABLE.tolist()}

# the modes of the four decoders (``tif_fax3.c``'s ``InitCCITTRLE``,
# ``InitCCITTRLEW``, ``Fax3Decode1D``/``Fax3Decode2D``, ``Fax4Decode``)
FAX_RLE, FAX_RLEW, FAX_G3, FAX_G4 = 2, 32771, 3, 4
GROUP3OPT_2DENCODING = 1


_M = 0xFFFFFFFF


def _i32(v: int) -> int:
    """libtiff's ``int32_t`` a0, b1 and RunLength: modulo 2^32, signed."""
    return ((v + 0x80000000) & _M) - 0x80000000


class _Eof(Exception):
    """NeedBits found no bits left: the expander's ``eoflab``."""


class _NoEol(Exception):
    """SYNC_EOL found no EOL before the end of the data (``noEOLFound``)."""


class _Fail(Exception):
    """libtiff returns -1 from the decoder (a run array overflow)."""


class _Fax:
    """``Fax3CodecState`` over one strip: the bit accumulator fed least
    significant bit first (each stored byte reversed, as libtiff's
    ``bitmap`` does for fill order 1), the EOL count and the run arrays
    (``uint32_t``, as the positions a0 and b1 are ``int32_t``)."""

    def __init__(self, data: bytes, parity: int, width: int, cur: list, ref: list):
        self.data = data.translate(_REVERSED)
        self.cp, self.ep = 0, len(data)
        self.parity = parity               # the file offset of the data, modulo 2
        self.acc = self.avail = self.eolcnt = 0
        self.lastx = width
        self.nruns = len(cur) - 1
        self.cur, self.ref = cur, ref
        self.a0 = self.run_length = self.pa = self.b1 = self.pb = 0

    # the bit reader (NeedBits8, NeedBits16, GetBits, ClrBits)
    def need8(self, n: int) -> None:
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= self.data[self.cp] << self.avail
                self.cp += 1
                self.avail += 8

    def need16(self, n: int) -> None:
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _Eof
                self.avail = n
            else:
                self.acc |= self.data[self.cp] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= self.ep:
                        self.avail = n
                    else:
                        self.acc |= self.data[self.cp] << self.avail
                        self.cp += 1
                        self.avail += 8

    def bits(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clear(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, wid: int):
        (self.need8 if wid <= 8 else self.need16)(wid)
        state, width, param = _TABLES[wid][self.acc & ((1 << wid) - 1)]
        self.clear(width)
        return state, param

    # the run array (SETVALUE, CLEANUP_RUNS)
    def setvalue(self, x: int) -> None:
        if self.pa >= self.nruns:
            raise _Fail("a run array overflow (libtiff's 'Buffer overflow')")
        self.cur[self.pa] = (self.run_length + x) & _M
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run_length = 0

    def cleanup(self) -> None:
        if self.run_length:
            self.setvalue(0)
        lastx = self.lastx
        if self.a0 != lastx:                          # Fax3BadLength: a warning
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.cur[self.pa])
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def sync_eol(self) -> None:
        """SYNC_EOL: find the EOL (11 zero bits, unless one was just read),
        pass its fill and its one bit."""
        if self.eolcnt == 0:
            while True:
                self.need16(11)
                if self.bits(11) == 0:
                    break
                self.clear(1)
        while True:
            try:
                self.need8(8)
            except _Eof:
                raise _NoEol from None
            if self.bits(8):
                break
            self.clear(8)
        while self.bits(1) == 0:
            self.clear(1)
        self.clear(1)
        self.eolcnt = 0

    def _colour_run(self, wid: int, term: int) -> bool:
        """One run of make-up codes and a terminating code in horizontal
        mode; False at a code of another kind."""
        while True:
            state, param = self.lookup(wid)
            if state == term:
                self.setvalue(param)
                return True
            if state in (S_MAKEUPW, S_MAKEUPB, S_MAKEUP):
                self.a0 = _i32(self.a0 + param)
                self.run_length = _i32(self.run_length + param)
            else:
                return False

    def expand1d(self) -> None:
        """EXPAND1D to its ``done1d``; an end of the data raises ``_Eof``
        after the runs are cleaned up (its ``eof1d``)."""
        try:
            while True:
                while True:
                    state, param = self.lookup(12)
                    if state == S_EOL:
                        self.eolcnt = 1
                        self.cleanup()
                        return
                    if state == S_TERMW:
                        self.setvalue(param)
                        break
                    if state in (S_MAKEUPW, S_MAKEUP):
                        self.a0 = _i32(self.a0 + param)
                        self.run_length = _i32(self.run_length + param)
                    else:                             # Fax3Unexpected: the row ends
                        self.cleanup()
                        return
                if self.a0 >= self.lastx:
                    self.cleanup()
                    return
                while True:
                    state, param = self.lookup(13)
                    if state == S_EOL:
                        self.eolcnt = 1
                        self.cleanup()
                        return
                    if state == S_TERMB:
                        self.setvalue(param)
                        break
                    if state in (S_MAKEUPB, S_MAKEUP):
                        self.a0 = _i32(self.a0 + param)
                        self.run_length = _i32(self.run_length + param)
                    else:
                        self.cleanup()
                        return
                if self.a0 >= self.lastx:
                    self.cleanup()
                    return
                if self.cur[self.pa - 1] == 0 and self.cur[self.pa - 2] == 0:
                    self.pa -= 2
        except _Eof:
            self.cleanup()                            # Fax3PrematureEOF: a warning
            raise

    def check_b1(self) -> None:
        if self.pa != 0:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.nruns:
                    raise _Fail("a reference run array overflow")
                self.b1 = _i32(self.b1 + self.ref[self.pb] + self.ref[self.pb + 1])
                self.pb += 2

    def expand2d(self) -> None:
        """EXPAND2D to its ``eol2d``; an end of the data raises ``_Eof``
        after the runs are cleaned up (its ``eof2d``)."""
        lastx = self.lastx
        try:
            while self.a0 < lastx:
                if self.pa >= self.nruns:
                    raise _Fail("a run array overflow")
                state, param = self.lookup(7)
                if state == S_PASS:
                    self.check_b1()
                    if self.pb + 1 >= self.nruns:
                        raise _Fail("a reference run array overflow")
                    self.b1 = _i32(self.b1 + self.ref[self.pb])
                    self.pb += 1
                    self.run_length = _i32(self.run_length + self.b1 - self.a0)
                    self.a0 = self.b1
                    self.b1 = _i32(self.b1 + self.ref[self.pb])
                    self.pb += 1
                elif state == S_HORIZ:
                    if self.pa & 1:                   # black first
                        good = self._colour_run(13, S_TERMB) and self._colour_run(12, S_TERMW)
                    else:
                        good = self._colour_run(12, S_TERMW) and self._colour_run(13, S_TERMB)
                    if not good:                      # Fax3Unexpected
                        self.cleanup()
                        return
                    self.check_b1()
                elif state == S_V0 or state == S_VR:
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0 + param)
                    if self.pb >= self.nruns:
                        raise _Fail("a reference run array overflow")
                    self.b1 = _i32(self.b1 + self.ref[self.pb])
                    self.pb += 1
                elif state == S_VL:
                    self.check_b1()
                    if self.b1 < self.a0 + param:     # Fax3Unexpected
                        self.cleanup()
                        return
                    self.setvalue(self.b1 - self.a0 - param)
                    self.pb -= 1
                    self.b1 = _i32(self.b1 - self.ref[self.pb])
                elif state == S_EXT:                  # uncompressed mode: Fax3Extension
                    self.cur[self.pa] = (lastx - self.a0) & _M
                    self.pa += 1
                    self.cleanup()
                    return
                else:                                 # S_EOL
                    self.cur[self.pa] = (lastx - self.a0) & _M
                    self.pa += 1
                    self.need8(4)
                    self.clear(4)                     # not zero: Fax3Unexpected, read on
                    self.eolcnt = 1
                    self.cleanup()
                    return
            if self.run_length:
                if self.run_length + self.a0 < lastx:
                    self.need8(1)                     # a final V0
                    if not self.bits(1):
                        self.cleanup()
                        return
                    self.clear(1)
                self.setvalue(0)
            self.cleanup()
        except _Eof:
            self.cleanup()
            raise

    def align(self, mode: int) -> None:
        """Fax3DecodeRLE's row end: the bits left of the byte, or of the
        16-bit word of the file, passed over."""
        if mode == FAX_RLE:
            self.clear(self.avail & 7)
        else:
            self.clear(self.avail & 15)
            if self.avail == 0 and (self.parity + self.cp) & 1:
                self.cp += 1


def _fill(row: np.ndarray, runs: list, pa: int, lastx: int) -> None:
    """``_TIFFFax3fillruns``: the runs, white first, as bits (1 black) of
    the row; a run past ``lastx`` is cut (in the array too, which becomes
    the next row's reference); the bits past ``lastx`` are left alone."""
    if pa & 1 and pa < len(runs):
        runs[pa] = 0
        pa += 1
    bits = np.unpackbits(row)
    x = 0
    for k in range(pa):
        run = runs[k]
        if (x + run) & _M > lastx or run > lastx:
            run = runs[k] = (lastx - x) & _M
        if run:
            bits[x:x + run] = k & 1
            x = (x + runs[k]) & _M
    row[:] = np.packbits(bits)


class FaxCarry:
    """What libtiff's CCITT codec keeps from one strip to the next of a
    file: its two run arrays (``Fax3PreDecode`` resets only the first two
    runs of the reference, so a damaged row can read runs of an earlier
    strip's rows), zeros at first, and Group 3's decode-without-EOL mode."""

    def __init__(self, compression: int, options: int, width: int):
        self.two_d = compression == FAX_G4 or (compression == FAX_G3
                                               and bool(options & GROUP3OPT_2DENCODING))
        nruns = (width + 1 + 31) // 32 * 32 * (2 if self.two_d else 1)
        self.runs = np.zeros((2, nruns + 1), np.uint32)   # one more for the fill's padding
        self.no_eol = False


def fax_decode_python(data: bytes, parity: int, compression: int, width: int, rows: int,
                      buf: np.ndarray, carry: FaxCarry) -> None:
    """libtiff's CCITT decoder of one strip: ``rows`` rows of ``width``
    pixels into ``buf`` ((rows, row bytes) uint8, the strip buffer, whose
    bytes it does not write stay as they were). ``parity``: the strip's
    file offset modulo 2 (RLEW aligns to the file's words); ``carry``: the
    codec's state from the file's earlier strips, updated. Raises a
    ``ValueError`` where libtiff returns -1.

    Group 3 rows start after an EOL. Where the data ends before one
    (``noEOLFound``), libtiff 4.7 decodes on without EOLs: the strip's
    data again from its first bit, into the rows not yet written, and every
    later strip of the file without EOLs too."""
    two_d, no_eol = carry.two_d, carry.no_eol
    first, second = carry.runs[0].tolist(), carry.runs[1].tolist()
    second[0], second[1] = width, 0                      # the reference: one white run
    st = _Fax(data, parity, width, first, second)
    line = 0
    try:
        while line < rows:
            st.a0 = st.run_length = st.pa = 0
            try:
                if compression in (FAX_RLE, FAX_RLEW):
                    st.expand1d()
                elif compression == FAX_G4:
                    st.pb, st.b1 = 1, st.ref[0]
                    st.expand2d()
                    if st.eolcnt:
                        raise _Eof
                else:
                    try:
                        if not no_eol:
                            try:
                                st.sync_eol()
                            except _NoEol:            # Fax3TryG3WithoutEOL: from the start
                                no_eol = True
                                st.cp = st.acc = st.avail = st.eolcnt = 0
                                continue
                        if two_d:
                            st.need8(1)
                            one_d = st.bits(1)
                            st.clear(1)
                    except _Eof:
                        st.cleanup()
                        raise
                    st.pb, st.b1 = 1, st.ref[0]
                    if not two_d or one_d:
                        st.expand1d()
                    else:
                        st.expand2d()
            except _Eof:
                if compression != FAX_G4:
                    _fill(buf[line], st.cur, st.pa, width)
                    raise ValueError(f"premature end of CCITT data at line {line} "
                                     "(libtiff fails the strip)") from None
                # Fax4Decode's EOFG4: the EOFB (or the end) ends the strip
                try:
                    st.need16(13)
                except _Eof:
                    pass
                st.clear(13)
                _fill(buf[line], st.cur, st.pa, width)
                if line == 0:
                    raise ValueError("CCITT Group 4 data ends before its first row "
                                     "(libtiff fails the strip)") from None
                return
            _fill(buf[line], st.cur, st.pa, width)
            if compression in (FAX_RLE, FAX_RLEW):
                st.align(compression)
            elif two_d and (compression == FAX_G4 or st.pa < st.nruns):
                st.setvalue(0)                            # the imaginary change of the reference
                st.cur, st.ref = st.ref, st.cur
            elif two_d:
                st.cur, st.ref = st.ref, st.cur
            line += 1
    except _Fail as err:
        raise ValueError(f"{err} at line {line} (libtiff fails the strip)") from None
    finally:
        carry.runs[0], carry.runs[1], carry.no_eol = first, second, no_eol


# ------------------------------------------------------------- ThunderScan

_TWO_BIT = (0, 1, 0, -1)
_THREE_BIT = (0, 1, 2, 3, 0, -3, -2, -1)


def thunder_decode(data: bytes, width: int, rows: int) -> bytes:
    """``ThunderDecodeRow``: ``rows`` rows of ``width`` 4-bit pixels, each
    row's codes read on from the last (the last pixel back to 0): a run
    repeats it, 2-bit and 3-bit deltas change it (2 and 4 skip), a raw code
    sets it. A row of other than ``width`` pixels fails the strip, as
    libtiff's "Not enough data" and "Too much data" do."""
    row_bytes = (width + 1) // 2
    out = bytearray(row_bytes * rows + 1)          # a run may write one byte past a row
    pos, n_data = 0, len(data)
    for y in range(rows):
        op = y * row_bytes
        last = npixels = 0

        def put(v):
            nonlocal last, npixels, op
            last = v & 0xF
            if npixels < width:
                if npixels & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npixels += 1

        while pos < n_data and npixels < width:
            n = data[pos]
            pos += 1
            code = n & 0xC0
            if code == 0x00:                       # a run of the last pixel
                n &= 0x3F
                if npixels & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    npixels += 1
                    n -= 1
                else:
                    last |= last << 4
                npixels += n
                if npixels <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:
                for shift in (4, 2, 0):
                    delta = (n >> shift) & 3
                    if delta != 2:
                        put(last + _TWO_BIT[delta])
            elif code == 0x80:
                for shift in (3, 0):
                    delta = (n >> shift) & 7
                    if delta != 4:
                        put(last + _THREE_BIT[delta])
            else:
                put(n)
        if npixels != width:
            raise ValueError(f"{'Not enough' if npixels < width else 'Too much'} ThunderScan "
                             f"data at row {y} ({npixels} != {width}; libtiff fails the strip)")
    return bytes(out[:row_bytes * rows])


# ------------------------------------------------------------------- LZMA

def lzma_decode(data: bytes, cap: int) -> bytes:
    """``LZMADecode``: the xz stream inflated until the strip's ``cap``
    bytes are out; what lies past them is not looked at, and an error or
    an end before them fails the strip."""
    dec = lzma.LZMADecompressor(lzma.FORMAT_XZ)
    try:
        out = dec.decompress(data, cap)
    except lzma.LZMAError as err:
        # liblzma may report the error in the call that fills the strip, and
        # Python drops that call's output: run libtiff's loop on liblzma
        out = _liblzma_strip(data, cap)
        if len(out) < cap:
            raise ValueError(f"LZMA decoding error ({err}; libtiff fails the strip)") from None
    if len(out) < cap:
        raise ValueError(f"LZMA data ends {cap - len(out)} bytes short of the strip (libtiff "
                         "fails it)")
    return out[:cap]


def _liblzma_strip(data: bytes, cap: int) -> bytes:
    """``LZMADecode``'s loop on the liblzma that Python's ``lzma`` links:
    ``lzma_code`` until the strip is full, the stream ends or it errs; what
    came out before an error in the call that filled the strip counts."""
    import ctypes
    import ctypes.util

    class Stream(ctypes.Structure):
        _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                    ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                    ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                    ("rest", ctypes.c_uint8 * 256)]          # LZMA_STREAM_INIT: zeros

    found = ctypes.util.find_library("lzma")
    if found is None:
        return b""
    lib = ctypes.CDLL(found)
    lib.lzma_stream_decoder.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.lzma_code.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lzma_end.argtypes = [ctypes.c_void_p]
    stream = Stream()
    src = ctypes.create_string_buffer(data, len(data))
    out = ctypes.create_string_buffer(max(cap, 1))
    if lib.lzma_stream_decoder(ctypes.byref(stream), (1 << 64) - 1, 0):
        return b""
    stream.next_in, stream.avail_in = ctypes.addressof(src), len(data)
    stream.next_out, stream.avail_out = ctypes.addressof(out), cap
    try:
        while stream.avail_out > 0:
            if lib.lzma_code(ctypes.byref(stream), 0) != 0:   # not LZMA_OK: the end or an error
                break
    finally:
        lib.lzma_end(ctypes.byref(stream))
    return out.raw[:cap - stream.avail_out]


# -------------------------------------------------------------- Zstandard

_ZSTD_MAGIC = 0xFD2FB528
_BLOCK_MAX = 1 << 17                   # ZSTD_BLOCKSIZE_MAX
_WINDOW_MAX = 1 << 27                  # libzstd's default ZSTD_d_windowLogMax
_LONGNBSEQ = 0x7F00
_MIN_LITERALS_FOR_4_STREAMS = 6
_HUF_TABLELOG_MAX = 12

LL_BASE = tuple(range(16)) + (16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536)
LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
ML_BASE = tuple(range(3, 35)) + (35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                 2051, 4099, 8195, 16387, 32771, 65539)
ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
OF_BASE = (0, 1) + tuple((1 << c) - 3 for c in range(2, 32))   # libzstd's OF_base
OF_BITS = tuple(range(32))
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1,
              1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5
# (max symbol, max accuracy log, bases, extra bits, predefined counts, its log)
_SEQ_KINDS = {"LL": (35, 9, LL_BASE, LL_BITS, LL_DEFAULT, 6),
              "OF": (31, 8, OF_BASE, OF_BITS, OF_DEFAULT, 5),
              "ML": (52, 9, ML_BASE, ML_BITS, ML_DEFAULT, 6)}


class ZstdError(ValueError):
    """Where libzstd's ``ZSTD_decompressStream`` returns an error."""


def _highbit(v: int) -> int:
    return v.bit_length() - 1


def read_ncount(data: bytes, pos: int, end: int, max_symbol: int):
    """``FSE_readNCount``: a table description's normalised counts (-1 a
    "less than one") -> (counts, accuracy log, the position after it)."""
    avail = end - pos
    window = data[pos:end] + bytes(8)
    if avail <= 0:
        raise ZstdError("an empty FSE table description")

    def peek(bit: int, n: int) -> int:
        return (int.from_bytes(window[bit >> 3:(bit >> 3) + 5], "little") >> (bit & 7)) & \
            ((1 << n) - 1)

    log = (window[0] & 15) + 5
    if log > 15:
        raise ZstdError("an FSE accuracy log over 15")
    bit, remaining, threshold, nbits = 4, (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while True:
        if previous0:
            while peek(bit, 2) == 3:
                counts += [0] * 3
                bit += 2
            counts += [0] * peek(bit, 2)
            bit += 2
            if len(counts) >= max_symbol + 1:
                break
        mx = 2 * threshold - 1 - remaining
        low = peek(bit, nbits - 1)
        if low < mx:
            count, bit = low, bit + nbits - 1
        else:
            count = peek(bit, nbits)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = _highbit(remaining) + 1
            threshold = 1 << (nbits - 1)
        if len(counts) >= max_symbol + 1:
            break
    if remaining != 1:
        raise ZstdError("an FSE table description whose counts do not add up")
    if len(counts) > max_symbol + 1:
        raise ZstdError("an FSE table description of too many symbols")
    size = (bit + 7) >> 3
    if size > avail:
        raise ZstdError("an FSE table description past its section")
    return counts, log, pos + size


def build_fse(counts, log: int, bases=None, extra=None):
    """``ZSTD_buildFSETable``: per state (symbol, bits to read, next state
    base) and, with ``bases``, the symbol's base value and extra bits."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("an FSE table that does not spread")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - _highbit(state)
        entry = (s, nb, (state << nb) - size)
        if bases is not None:
            entry += (bases[s], extra[s])
        table.append(entry)
    return table


class _Backward:
    """A backward bit stream (``BIT_DStream_t``): read from its last bit
    down, after the padding ending in the last byte's highest set bit;
    past its first bit it reads zeros (``overflowed``)."""

    def __init__(self, data: bytes, start: int, end: int, unmarked: bool = False):
        if end <= start:
            raise ZstdError("an empty bit stream")
        last = data[end - 1]
        self.data, self.start = data, start
        if last == 0:
            if not unmarked:
                raise ZstdError("a bit stream without its end mark")
            self.pos = (end - start) * 8       # HUF_initFastDStream: no mark, every bit read
        else:
            self.pos = (end - 1 - start) * 8 + _highbit(last)   # bits left

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            i = self.start + (p >> 3)
            chunk = int.from_bytes(self.data[i:i + ((p & 7) + n + 7) // 8], "little")
            return (chunk >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        chunk = int.from_bytes(self.data[self.start:self.start + (p + n + 7) // 8], "little")
        return (chunk << -p) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        v = self.read(n)
        self.pos += n
        return v

    def overflowed(self) -> bool:
        return self.pos < 0

    def done(self) -> bool:
        return self.pos == 0


def _huffman_weights(data: bytes, pos: int, end: int):
    """``HUF_readStats``: the Huffman tree description -> (bits per symbol
    list, table log, position after it)."""
    if pos >= end:
        raise ZstdError("no Huffman tree description")
    head = data[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            raise ZstdError("a Huffman tree description past its section")
        weights = []
        for k in range(n):
            b = data[pos + 1 + k // 2]
            weights.append(b >> 4 if k % 2 == 0 else b & 15)
    else:
        size = head
        if pos + 1 + size > end:
            raise ZstdError("a Huffman tree description past its section")
        counts, log, after = read_ncount(data, pos + 1, pos + 1 + size, 255)
        if log > 6:
            raise ZstdError("a Huffman weight table over accuracy log 6")
        table = build_fse(counts, log)
        bits = _Backward(data, after, pos + 1 + size)
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            if len(weights) > 253:
                raise ZstdError("a Huffman tree of too many weights")
            sym, nb, base = table[s1]
            weights.append(sym)
            s1 = base + bits.read(nb)
            if bits.overflowed():
                weights.append(table[s2][0])
                break
            if len(weights) > 253:
                raise ZstdError("a Huffman tree of too many weights")
            sym, nb, base = table[s2]
            weights.append(sym)
            s2 = base + bits.read(nb)
            if bits.overflowed():
                weights.append(table[s1][0])
                break
    total = 0
    for w in weights:
        if w > _HUF_TABLELOG_MAX:
            raise ZstdError("a Huffman weight over 12")
        if w:
            total += 1 << (w - 1)
    if total == 0:
        raise ZstdError("a Huffman tree of no weights")
    log = _highbit(total) + 1
    if log > _HUF_TABLELOG_MAX:
        raise ZstdError("a Huffman tree deeper than 12")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise ZstdError("a Huffman tree whose last weight is not a power of 2")
    weights.append(_highbit(rest) + 1)
    if sum(1 for w in weights if w == 1) < 2 or sum(1 for w in weights if w == 1) & 1:
        raise ZstdError("a Huffman tree of an odd count of the longest codes")
    nbits = [log + 1 - w if w else 0 for w in weights]
    return nbits, log, pos + 1 + size


def huffman_table(nbits: list, log: int) -> list:
    """The decoding table: for each ``log``-bit prefix (symbol, length),
    codes assigned in order of length, longest first, then of symbol."""
    table = [None] * (1 << log)
    code = 0
    for length in range(log, 0, -1):
        for s, n in enumerate(nbits):
            if n == length:
                span = 1 << (log - length)
                for i in range(code, code + span):
                    table[i] = (s, length)
                code += span
    return table


def _huffman_stream(data: bytes, start: int, end: int, table: list, log: int, n: int,
                    out: bytearray, floor=None) -> None:
    """``n`` symbols of one Huffman stream. libzstd's checked decoder ends
    exactly at the stream's first bit; its fast 4-stream decoder
    (``floor`` the start of the jump table) reads on into the bytes below
    the stream and checks only the count of symbols."""
    if floor is not None:
        if end <= start:
            raise ZstdError("an empty bit stream")
        start = floor
    bits = _Backward(data, start, end, floor is not None)
    top = bits.pos
    consumed = [0] * (n + 1)             # bits read after each symbol, from the stream's end
    for j in range(n):
        s, length = table[bits.peek(log)]
        out.append(s)
        bits.read(length)
        consumed[j + 1] = top - bits.pos
    if floor is None and not bits.done():
        raise ZstdError("a Huffman stream not read to its end")
    pad = (end - start) * 8 - top         # the end mark and the zeros above it
    return [pad + c for c in consumed]


# HUF_selectDecoder's timings (tableTime, decode256Time) of the single- and
# double-symbol decoders by Q, the compressed size in 16ths of the output
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119), (170, 205, 514, 112),
              (177, 199, 539, 110), (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109), (582, 187, 1570, 114),
              (688, 187, 1712, 122), (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202), (1412, 185, 1695, 202))


def _selects_x2(size: int, csize: int) -> bool:
    """``HUF_selectDecoder``: whether libzstd takes the double-symbol
    decoder for 4-stream literals of ``size`` bytes from ``csize``."""
    q = 15 if csize >= size else csize * 16 // size
    t0, d0, t1, d1 = _ALGO_TIME[q]
    time1 = t1 + d1 * (size >> 8)
    return time1 + (time1 >> 5) < t0 + d0 * (size >> 8)


def _fast_loop_x1(starts: list, sizes: list, reads: list, lowest: int, last: int) -> None:
    """``HUF_decompress4X1_usingDTable_internal_fast``'s bounds: the loop
    decodes five symbols a stream at a time while stream 0 has seven bytes
    an iteration above the jump table and stream 3 room, stopping where
    one stream's bytes pass below the one before it; after it, a stream
    whose window lies more than 8 bytes below its start is corruption."""
    ends = [s + z for s, z in zip(starts, sizes)]

    def ip(k, j):
        return ends[k] - 8 - reads[k][j] // 8

    j = 0
    while True:
        iters = min((last - j) // 5, (ip(0, j) - lowest) // 7)
        if iters <= 0 or any(ip(k, j) < ip(k - 1, j) for k in (1, 2, 3)):
            break
        j += 5 * iters
    if any(ip(k, j) < starts[k] - 8 for k in range(4)):
        raise ZstdError("a Huffman stream read past its start (libzstd's fast decoder)")
    return j


def _fast_loop_x2(starts: list, sizes: list, reads: list, lowest: int, counts: list) -> None:
    """``HUF_decompress4X2_usingDTable_internal_fast``'s bounds: the
    double-symbol table (11 bits) decodes two symbols a lookup where both
    codes fit in its 11 bits, else one; the loop runs chunks of at most
    ``min((ip[0] - lowest) / 7, room / 10)`` iterations of five lookups a
    stream until stream 3's output reaches five a iteration, stopping where
    one stream's bytes pass below the one before it. After it, a stream
    past its segment or whose window lies more than 8 bytes below its start
    is corruption. The symbols are those of the plain decode."""
    ends = [s + z for s, z in zip(starts, sizes)]
    done = [0, 0, 0, 0]

    def ip(k):
        return ends[k] - 8 - reads[k][done[k]] // 8

    def lookup(k):
        j, r = done[k], reads[k]
        first = r[j + 1] - r[j]
        done[k] += 2 if j + 2 < len(r) and first + r[j + 2] - r[j + 1] <= 11 else 1

    while True:
        iters = max(0, (ip(0) - lowest) // 7)
        for k in range(4):
            iters = min(iters, (counts[k] - done[k]) // 10)
        olimit = done[3] + 5 * iters
        if done[3] == olimit or any(ip(k) < ip(k - 1) for k in (1, 2, 3)):
            break
        while done[3] < olimit:
            for _ in range(5):
                for k in range(4):
                    lookup(k)
    if any(done[k] > counts[k] or ip(k) < starts[k] - 8 for k in range(4)):
        raise ZstdError("a Huffman stream read past its start (libzstd's fast decoder)")


def _tail_x1(data: bytes, lowest: int, end: int, read: int, table: list, log: int,
             count: int) -> bytes:
    """``HUF_decodeStreamX1`` after the fast loop, ``read`` bits from the
    stream's ``end`` gone: four symbols at a time while ``BIT_reloadDStream``
    finds whole bytes above the section's start (``lowest``), then one at a
    time from the 8 bytes it holds, the bits past them read as
    ``BIT_lookBitsFast`` does (modulo 64)."""
    m64 = (1 << 64) - 1
    ptr, used = end - 8 - read // 8, read % 8

    def window(at):
        return int.from_bytes(data[at:at + 8], "little")

    box = window(ptr)

    def reload():
        nonlocal ptr, used, box
        if used > 64:
            return 3                                  # overflow: nothing moves
        if ptr >= lowest + 8:
            ptr -= used >> 3
            used &= 7
            box = window(ptr)
            return 0
        if ptr == lowest:
            return 1 if used < 64 else 2
        step, result = used >> 3, 0
        if ptr - step < lowest:
            step, result = ptr - lowest, 1
        ptr -= step
        used -= step * 8
        box = window(ptr)
        return result

    out = bytearray()

    def symbol():
        nonlocal used
        look = ((box << (used & 63)) & m64) >> ((64 - 11) & 63)
        s, length = table[look >> (11 - log)]
        out.append(s)
        used += length

    if count > 3:
        while reload() == 0 and len(out) < count - 3:
            for _ in range(4):
                symbol()
    else:
        reload()
    while len(out) < count:
        symbol()
    return bytes(out)


class _Frame:
    """One frame's decoding state: the output, the repeat offsets and the
    tables a later block may repeat."""

    def __init__(self, block_max: int):
        self.out = bytearray()
        self.block_max = block_max
        self.reps = [1, 4, 8]
        self.huffman = None
        self.tables = {}

    def literals(self, data: bytes, pos: int, end: int):
        """The literals section -> (literals, position after it)."""
        if end - pos < 2:
            raise ZstdError("a compressed block too short for its literals")
        b0 = data[pos]
        kind, size_format = b0 & 3, (b0 >> 2) & 3
        if kind in (0, 1):
            if size_format in (0, 2):
                n, head = b0 >> 3, 1
            elif size_format == 1:
                if kind == 1 and end - pos < 3:
                    raise ZstdError("a literals header past its block")
                n, head = int.from_bytes(data[pos:pos + 2], "little") >> 4, 2
            else:
                if end - pos < (3 if kind == 0 else 4):
                    raise ZstdError("a literals header past its block")
                n, head = int.from_bytes(data[pos:pos + 3], "little") >> 4, 3
            if n > self.block_max:
                raise ZstdError("more literals than a block holds")
            if kind == 0:
                if pos + head + n > end:
                    raise ZstdError("raw literals past their block")
                return bytes(data[pos + head:pos + head + n]), pos + head + n
            return bytes([data[pos + head]]) * n, pos + head + 1
        if kind == 3 and self.huffman is None:
            raise ZstdError("treeless literals without an earlier Huffman tree")
        if end - pos < 5:
            raise ZstdError("a compressed literals header past its block")
        lhc = int.from_bytes(data[pos:pos + 4], "little")
        single = size_format == 0
        if size_format in (0, 1):
            head, n, csize = 3, (lhc >> 4) & 0x3FF, (lhc >> 14) & 0x3FF
        elif size_format == 2:
            head, n, csize = 4, (lhc >> 4) & 0x3FFF, lhc >> 18
        else:
            head, n, csize = 5, (lhc >> 4) & 0x3FFFF, (lhc >> 22) + (data[pos + 4] << 10)
        if n > self.block_max:
            raise ZstdError("more literals than a block holds")
        if not single and n < _MIN_LITERALS_FOR_4_STREAMS:
            raise ZstdError("too few literals for 4 streams")
        if pos + head + csize > end:
            raise ZstdError("compressed literals past their block")
        start, stop = pos + head, pos + head + csize
        if kind == 2:
            nbits, log, start = _huffman_weights(data, start, stop)
            huffman = (huffman_table(nbits, log), log,
                       not single and _selects_x2(n, csize))
        else:
            huffman = self.huffman
        table, log = huffman[:2]
        out = bytearray()
        if single:
            _huffman_stream(data, start, stop, table, log, n, out)
        else:
            if stop - start < 10:
                raise ZstdError("4 Huffman streams in under 10 bytes")
            sizes = [int.from_bytes(data[start + 2 * k:start + 2 * k + 2], "little")
                     for k in range(3)]
            sizes.append(stop - start - 6 - sum(sizes))
            if sizes[3] < 0:
                raise ZstdError("Huffman stream sizes past their section")
            segment = (n + 3) // 4
            if 3 * segment > n:
                raise ZstdError("too few literals for 4 streams")
            # HUF_DecompressFastArgs_init: the fast decoder takes streams of 8
            # bytes or more when the table's log is at most 11 and the fourth
            # segment is not empty
            fast = log <= 11 and min(sizes) >= 8 and 3 * segment < n
            at, starts, reads = start + 6, [], []
            for k, size in enumerate(sizes):
                starts.append(at)
                reads.append(_huffman_stream(data, at, at + size, table, log,
                                             segment if k < 3 else n - 3 * segment, out,
                                             start if fast else None))
                at += size
            if fast and huffman[2]:
                _fast_loop_x2(starts, sizes, reads, start,
                              [segment] * 3 + [n - 3 * segment])
            elif fast:
                done = _fast_loop_x1(starts, sizes, reads, start, n - 3 * segment)
                for k in range(4):          # the rest of each stream, as HUF_decodeStreamX1
                    first = k * segment + done
                    count = (segment if k < 3 else n - 3 * segment) - done
                    out[first:first + count] = _tail_x1(data, start, starts[k] + sizes[k],
                                                        reads[k][done], table, log, count)
        self.huffman = huffman
        return bytes(out), stop

    def sequence_table(self, kind: str, mode: int, data: bytes, pos: int, end: int):
        max_symbol, max_log, bases, extra, default, default_log = _SEQ_KINDS[kind]
        if mode == 0:
            table = build_fse(default, default_log, bases, extra)
            log = default_log
        elif mode == 1:
            if pos >= end:
                raise ZstdError("an RLE sequence table past its section")
            s = data[pos]
            if s > max_symbol:
                raise ZstdError("an RLE sequence symbol out of range")
            table, log, pos = [(s, 0, 0, bases[s], extra[s])], 0, pos + 1
        elif mode == 2:
            counts, log, pos = read_ncount(data, pos, end, max_symbol)
            if log > max_log:
                raise ZstdError("a sequence table over its accuracy log")
            table = build_fse(counts, log, bases, extra)
        else:
            if kind not in self.tables:
                raise ZstdError("a repeated sequence table without an earlier one")
            table, log = self.tables[kind]
        self.tables[kind] = (table, log)
        return table, log, pos

    def compressed(self, data: bytes, pos: int, end: int) -> None:
        start_out = len(self.out)
        lits, pos = self.literals(data, pos, end)
        if pos >= end:
            raise ZstdError("a block without its sequences section")
        nseq = data[pos]
        pos += 1
        if nseq > 0x7F:
            if nseq == 0xFF:
                if pos + 2 > end:
                    raise ZstdError("a sequence count past its block")
                nseq = int.from_bytes(data[pos:pos + 2], "little") + _LONGNBSEQ
                pos += 2
            else:
                if pos >= end:
                    raise ZstdError("a sequence count past its block")
                nseq = ((nseq - 0x80) << 8) + data[pos]
                pos += 1
        out = self.out
        if nseq == 0:
            if pos != end:
                raise ZstdError("bytes after a block's last sequence")
            out += lits
        else:
            if pos >= end:
                raise ZstdError("no sequence compression modes")
            modes = data[pos]
            if modes & 3:
                raise ZstdError("reserved bits set in the sequence modes")
            pos += 1
            ll, ll_log, pos = self.sequence_table("LL", modes >> 6, data, pos, end)
            of, of_log, pos = self.sequence_table("OF", (modes >> 4) & 3, data, pos, end)
            ml, ml_log, pos = self.sequence_table("ML", (modes >> 2) & 3, data, pos, end)
            bits = _Backward(data, pos, end)
            s_ll, s_of, s_ml = bits.read(ll_log), bits.read(of_log), bits.read(ml_log)
            reps, lit_pos = self.reps, 0
            for k in range(nseq):
                ll_e, of_e, ml_e = ll[s_ll], of[s_of], ml[s_ml]
                of_bits = of_e[4]
                ll0 = ll_e[3] == 0
                if of_bits > 1:
                    offset = of_e[3] + bits.read(of_bits)
                    reps[2], reps[1], reps[0] = reps[1], reps[0], offset
                elif of_bits == 0:
                    offset = reps[int(ll0)]
                    reps[1] = reps[int(not ll0)]
                    reps[0] = offset
                else:
                    code = of_e[3] + int(ll0) + bits.read(1)
                    offset = reps[0] - 1 if code == 3 else reps[code]
                    if offset == 0:
                        offset = -1
                    if code != 1:
                        reps[2] = reps[1]
                    reps[1], reps[0] = reps[0], offset
                match = ml_e[3] + bits.read(ml_e[4])
                litlen = ll_e[3] + bits.read(ll_e[4])
                if k < nseq - 1:
                    s_ll = ll_e[2] + bits.read(ll_e[1])
                    s_ml = ml_e[2] + bits.read(ml_e[1])
                    s_of = of_e[2] + bits.read(of_e[1])
                if litlen > len(lits) - lit_pos:
                    raise ZstdError("a sequence reads past its literals")
                out += lits[lit_pos:lit_pos + litlen]
                lit_pos += litlen
                if offset <= 0 or offset > len(out):
                    raise ZstdError("a match offset before the start of the frame")
                if len(out) + match - start_out > self.block_max:
                    raise ZstdError("a block decodes past its maximum size")
                src = len(out) - offset
                if offset >= match:
                    out += out[src:src + match]
                else:
                    for i in range(match):
                        out.append(out[src + i])
            if not bits.done():
                raise ZstdError("a sequence bit stream not read to its end")
            out += lits[lit_pos:]
        if len(out) - start_out > self.block_max:
            raise ZstdError("a block decodes past its maximum size")


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame's content checksum is its low 32 bits)."""
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
    p4, p5, m = 9650029242287828579, 2870177450012600261, (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    n, p = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed, (seed - p1) & m]
        lanes = np.frombuffer(bytes(data[:n // 32 * 32]), "<u8").reshape(-1, 4).tolist()
        for row in lanes:
            v = [rnd(v[i], row[i]) for i in range(4)]
        p = n // 32 * 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for x in v:
            h = ((h ^ rnd(0, x)) * p1 + p4) & m
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while p + 8 <= n:
        h ^= rnd(0, int.from_bytes(data[p:p + 8], "little"))
        h = (rotl(h, 27) * p1 + p4) & m
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(data[p:p + 4], "little") * p1 & m
        h = (rotl(h, 23) * p2 + p3) & m
        p += 4
    while p < n:
        h ^= data[p] * p5 & m
        h = rotl(h, 11) * p1 & m
        p += 1
    h ^= h >> 33
    h = h * p2 & m
    h ^= h >> 29
    h = h * p3 & m
    return h ^ (h >> 32)


def _frame_header(data: bytes):
    """The frame header -> (position after it, window size, content size or
    None, checksum flag)."""
    n = len(data)
    if n < 4:
        raise ZstdError("a Zstandard frame cut short")
    magic = int.from_bytes(data[:4], "little")
    if magic & 0xFFFFFFF0 == 0x184D2A50:
        raise ZstdError("a skippable frame first (libzstd ends the stream there, short of "
                        "the strip)")
    if magic != _ZSTD_MAGIC:
        raise ZstdError("not a Zstandard frame (unknown magic number)")
    if n < 5:
        raise ZstdError("a Zstandard frame header cut short")
    fhd = data[4]
    fcs_code, single, checksum, dict_code = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    size = 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_code] + \
        (1 if single and fcs_code == 0 else (0, 2, 4, 8)[fcs_code])
    if n < size:
        raise ZstdError("a Zstandard frame header cut short")
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    pos, window = 5, None
    if not single:
        wd = data[5]
        wlog = (wd >> 3) + 10
        if wlog > 31:
            raise ZstdError("a window over 2^31")
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
        pos = 6
    dsize = (0, 1, 2, 4)[dict_code]
    dict_id = int.from_bytes(data[pos:pos + dsize], "little")
    pos += dsize
    fsize = 1 if single and fcs_code == 0 else (0, 2, 4, 8)[fcs_code]
    content = None
    if fsize:
        content = int.from_bytes(data[pos:pos + fsize], "little") + (256 if fsize == 2 else 0)
    pos += fsize
    if single:
        window = content
    if dict_id:
        raise ZstdError("a frame that needs a dictionary")
    window = max(window, 1 << 10)
    if window > _WINDOW_MAX:
        raise ZstdError("a frame window over libzstd's limit of 2^27")
    return pos, window, content, checksum


def zstd_decode_python(data: bytes, cap: int) -> bytes:
    """``ZSTDDecode`` of one strip: the first frame's content until the
    strip's ``cap`` bytes are out. libzstd reads on past them to the end of
    the block it is in, and one block (or the checksum) more where they end
    at a block's end; a frame whose content size is known and fits the strip
    is decoded whole and checked. An error there, or content short of the
    strip, fails the strip."""
    pos, window, content, checksum = _frame_header(data)
    block_max = min(window, _BLOCK_MAX)
    whole = content is not None and content <= cap
    frame = _Frame(block_max)
    out = frame.out
    ahead = False                        # one block read past the strip
    while True:
        if pos + 3 > len(data):
            raise ZstdError("a Zstandard frame cut short (libtiff: not enough data)")
        head = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        pos += 3
        if kind == 3:
            raise ZstdError("a reserved block type")
        stored = 1 if kind == 1 else size
        if kind != 1 and size > block_max:
            raise ZstdError("a block over its maximum size")
        if kind == 0 and not whole:
            out += data[pos:pos + size]      # streamed as it comes, a cut block too
            if pos + size > len(data):
                break
        elif pos + stored > len(data):
            raise ZstdError("a Zstandard block cut short (libtiff: not enough data)")
        elif kind == 0:
            out += data[pos:pos + size]
        elif kind == 1:
            if size > block_max:
                raise ZstdError("an RLE block over its maximum size")
            out += bytes([data[pos]]) * size
        else:
            frame.compressed(data, pos, pos + size)
        pos += stored
        if content is not None and len(out) > content:
            raise ZstdError("a frame longer than its content size")
        if last:
            if content is not None and len(out) != content:
                raise ZstdError("a frame shorter than its content size")
            if checksum and (whole or len(out) <= cap):
                if pos + 4 <= len(data):
                    if int.from_bytes(data[pos:pos + 4], "little") != xxh64(out) & 0xFFFFFFFF:
                        raise ZstdError("the frame's content checksum is wrong")
                elif whole:
                    raise ZstdError("a Zstandard frame cut short at its checksum")
            break
        if not whole and (ahead or len(out) > cap):
            break
        if not whole and len(out) == cap:
            ahead = True
    if len(out) < cap:
        raise ValueError(f"Zstandard data ends {cap - len(out)} bytes short of the strip "
                         "(libtiff fails it)")
    return bytes(out[:cap])
