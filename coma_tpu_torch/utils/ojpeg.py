"""Old-style JPEG TIFFs (compression 6) as Pillow 12.1.0 reads them through
libtiff 4.7.1's ``tif_ojpeg.c``.

libtiff rebuilds one JPEG stream for the whole image and hands it to
libjpeg: SOI, the quantisation and Huffman tables, a DRI, the SOF and the
SOS, then the entropy-coded data and an EOI. Two layouts are read:

- ``JPEGInterchangeFormat`` (513) and its length (514) point at a JPEG
  stream whose markers, up to the SOS, give the tables and the frame; the
  data goes on from there, through the strips' bytes;
- without it, the tags ``JPEGQTables`` (519), ``JPEGDCTables`` (520) and
  ``JPEGACTables`` (521) point at the tables, one a component, and the
  strips hold only entropy-coded data; libtiff writes a baseline SOF of the
  strip width and the image height and an SOS of components 0, 1 and 2.

Between strips libtiff puts a restart marker, and the restart interval is
one strip's MCUs where the image has more than one strip (a DRI in the
stream, else the ``JPEGRestartInterval`` tag, overrides it).

Where the first component's sampling factors are 1, 2 or 4 and the other
components' 1 x 1, libjpeg hands libtiff raw YCbCr (no upsampling), and
libtiff's ``TIFFRGBAImage`` (Pillow reads YCbCr TIFFs through it) spreads
each chroma sample over its block and converts with ``TIFFYCbCrtoRGB``,
from ``YCbCrCoefficients`` (529) and ``ReferenceBlackWhite`` (532). Other
factors are upsampled inside libjpeg (its fancy upsampling, no colour
conversion) and converted the same way. A one-sample image is read as its
samples ("L"). Pillow forces photometric 6 for this compression, so its
mode is RGB for three samples and L for one; libtiff takes the file's
photometric, and Pillow refuses what the two make of any other (an RGB
photometric, planes, more than one column of tiles).
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils import jpeg
from coma_tpu_torch.utils.modes import Decoded

_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)
_F = np.float32


def _fix(x) -> int:
    """``FIX``: the float times 2^16, plus 0.5 in double, truncated."""
    return int(float(_F(x) * _F(1 << _SHIFT)) + 0.5)


def _clamp(f, lo, hi):
    return lo if not f >= lo else hi if f > hi else f


def _code2v(c: int, rb, rw, cr: int):
    """``Code2V`` in float: (c - (int)RB) * CR / (RW - RB, or 1)."""
    den = _F(rw) - _F(rb)
    return _F(_F(c - int(_F(rb))) * _F(cr)) / (den if den != 0 else _F(1))


def ycbcr_tables(luma, ref_black_white) -> tuple:
    """``TIFFYCbCrToRGBInit``: the (Cr_r, Cb_b, Cr_g, Cb_g, Y) tables of
    256 int32 each."""
    red, green, blue = (_F(v) for v in luma)
    rbw = [_F(v) for v in ref_black_white]
    f1 = _F(2) - _F(2) * red
    d1 = _fix(_clamp(f1, _F(0), _F(2)))
    f2 = red * f1 / green
    d2 = -_fix(_clamp(f2, _F(0), _F(2)))
    f3 = _F(2) - _F(2) * blue
    d3 = _fix(_clamp(f3, _F(0), _F(2)))
    f4 = blue * f3 / green
    d4 = -_fix(_clamp(f4, _F(0), _F(2)))
    lim = _F(128 * 32)
    cr_r, cb_b, cr_g, cb_g, y_tab = ([0] * 256 for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = int(_clamp(_code2v(x, rbw[4] - _F(128), rbw[5] - _F(128), 127), -lim, lim))
        cb = int(_clamp(_code2v(x, rbw[2] - _F(128), rbw[3] - _F(128), 127), -lim, lim))
        cr_r[i] = (d1 * cr + _ONE_HALF) >> _SHIFT
        cb_b[i] = (d3 * cb + _ONE_HALF) >> _SHIFT
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + _ONE_HALF
        y_tab[i] = int(_clamp(_code2v(x + 128, rbw[0], rbw[1], 255), -lim, lim))
    return tuple(np.array(t, np.int64) for t in (cr_r, cb_b, cr_g, cb_g, y_tab))


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` of 8-bit samples -> (..., 3) uint8."""
    cr_r, cb_b, cr_g, cb_g, y_tab = tables
    yy = y_tab[y]
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> _SHIFT)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class _Source:
    """``OJPEGReadBufferFill``'s bytes: the JPEGInterchangeFormat stream,
    then each strip's (a strip at or past the end of the file has none, one
    of no byte count runs to the end of the file)."""

    def __init__(self, data: bytes, jif: int, jif_len: int, offsets, counts):
        size = len(data)
        self.segments = []                  # (bytes, is a strip)
        if jif:
            self.segments.append((data[jif:jif + jif_len], False))
        for off, count in zip(offsets, counts):
            if off == 0 or off >= size:
                continue
            if count == 0 or off + count > size:
                count = size - off
            self.segments.append((data[off:off + count], True))
        self.seg, self.pos = 0, 0

    def peek(self):
        while self.seg < len(self.segments) and self.pos >= len(self.segments[self.seg][0]):
            self.seg, self.pos = self.seg + 1, 0
        if self.seg >= len(self.segments):
            return None
        return self.segments[self.seg][0][self.pos]

    def byte(self) -> int:
        b = self.peek()
        if b is None:
            raise ValueError("the old-style JPEG data ends inside its markers (libtiff refuses "
                             "it)")
        self.pos += 1
        return b

    def word(self) -> int:
        return self.byte() << 8 | self.byte()

    def take(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def rest(self) -> bytes:
        """The compressed data from here: a restart marker after each strip
        whose bytes run out while more strips follow, then the EOI."""
        out, restart = bytearray(), 0
        strips_left = sum(1 for _, strip in self.segments[self.seg:] if strip)
        for k in range(self.seg, len(self.segments)):
            chunk, strip = self.segments[k]
            piece = chunk[self.pos:] if k == self.seg else chunk
            out += piece
            if strip:
                strips_left -= 1
                if piece and strips_left:
                    out += bytes([0xFF, 0xD0 + restart])
                    restart = (restart + 1) % 8
        return bytes(out) + b"\xff\xd9"


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def decode_ojpeg(data: bytes, ifd, lt, name: str, native=None) -> Decoded:
    """An old-style JPEG TIFF's first page -> Pillow's array and mode:
    ``ifd`` Pillow's view of the directory (the mode), ``lt`` libtiff's
    (the rest)."""
    width, height = ifd.get(256, (0,))[0], ifd.get(257, (0,))[0]
    photometric = lt.get(262, (6,))[0]        # libtiff takes a missing one for YCbCr
    spp = ifd.get(277, (3,))[0]
    bps = tuple(ifd.get(258, (1,)))
    bps = bps[:spp] if len(bps) >= spp else bps * spp if len(bps) == 1 else bps
    if bps not in ((8,), (8, 8, 8)) or len(bps) != spp or ifd.get(338) or \
            ifd.get(266, (1,))[0] != 1 or any(f != 1 for f in ifd.get(339, (1,))):
        raise ValueError(f"{name}: an old-style JPEG TIFF of {spp} samples of {bps} bits has "
                         "no mode in Pillow (which forces photometric 6)")
    if lt.get(284, (1,))[0] != 1 and spp > 1:
        raise ValueError(f"{name}: an old-style JPEG TIFF in planes (Pillow refuses it)")
    ycbcr = photometric == 6
    if spp == 3 and not ycbcr:
        raise ValueError(f"{name}: an old-style JPEG TIFF of photometric {photometric} (Pillow "
                         "unpacks it as RGBX and refuses it)")
    if spp == 1 and ycbcr:
        raise ValueError(f"{name}: a one-sample YCbCr old-style JPEG TIFF (libtiff's RGBA "
                         "reader refuses it)")
    tiled = 273 not in lt.tags and 324 in lt.tags
    if tiled:
        sw, sl = lt.get(322, (0,))[0], lt.get(323, (0,))[0]
        if not sw or not sl:
            raise ValueError(f"{name}: a tiled TIFF without its tile size")
        total = -(-height // sl) * sl
        offsets, counts = lt.get(324), lt.get(325, ())
    else:
        sw, sl = width, min(lt.get(278, (height,))[0], height) or height
        total = height
        offsets, counts = lt.get(273), lt.get(279, ())
    if not width or not height or offsets is None:
        raise ValueError(f"{name}: a TIFF without size or image data")
    counts = tuple(counts) + (0,) * (len(offsets) - len(counts))
    jif = lt.get(513, (0,))[0]
    jif_len = lt.get(514, (0,))[0]
    if jif >= len(data):
        jif = jif_len = 0
    elif jif and (jif_len == 0 or jif + jif_len > len(data)):
        jif_len = len(data) - jif

    # OJPEGSubsamplingCorrect: the first SOF's factors where the stream has one
    sub = lt.get(530, (2, 2))
    hor, ver = sub[:2] if len(sub) >= 2 else (2, 2)
    force = False
    if spp == 3:
        src = _Source(data, jif, jif_len, offsets, counts)
        while src.peek() == 0xFF:
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if m in (0xC0, 0xC1, 0xC3):
                length = src.word()
                if length < 11 or (length - 8) % 3:
                    break
                body = src.take(length - 2)
                if body[0] != 8 or body[5] != (length - 8) // 3:
                    break
                factors = [body[7 + 3 * k] for k in range(body[5])]
                hor, ver = factors[0] >> 4, factors[0] & 15
                force = hor not in (1, 2, 4) or ver not in (1, 2, 4) or \
                    any(f != 0x11 for f in factors[1:])
                break
            if m == 0xDA or not (0xC4 <= m <= 0xFE):
                break
            length = src.word()
            if length < 2:
                break
            src.take(length - 2)
        if force:
            hor, ver = 1, 1
    else:
        hor, ver = 1, 1

    restart = lt.get(515, (0,))[0]
    if sl < height:
        if hor not in (1, 2, 4) or ver not in (1, 2, 4):
            raise ValueError(f"{name}: invalid subsampling values (libtiff refuses them)")
        if sl % (ver * 8):
            raise ValueError(f"{name}: incompatible vertical subsampling and strip or tile "
                             "length (libtiff refuses it)")
        restart = -(-sw // (hor * 8)) * (sl // (ver * 8))

    # OJPEGReadHeaderInfoSec: the markers up to the SOS
    src = _Source(data, jif, jif_len, offsets, counts)
    qtables, dctables, actables = [None] * 4, [None] * 4, [None] * 4
    sof = None
    sos = [(0, 0)] * spp              # libtiff's zeros where the stream has no SOS
    try:
        while src.peek() == 0xFF:
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if m == 0xFE or 0xE0 <= m <= 0xEF:
                n = src.word()
                if n < 2:
                    raise ValueError("corrupt JPEG data")
                src.take(n - 2)
            elif m == 0xDD:
                if src.word() != 4:
                    raise ValueError("corrupt DRI marker")
                restart = src.word()
            elif m == 0xDB:
                n = src.word()
                if n <= 2:
                    raise ValueError("corrupt DQT marker")
                n -= 2
                while n > 0:
                    if n < 65:
                        raise ValueError("corrupt DQT marker")
                    body = src.take(65)
                    if body[0] & 15 > 3:
                        raise ValueError("corrupt DQT marker")
                    qtables[body[0] & 15] = _segment(0xDB, body)
                    n -= 65
            elif m == 0xC4:
                n = src.word()
                if n <= 2:
                    raise ValueError("corrupt DHT marker")
                body = src.take(n - 2)
                o = body[0]
                if o & 0xF0 == 0 and o <= 3:
                    dctables[o] = _segment(0xC4, body)
                elif o & 0xF0 == 0x10 and o & 15 <= 3:
                    actables[o & 15] = _segment(0xC4, body)
                else:
                    raise ValueError("corrupt DHT marker")
            elif m in (0xC0, 0xC1, 0xC3):
                if sof is not None:
                    raise ValueError("corrupt JPEG data (a second SOF)")
                n = src.word()
                if n < 11 or (n - 8) % 3:
                    raise ValueError("corrupt SOF marker")
                if (n - 8) // 3 != spp:
                    raise ValueError("the JPEG data has an unexpected number of samples")
                if src.byte() != 8:
                    raise ValueError("the JPEG data has an unexpected number of bits a sample")
                sof_y, sof_x = src.word(), src.word()
                if sof_y < height and sof_y < total:
                    raise ValueError("the JPEG data has an unexpected height")
                if sof_x < width and sof_x < sw:
                    raise ValueError("the JPEG data has an unexpected width")
                if sof_x > sw:
                    raise ValueError("the JPEG data's width exceeds the image's")
                if src.byte() != spp:
                    raise ValueError("corrupt SOF marker")
                comps = []
                for k in range(spp):
                    cid, hv, tq = src.byte(), src.byte(), src.byte()
                    if not force and hv != ((hor << 4) | ver if k == 0 else 0x11):
                        raise ValueError("the JPEG data has unexpected subsampling values")
                    comps.append((cid, hv, tq))
                sof = (m, sof_y, sof_x, comps)
            elif m == 0xDA:
                if sof is None:
                    raise ValueError("corrupt SOS marker (before the SOF)")
                if src.word() != 6 + 2 * spp or src.byte() != spp:
                    raise ValueError("corrupt SOS marker")
                sos = [(src.byte(), src.byte()) for _ in range(spp)]
                src.take(3)
                break
            else:
                raise ValueError(f"unknown marker 0x{m:02X} in the JPEG data")
    except ValueError as err:
        raise ValueError(f"{name}: {err} (libtiff refuses it)") from None
    if sof is None:                   # the tag-only layout: tables from the tags
        sof, sos = _tables_from_tags(data, lt, spp, hor, ver, sw, total, qtables, dctables,
                                     actables, name)
    marker, sof_y, sof_x, comps = sof
    head = b"\xff\xd8" + b"".join(t for t in qtables + dctables + actables if t is not None)
    if restart & 0xFFFF:
        head += _segment(0xDD, (restart & 0xFFFF).to_bytes(2, "big"))   # libtiff's uint16_t
    head += _segment(marker, bytes([8]) + (sof_y & 0xFFFF).to_bytes(2, "big")
                     + (sof_x & 0xFFFF).to_bytes(2, "big")
                     + bytes([spp]) + bytes(b for c in comps for b in c))
    head += _segment(0xDA, bytes([spp]) + bytes(b for s in sos for b in s) + b"\x00\x3f\x00")
    stream = head + src.rest()

    frame = jpeg.decode_coefficients(stream, name, native, libtiff=True, resync=False)
    if frame.width != sw:
        raise ValueError(f"{name}: libjpeg's width {frame.width} is not the strip's {sw} "
                         "(libtiff refuses it)")
    if frame.height < height:
        raise ValueError(f"{name}: the JPEG data holds {frame.height} of the image's {height} "
                         "rows")
    if frame.resync_failed is not None and (spp == 1 or force or tiled):
        raise ValueError(f"{name}: {jpeg._NATIVE_ERRORS[3]}; Pillow refuses this layout or "
                         "reads it from buffers the port does not follow")
    if spp == 1:
        return Decoded(jpeg.reconstruct(frame, native, jpeg.GRAY)[:height, :width, 0], "L")
    if not force:
        if (frame.max_h, frame.max_v) != (hor, ver):
            raise ValueError(f"{name}: libjpeg's sampling factors {frame.max_h} x "
                             f"{frame.max_v} are not the expected {hor} x {ver} (libtiff "
                             "refuses it)")
        if (hor << 4 | ver) not in (0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11):
            raise ValueError(f"{name}: YCbCr subsampling {hor} x {ver} (libtiff's RGBA reader "
                             "refuses it)")
        planes = [_raw_plane(frame, i, native) for i in range(3)]
        rows, cols = _session_rows(height, width, tiled, sw, sl, frame.height, 8 * ver)
        unwritten = np.zeros(rows.shape, bool)
        if frame.resync_failed is not None:
            # libtiff fails the strip there; Pillow's RGBA reader converts what
            # that strip's fresh, zeroed buffer holds, but refuses the file when
            # a later strip fails to start
            lines = frame.resync_failed // frame.mcus_x * 8 * ver
            if min(lines, height - 1) // sl < -(-height // sl) - 1:
                raise ValueError(f"{name}: {jpeg._NATIVE_ERRORS[3]}, before the last strip "
                                 "(Pillow refuses it)")
            unwritten = rows >= lines
        y, cb, cr = (np.where(unwritten, 0, p[r, c]) for p, r, c in
                     ((planes[0], rows, cols), (planes[1], rows // ver, cols // hor),
                      (planes[2], rows // ver, cols // hor)))
    elif tiled and sw < width:
        raise ValueError(f"{name}: an old-style JPEG TIFF of more than one column of tiles "
                         "outside libjpeg's raw path (Pillow's tile buffer is left stale) is "
                         "not read")
    else:                             # libjpeg's upsampling, no colour conversion
        px = jpeg.reconstruct(frame, native, jpeg.RGB)[:height, :width]
        y, cb, cr = px[..., 0], px[..., 1], px[..., 2]
    luma = _rationals(lt, 529, (0.299, 0.587, 0.114))
    rbw = _rationals(lt, 532, (0, 255, 128, 255, 128, 255))
    if luma[1] == 0 or any(v != v for v in luma):
        raise ValueError(f"{name}: invalid YCbCrCoefficients (libtiff refuses them)")
    return Decoded(ycbcr_to_rgb(y.astype(np.int64), cb.astype(np.int64), cr.astype(np.int64),
                                ycbcr_tables(luma, rbw)), "RGB")


def _session_rows(height: int, width: int, tiled: bool, sw: int, sl: int, lines: int,
                  imcu: int):
    """(rows, columns) of the decoded JPEG that give the image's pixels. Its
    rows go to the strips, or tiles, in order: the stream is one tile wide
    and as tall as a column of tiles, so a tile past it gets no new lines,
    and libtiff's raw buffer hands out the last iMCU row it read again."""
    rows, cols = np.arange(height)[:, None], np.arange(width)[None, :]
    if not tiled or sw >= width:
        return np.broadcast_to(rows, (height, width)), np.broadcast_to(cols, (height, width))
    index = rows // sl * -(-width // sw) + cols // sw           # the tile, in order
    last = (-(-lines // imcu) - 1) * imcu
    inside = rows % sl
    return np.where(index * sl < lines, index * sl + inside, last + inside % imcu), cols % sw


def _rationals(ifd, tag: int, default) -> tuple:
    values = ifd.rationals.get(tag)
    if values is None:
        return tuple(default)
    return tuple(float(np.float32(n / d)) if d else 0.0 for n, d in values)


def _raw_plane(frame, i: int, native) -> np.ndarray:
    """Component i's samples as libjpeg's raw data gives them: the IDCT of
    its blocks, not upsampled."""
    rows, cols = frame.component_size(i)
    one = jpeg.JpegCoefficients(frame.name, rows, cols, [(frame.ids[i], 1, 1, 0)], False)
    one.coef, one.quant = [frame.coef[i]], [frame.quant[i]]
    return jpeg.reconstruct(one, native, jpeg.GRAY)[..., 0]


def _tables_from_tags(data: bytes, ifd, spp: int, hor: int, ver: int, sw: int, total: int,
                      qtables: list, dctables: list, actables: list, name: str):
    """``OJPEGReadHeaderInfoSecTables*``: a DQT and two DHTs a component from
    the tags' offsets (a component whose offset repeats the one before uses
    its table), a baseline SOF and the SOS."""
    # a tag of more than 3 values is not set; fewer than a value a component
    # leave the rest 0, which repeat the table before
    q_off, dc_off, ac_off = (tuple(ifd.get(t, ()))[:3] if len(ifd.get(t, ())) <= 3 else ()
                             for t in (519, 520, 521))
    q_off, dc_off, ac_off = (o + (0,) * (spp - len(o)) for o in (q_off, dc_off, ac_off))
    if not q_off[0]:
        raise ValueError(f"{name}: missing JPEG tables (libtiff refuses it)")
    if not dc_off[0] or not ac_off[0]:
        raise ValueError(f"{name}: missing JPEG Huffman tables (libtiff refuses it)")

    def read(at: int, n: int) -> bytes:
        if at + n > len(data):
            raise ValueError(f"{name}: a JPEG table runs past the end of the file (libtiff "
                             "refuses it)")
        return data[at:at + n]

    tq, tda = [0] * spp, [0] * spp
    for m in range(spp):
        if q_off[m] and (m == 0 or q_off[m] != q_off[m - 1]):
            if q_off[m] in q_off[:max(m - 1, 0)]:
                raise ValueError(f"{name}: corrupt JPEGQTables (libtiff refuses it)")
            qtables[m] = _segment(0xDB, bytes([m]) + read(q_off[m], 64))
            tq[m] = m
        else:
            tq[m] = tq[m - 1]
    for offs, tables, cls in ((dc_off, dctables, 0), (ac_off, actables, 0x10)):
        for m in range(spp):
            if offs[m] and (m == 0 or offs[m] != offs[m - 1]):
                if offs[m] in offs[:max(m - 1, 0)]:
                    raise ValueError(f"{name}: corrupt JPEG Huffman table tags (libtiff refuses "
                                     "it)")
                counts = read(offs[m], 16)
                tables[m] = _segment(0xC4, bytes([cls | m]) + counts
                                     + read(offs[m] + 16, sum(counts)))
                tda[m] = (tda[m] & 0xF0) | m if cls else m << 4
            else:
                tda[m] = (tda[m] & 0xF0) | (tda[m - 1] & 0x0F) if cls else tda[m - 1]
    comps = [(m, ((hor << 4) | ver) if m == 0 else 0x11, tq[m]) for m in range(spp)]
    sos = [(m, tda[m]) for m in range(spp)]
    return (0xC0, total, sw, comps), sos
