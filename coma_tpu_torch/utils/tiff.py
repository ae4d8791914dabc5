"""TIFF files, first page, as Pillow (with libtiff) reads them.

Classic and (little-endian, as PIL reads them) BigTIFF headers, strips or
tiles, samples interleaved (planar configuration 1) or, for RGB, RGBA and CMYK, in planes of their own (2), uncompressed, PackBits,
LZW, Deflate, JPEG, CCITT (RLE, RLEW, Group 3 1-D and 2-D, Group 4),
ThunderScan, LZMA, Zstandard or old-style JPEG, with or without horizontal
differencing (predictor 2, undone for LZW, Deflate, LZMA and Zstandard, as
libtiff does), either fill order (2: the stored bytes' bits reversed first,
as libtiff does). Modes, from PIL's ``OPEN_INFO``: "1" (1-bit gray, either
photometric), "L" (2, 4 and 8-bit gray, white-is-zero inverted, scaled to
0..255), "I;16" (16-bit gray), "LA", "RGB" (with or without one unused
extra sample), "RGBA" (unassociated alpha, or associated alpha divided out
as PIL does), "P" (1 to 8 bits, the ColorMap's high bytes), "CMYK" and
"LAB" (CIELab, photometric 8, 3 x 8 bits: L, then a and b as the signed
bytes PIL's "LAB" array holds; ICCLab and ITULab are refused, as Pillow
refuses them).

JPEG (compression 7) as libtiff's codec decodes it: the JPEGTables tag is
an abbreviated stream of tables, and each strip or tile a JPEG of its own
(so chroma upsampling stops at its edges) decoded by ``utils/jpeg.py``:
YCbCr photometric converted to RGB (libtiff's ``JPEGCOLORMODE_RGB``, with
libjpeg's fancy upsampling), any other photometric taken as stored.
CCITT, ThunderScan, LZMA and Zstandard strips are decoded by
``utils/tiff_codecs.py`` as libtiff 4.7.1 decodes them, old-style JPEG by
``utils/ojpeg.py``. Where a compressed strip goes through libtiff, its
directory must be whole and its size, sample and layout tags numbers
libtiff takes; a one-strip file without a byte count gets libtiff's
estimate. NeXT, PixarLog, JPEG 2000, LERC, WebP and SGILog compressions,
and sample formats other than unsigned integers, raise a ``ValueError``
naming the file and the compression; Pillow 12.1.0 refuses those
compressions too.

LZW and PackBits have native twins in ``native/src/image_codecs.cpp``, the
CCITT and Zstandard decoders in ``native/src/tiff_codecs.cpp``, taken where
they build; the plain Python versions are their references.
"""
from __future__ import annotations

import zlib

import numpy as np

from coma_tpu_torch.utils import tiff_codecs
from coma_tpu_torch.utils.modes import Decoded

_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
# the bytes per value of every type Pillow's directory reader loads (ASCII,
# rationals, floats and IFDs too, which the port does not decode)
_UNIT = {**{k: size for k, (_, size) in _TYPES.items()}, 2: 1, 5: 8, 10: 8, 11: 4, 12: 8, 13: 4}
# the tags TIFFReadDirectory reads as numbers first, failing on a bad one, and
# the types it takes for them; TIFFDataWidth of every type it knows
_LIBTIFF_NUMBERS = (256, 257, 258, 259, 277, 278, 280, 281, 284, 322, 323, 338, 339)
_INTEGER_TYPES = (1, 3, 4, 6, 8, 9, 16, 17)
_WIDTH = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4, 5: 8, 10: 8, 12: 8, 16: 8,
          17: 8, 18: 8}
# the counts libtiff reads these tags with, passing over an entry of another
# (the sizes, samples and layout tags above fail the directory instead)
_LIBTIFF_COUNT = {262: 1, 266: 1, 274: 1, 292: 1, 293: 1, 317: 1, 512: 1, 513: 1, 514: 1,
                  515: 1, 530: 2}
# the compressions Pillow 12.1.0 refuses too: absent from its COMPRESSION_INFO
# (the file is not identified), not configured in its libtiff, or SGILog,
# whose LogL and LogLuv photometrics have no mode in PIL's OPEN_INFO
_REFUSED = {32766: "NeXT", 32909: "PixarLog", 34712: "JPEG 2000", 34887: "LERC",
            50001: "WebP", 34676: "SGILog", 34677: "SGILog24"}
# none, CCITT RLE, Group 3, Group 4, old-style JPEG, LZW, JPEG, Deflate (twice),
# RLEW, PackBits, ThunderScan, LZMA, Zstandard
_COMPRESSIONS = (1, 2, 3, 4, 6, 5, 7, 8, 32946, 32771, 32773, 32809, 34925, 50000)
_CCITT = (2, 3, 4, 32771)
_PREDICTED = (5, 8, 32946, 34925, 50000)


def lzw_decode_python(data: bytes, cap: int) -> bytes:
    """TIFF's LZW (libtiff's ``LZWDecode``): 9- to 12-bit codes, most
    significant bit first, the width growing one code before the table
    fills 2^width, 256 clearing and 257 ending. At most ``cap`` bytes."""
    if data[:2] == b"\x00\x01":
        raise ValueError("old-style (LSB-first) TIFF LZW is not read")
    padded = data + bytes(3)
    total = len(data) * 8
    table: list = [bytes([i]) for i in range(256)] + [b"", b""]
    width, pos, prev = 9, 0, None
    out = bytearray()
    while pos + width <= total and len(out) < cap:
        i = pos >> 3
        code = ((padded[i] << 16 | padded[i + 1] << 8 | padded[i + 2]) >> (24 - width - (pos & 7))) \
            & ((1 << width) - 1)
        pos += width
        if code == 256:
            table = table[:258]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("an LZW code that is not in the table (corrupt data)")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("an LZW code that is not in the table (corrupt data)")
        if len(table) + 1 >= 1 << width and width < 12:
            width += 1
        out += entry
        prev = entry
    return bytes(out[:cap])


def packbits_decode_python(data: bytes, cap: int) -> bytes:
    """PackBits as libtiff's ``PackBitsDecode`` reads it: a header n in
    0..127 copies n + 1 bytes (cut to the room left; a run the data cannot
    fill ends the decoding, none of it copied), -1..-127 repeats the next
    byte 1 - n times, -128 does nothing. At most ``cap`` bytes."""
    out, pos, n = bytearray(), 0, len(data)
    while pos < n and len(out) < cap:
        h = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if h >= 0:
            count = min(h + 1, cap - len(out))
            if n - pos < count:
                break
            out += data[pos:pos + count]
            pos += count
        elif h != -128 and pos < n:
            out += data[pos:pos + 1] * (1 - h)
            pos += 1
    return bytes(out[:cap])


def _decompress(chunk: bytes, compression: int, cap: int, native) -> bytes:
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if compression == 1:
        return chunk[:cap]
    if compression == 34925:
        return tiff_codecs.lzma_decode(chunk, cap)
    if compression == 50000:
        return codecs.zstd_decode(chunk, cap) if native else \
            tiff_codecs.zstd_decode_python(chunk, cap)
    if compression in (8, 32946):
        # libtiff's ZIPDecode inflates until the strip is full: what lies
        # past that (the stream's check value too) is never looked at
        return zlib.decompressobj().decompress(chunk, cap)
    if compression == 5:
        if chunk[:2] == b"\x00\x01":
            raise ValueError("old-style (LSB-first) TIFF LZW is not read")
        return codecs.lzw_decode(chunk, 8, True, cap) if native else lzw_decode_python(chunk, cap)
    return codecs.packbits_decode(chunk, cap) if native else packbits_decode_python(chunk, cap)


class _Ifd:
    """The first image file directory: tag -> tuple of values (a classic
    TIFF's 12-byte entries, or BigTIFF's 20-byte ones with 8-byte counts and
    offsets). Pillow's view (``libtiff`` False) keeps the entries up to the
    first whose data runs past the end of the file; libtiff's reads a
    directory whole or not at all and passes over each entry whose data
    lies outside the file."""

    def __init__(self, data: bytes, name: str, libtiff: bool = False):
        if data[:4] not in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
            raise ValueError(f"{name}: not a TIFF file")
        self.order = "<" if data[:2] == b"II" else ">"
        self.data, self.name = data, name
        big = data[:4] == b"II+\x00"      # PIL takes "MM\0+" for a classic header

        if big and (self._int(4, 2) != 8 or self._int(6, 2) != 0):
            raise ValueError(f"{name}: a BigTIFF header with offsets other than 8 bytes")
        word, entry = (8, 20) if big else (4, 12)
        at = self._int(8, 8) if big else self._int(4, 4)
        first = at + (8 if big else 2)
        # Pillow's ImageFileDirectory_v2.load: the entries in order, until one
        # (or its data) runs past the end of the file; those read stay
        count = self._int(at, 8 if big else 2) if first <= len(data) else 0
        # libtiff's TIFFFetchDirectory reads every entry or none
        self.whole = 0 < count <= 4096 and first + entry * count <= len(data)
        self.tags, self.rationals, self.kinds = {}, {}, {}
        # libtiff's view of the entries: (tag, type, count) of every one
        self.entries = [(self._int(first + entry * k, 2), self._int(first + entry * k + 2, 2),
                         self._int(first + entry * k + 4, word))
                        for k in range(count)] if self.whole else []
        self.big = big
        self.arrays, seen = {}, set()
        for k in range(count if self.whole or not libtiff else 0):
            e = first + entry * k
            if e + entry > len(data):
                break
            tag, kind, n = self._int(e, 2), self._int(e + 2, 2), self._int(e + 4, word)
            if libtiff:                     # libtiff ignores a tag's later entries
                if tag in seen:
                    continue
                seen.add(tag)
                if n != _LIBTIFF_COUNT.get(tag, n):
                    continue                # and a tag of another count than its own
            size = n * _UNIT.get(kind, 0)
            where = e + 4 + word if size <= word else self._int(e + 4 + word, word)
            if libtiff and tag in (273, 279, 324, 325):
                # strips and tiles share libtiff's two entries; the later one wins
                self.arrays["counts" if tag in (279, 325) else "offsets"] = (kind, n, where)
            if kind not in _UNIT:
                continue
            if where + size > len(data):
                if libtiff:
                    continue
                break
            self.kinds[tag] = kind
            if kind in (5, 10) and n:          # rationals: (numerator, denominator) pairs
                pairs = np.frombuffer(data, self.order + ("u4" if kind == 5 else "i4"), 2 * n,
                                      where).reshape(n, 2).tolist()
                self.rationals[tag] = [tuple(p) for p in pairs]
            if kind not in _TYPES or not n:
                continue
            self.tags[tag] = tuple(np.frombuffer(data, self.order + _TYPES[kind][0], n,
                                                 where).tolist())

    def _int(self, at: int, n: int) -> int:
        return int.from_bytes(self.data[at:at + n], "little" if self.order == "<" else "big")

    def strip_array(self, which: str, nstrips: int):
        """``TIFFFetchStripThing``: the first ``nstrips`` values of the strip
        or tile ``"offsets"`` or ``"counts"`` (its data where the whole count
        puts it, only those in the file), zeros for those it lacks; None
        where it is not there."""
        if which not in self.arrays:
            return None
        kind, n, where = self.arrays[which]
        if kind not in (3, 4, 16):
            raise ValueError(f"{self.name}: a strip array of type {kind} (libtiff refuses it)")
        take = min(n, nstrips)
        unit = _UNIT[kind]
        if where + take * unit > len(self.data):
            raise ValueError(f"{self.name}: a strip array past the end of the file (libtiff "
                             "refuses it)")
        values = np.frombuffer(self.data, self.order + _TYPES[kind][0], take, where).tolist()
        return tuple(values) + (0,) * (nstrips - take)

    def libtiff_refusal(self):
        """Why ``TIFFReadDirectory`` fails where Pillow's parser does not,
        or None: a tag it reads as a number before all others (sizes,
        samples, planes, rows per strip, extra samples; compression, bits
        and sample format, one value or one a sample) of a type that is not
        an integer, of a count it does not take, or out of its range."""
        spp = self.get(277, (1,))[0]
        seen = set()
        for tag, kind, n in self.entries:
            if tag not in _LIBTIFF_NUMBERS or tag in seen:
                continue
            seen.add(tag)
            if kind not in _INTEGER_TYPES:
                return f"a tag {tag} of type {kind} (libtiff refuses it)"
            per_sample = tag in (258, 259, 280, 281, 339)
            if tag != 338 and n != 1 and not (per_sample and n >= spp):
                return f"a tag {tag} of {n} values (libtiff refuses it)"
            values = self.tags.get(tag, ())[:spp if per_sample else None]
            if any(v < 0 for v in values) or (tag not in (256, 257, 278, 322, 323) and
                                              any(v > 0xFFFF for v in values)):
                return f"a tag {tag} out of range (libtiff refuses it)"
            if per_sample and len(set(values)) > 1:
                return f"a tag {tag} of differing values a sample (libtiff refuses it)"
            # _TIFFVSetField's bad values
            if (tag in (277, 278) and 0 in values) or (tag == 284 and values[:1] not in
                                                       ((1,), (2,))) or \
                    (tag == 339 and any(not 1 <= v <= 6 for v in values)) or \
                    (tag == 338 and (n > spp or any(v > 2 for v in values))):
                return f"a bad value of tag {tag} (libtiff refuses it)"
        bits = self.get(258, (1,))[0]
        if self.get(262, (None,))[0] == 3 and bits < 8:
            # a ColorMap of another count than 3 * 2^bits is ignored, and a
            # palette image below 8 bits without one is refused
            counts = [n for tag, _, n in self.entries if tag == 320]
            if not counts or counts[0] != 3 << bits:
                return (f"a {bits}-bit palette image without a ColorMap of {3 << bits} values "
                        "(libtiff refuses it)")
        return None

    def estimated_count(self, offset: int):
        """``EstimateStripByteCounts`` for one compressed strip: the file
        less its header, directory and the tags' data, cut at the end of
        the file; None where a tag's type is one libtiff does not know."""
        word = 8 if self.big else 4
        space = (16 + 8 + 20 * len(self.entries) + 8) if self.big else \
            (8 + 2 + 12 * len(self.entries) + 4)
        for _, kind, n in self.entries:
            if kind not in _WIDTH:
                return None
            size = _WIDTH[kind] * n
            space += size if size > word else 0
        size = len(self.data)
        space = size if size < space else size - space
        return 0 if offset >= size else min(space, size - offset)

    def get(self, tag: int, default=None):
        return self.tags.get(tag, default)


def _undo_predictor(raw: np.ndarray, width: int, spp: int, bits: int, order: str) -> np.ndarray:
    """Horizontal differencing undone: each sample plus the one ``spp``
    before it in the row, modulo 2^bits."""
    if bits == 8:
        rows = raw.reshape(raw.shape[0], width, spp)
        return np.cumsum(rows, axis=1, dtype=np.uint8).reshape(raw.shape)
    rows = raw.view(order + "u2").reshape(raw.shape[0], width, spp)
    return np.cumsum(rows, axis=1, dtype=np.uint16).astype(order + "u2").view(np.uint8).reshape(
        raw.shape)


# the (photometric, bits, extra samples) of OPEN_INFO's keys with fill order 2
_FILL2 = {(0, (1,), ()), (0, (2,), ()), (0, (4,), ()), (0, (8,), ()), (1, (1,), ()),
          (1, (2,), ()), (1, (4,), ()), (1, (8,), ()), (1, (16,), ()), (2, (8, 8, 8), ()),
          (3, (1,), ()), (3, (2,), ()), (3, (4,), ()), (3, (8,), ())}


def _mode(photometric: int, bps: tuple, extra: tuple, name: str):
    """PIL's (mode, rawmode) for the supported subset of ``OPEN_INFO``."""
    key = (photometric, bps, extra)
    table = {
        (0, (1,), ()): ("1", "1;I"), (1, (1,), ()): ("1", "1"),
        (0, (2,), ()): ("L", "L;2I"), (1, (2,), ()): ("L", "L;2"),
        (0, (4,), ()): ("L", "L;4I"), (1, (4,), ()): ("L", "L;4"),
        (0, (8,), ()): ("L", "L;I"), (1, (8,), ()): ("L", "L"),
        (0, (16,), ()): ("I;16", "I;16"), (1, (16,), ()): ("I;16", "I;16"),
        (1, (8, 8), (2,)): ("LA", "LA"),
        (2, (8, 8, 8), ()): ("RGB", "RGB"),
        (2, (8, 8, 8, 8), ()): ("RGBA", "RGBA"), (2, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (2, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"), (2, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (3, (1,), ()): ("P", "P;1"), (3, (2,), ()): ("P", "P;2"), (3, (4,), ()): ("P", "P;4"),
        (3, (8,), ()): ("P", "P"),
        (5, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (8, (8, 8, 8), ()): ("LAB", "LAB"),
    }
    if key not in table:
        raise ValueError(f"{name}: a TIFF of photometric {photometric}, bits {bps}, extra "
                         f"samples {extra} is not read")
    return table[key]


def _unpack(raw: np.ndarray, rawmode: str, width: int, order: str) -> np.ndarray:
    H = raw.shape[0]
    if rawmode in ("1", "1;I"):
        bits = np.unpackbits(raw, axis=1)[:, :width].astype(bool)
        return ~bits if rawmode == "1;I" else bits
    for low in (2, 4):
        if rawmode.startswith(f"L;{low}") or rawmode == f"P;{low}":
            per = 8 // low
            shifts = np.arange(8 - low, -1, -low, dtype=np.uint8)
            levels = ((raw[..., None] >> shifts) & ((1 << low) - 1)).reshape(H, -1)[:, :width]
            if rawmode.startswith("P"):
                return levels
            if rawmode.endswith("I"):
                levels = (1 << low) - 1 - levels
            return (levels * (255 // ((1 << low) - 1))).astype(np.uint8)
    if rawmode == "P;1":
        return np.unpackbits(raw, axis=1)[:, :width]
    if rawmode in ("L", "P"):
        return raw[:, :width]
    if rawmode == "L;I":
        return 255 - raw[:, :width]
    if rawmode == "I;16":
        return raw[:, :2 * width].view(order + "u2").reshape(H, width).astype(np.uint16)
    n = {"LA": 2, "RGB": 3, "LAB": 3}.get(rawmode, 4)
    px = raw[:, :n * width].reshape(H, width, n)
    if rawmode == "RGBX":
        return np.ascontiguousarray(px[..., :3])
    if rawmode == "RGBa":                   # associated alpha divided out, as PIL's unpacker
        a, c = px[..., 3:].astype(np.int32), px[..., :3].astype(np.int32)
        rgb = np.where(a == 0, 0, np.minimum(c * 255 // np.maximum(a, 1), 255))
        return np.concatenate([rgb.astype(np.uint8), px[..., 3:]], -1)
    return np.ascontiguousarray(px)


_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
_REVERSED_LUT = np.frombuffer(_REVERSED, np.uint8)


def _jpeg_block(chunk: bytes, tables, photometric: int, spp: int, name: str, native,
                segment: tuple, sampling: tuple, last_strip: bool) -> np.ndarray:
    """One JPEG strip or tile, after the JPEGTables stream, as libtiff's codec
    decodes it: (rows, columns * spp) uint8. ``segment`` is the (columns,
    rows) libtiff expects, ``sampling`` the first component's factors (the
    YCbCr subsampling, else 1 x 1); ``JPEGPreDecode``'s checks refuse the
    rest."""
    from coma_tpu_torch.utils import jpeg

    frame = jpeg.decode_coefficients(chunk, name, native, libtiff=True,
                                     tables_stream=None if tables is None else bytes(tables))
    if len(frame.coef) != spp:
        raise ValueError(f"{name}: a JPEG strip of {len(frame.coef)} components in a TIFF of "
                         f"{spp} samples")
    if tuple(frame.raw_sampling[0]) != tuple(sampling) or \
            any(tuple(f) != (1, 1) for f in frame.raw_sampling[1:]):
        raise ValueError(f"{name}: improper JPEG sampling factors {frame.raw_sampling} in a "
                         "TIFF strip (libtiff refuses them)")
    (w, h), (seg_w, seg_h) = (frame.width, frame.height), segment
    if (w > seg_w or h > seg_h) and not (w == seg_w and h > seg_h and last_strip):
        raise ValueError(f"{name}: a JPEG strip of {w} x {h} exceeds its {seg_w} x {seg_h} "
                         "(libtiff refuses it)")
    if spp == 1:
        colour = jpeg.GRAY
    elif photometric == 6:
        colour = jpeg.YCC
    else:                                           # libtiff's JCS_UNKNOWN: as stored
        colour = jpeg.RGB if spp == 3 else jpeg.CMYK
    px = jpeg.reconstruct(frame, native, colour)
    if spp == 4:                                    # undo reconstruct's CMYK inversion
        px = 255 - px
    return px.reshape(px.shape[0], -1)


def _fax(chunk: bytes, parity: int, compression: int, width: int, rows: int, buf: np.ndarray,
         carry, native) -> None:
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.tiff_available()
    if native:
        codecs.fax_decode(chunk, parity, compression, width, rows, buf, carry)
    else:
        tiff_codecs.fax_decode_python(chunk, parity, compression, width, rows, buf, carry)


def _assemble(data: bytes, ifd: _Ifd, offsets, counts, compression: int, fill: int, bits: int,
              samples: int, tile, bw: int, bh: int, width: int, height: int, predictor: int,
              bps: int, photometric: int, native, name: str) -> np.ndarray:
    """The strips or tiles of one plane (or of the interleaved samples) ->
    (height, row bytes) uint8."""
    row_bytes = (width * bits + 7) // 8
    block_row_bytes = (bw * bits + 7) // 8
    across = -(-width // bw)
    raw = np.zeros((-(-height // bh) * bh, across * block_row_bytes), np.uint8)
    tables = ifd.get(347)
    # CCITT decodes into Pillow's strip buffer, which one strip's rows left
    # unwritten (Group 4 ended early) keep from the strip before
    carried = np.zeros((bh, block_row_bytes), np.uint8) if compression in _CCITT else None
    fax_carry = tiff_codecs.FaxCarry(compression, ifd.get(292, (0,))[0], bw) \
        if compression in _CCITT else None
    for k, (offset, count) in enumerate(zip(offsets, counts)):
        by, bx = divmod(k, across)
        if by * bh >= height:
            break
        # a strip holds the rows left in the image, a tile all of its own (to
        # Pillow's raw decoder too the rows left)
        need = block_row_bytes * (bh if tile and compression != 1 else
                                  min(bh, height - by * bh))
        if compression == 1 and tile and bits % 8:
            piece = _raw_subbyte_tile(data, offset, bx, by, bw, bh, bits, width, height, name)
            if fill == 2:
                piece = _REVERSED_LUT[piece]
            raw[by * bh:by * bh + len(piece), bx * block_row_bytes:(bx + 1) * block_row_bytes] = \
                piece
            continue
        if compression == 1:
            # Pillow's raw decoder reads the rows from the offset, whatever
            # the byte count says, and the file must hold them
            count = need
            if offset + need > len(data):
                raise ValueError(f"{name}: a TIFF strip or tile runs past the end of the file "
                                 "(truncated; Pillow refuses it)")
        else:
            if count > 1 << 20 and (count - 4096) // 10 > block_row_bytes * bh:
                count = block_row_bytes * bh * 10 + 4096   # TIFFFillStrip's limit
            if not count or offset + count > len(data):
                raise ValueError(f"{name}: a TIFF strip or tile of {count} bytes at {offset} is "
                                 "not in the file (libtiff refuses it)")
        chunk = data[offset:offset + count]
        if fill == 2:
            chunk = chunk.translate(_REVERSED)
        try:
            if compression == 7:
                sampling = tuple(ifd.get(530, (2, 2)))[:2] if photometric == 6 else (1, 1)
                piece = _jpeg_block(chunk, tables, photometric, samples, name, native,
                                    (bw, need // block_row_bytes), sampling,
                                    not tile and by * bh + bh >= height)
                piece = piece[:bh, :block_row_bytes]
            elif compression in _CCITT:
                _fax(chunk, offset & 1, compression, bw, need // block_row_bytes, carried,
                     fax_carry, native)
                piece = carried[:need // block_row_bytes].copy()
            elif compression == 32809:
                piece = np.frombuffer(tiff_codecs.thunder_decode(chunk, bw, need // block_row_bytes),
                                      np.uint8).reshape(-1, block_row_bytes)
            else:
                block = _decompress(chunk, compression, need, native)
                if len(block) < need:
                    raise ValueError(f"a TIFF strip or tile decodes to {len(block)} of its "
                                     f"{need} bytes (libtiff refuses it)")
                piece = np.frombuffer(block, np.uint8).reshape(-1, block_row_bytes)
        except (ValueError, zlib.error) as err:
            if str(err).startswith(name):
                raise
            raise ValueError(f"{name}: {err}") from None
        if predictor == 2:
            piece = _undo_predictor(piece, bw, samples, bps, ifd.order)
        rows, cols = piece.shape
        raw[by * bh:by * bh + rows, bx * block_row_bytes:bx * block_row_bytes + cols] = piece
    if tile:
        if bits % 8:
            return tile_bits_gather(raw[:height], across, block_row_bytes, bw, bits, width,
                                    native)
        raw = raw[:, :width * bits // 8]
    return np.ascontiguousarray(raw[:height, :row_bytes])


def tile_bits_gather_python(raw: np.ndarray, across: int, tile_row_bytes: int, bw: int,
                            bits: int, width: int) -> np.ndarray:
    """Sub-byte tiles side by side, (rows, across * tile_row_bytes) uint8 ->
    the image's rows, (rows, ceil(width * bits / 8)): each tile row's first
    ``bw * bits`` bits (its pixels; the rest pads it to a byte), the last
    column's cut at the image's width, as Pillow's unpackers place each
    tile's pixels. The reference of ``native/codecs.tile_bits_gather``."""
    rows = raw.shape[0]
    tiles = np.unpackbits(raw.reshape(rows, across, tile_row_bytes), axis=2)[:, :, :bw * bits]
    return np.packbits(tiles.reshape(rows, -1)[:, :width * bits], axis=1)


def tile_bits_gather(raw: np.ndarray, across: int, tile_row_bytes: int, bw: int, bits: int,
                     width: int, native=None) -> np.ndarray:
    """:func:`tile_bits_gather_python`, or its C++ twin (``native`` None:
    where it builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return tile_bits_gather_python(raw, across, tile_row_bytes, bw, bits, width)
    return codecs.tile_bits_gather(np.ascontiguousarray(raw), across, tile_row_bytes, bw, bits,
                                   width)


def _raw_subbyte_tile(data: bytes, offset: int, bx: int, by: int, bw: int, bh: int, bits: int,
                      width: int, height: int, name: str) -> np.ndarray:
    """One uncompressed tile below 8 bits a pixel as Pillow's raw decoder
    reads it (Pillow does not hand raw tiles to libtiff): (rows, ceil(bw *
    bits / 8)) uint8. A tile inside the image has rows of ``ceil(bw * bits /
    8)`` bytes; one that crosses the right edge rows ``int(bw * bits / 8)``
    bytes apart (Pillow's stride, truncated), of which each row reads the
    bytes of its pixels inside the image (a stride shorter than that is
    refused, as Pillow refuses it). The file must hold the last row's."""
    cw, ch = min(bw, width - bx * bw), min(bh, height - by * bh)
    nbytes = (cw * bits + 7) // 8
    pitch = bw * bits // 8 if bx * bw + bw > width else nbytes
    if pitch < nbytes:
        raise ValueError(f"{name}: a raw TIFF tile's row stride of {pitch} bytes is shorter "
                         f"than its {nbytes} (Pillow refuses it: bad configuration)")
    if offset + (ch - 1) * pitch + nbytes > len(data):
        raise ValueError(f"{name}: a TIFF strip or tile runs past the end of the file "
                         "(truncated; Pillow refuses it)")
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((ch, (bw * bits + 7) // 8), np.uint8)
    starts = offset + pitch * np.arange(ch, dtype=np.int64)
    out[:, :nbytes] = buf[starts[:, None] + np.arange(nbytes)]
    return out


def _libtiff_view(data: bytes, ifd: _Ifd, name: str, compression: int, width: int,
                  height: int) -> _Ifd:
    """libtiff's view of the directory, which it decodes every compressed
    strip by (Pillow's gives the mode): its refusals, Pillow's where the two
    views part, and its strip or tile arrays as many as its layout has."""
    lt = _Ifd(data, name, libtiff=True)
    if not lt.whole:
        raise ValueError(f"{name}: libtiff cannot read the TIFF directory (its entries run "
                         "past the end of the file; Pillow refuses it)")
    if lt.libtiff_refusal():
        raise ValueError(f"{name}: {lt.libtiff_refusal()}")
    if lt.get(259, (1,))[0] != compression:
        raise ValueError(f"{name}: libtiff's directory gives compression "
                         f"{lt.get(259, (1,))[0]}, Pillow's {compression}; not read")
    pillow_spp = ifd.get(277, (3 if compression == 6 else 1,))[0]
    if lt.get(277, (1,))[0] != pillow_spp and compression != 6:
        raise ValueError(f"{name}: libtiff's directory gives {lt.get(277, (1,))[0]} samples "
                         f"a pixel, Pillow's {pillow_spp} (Pillow refuses it)")
    # the strip or tile arrays, as many values as libtiff's layout has
    tiled_lt = 322 in lt.tags or 323 in lt.tags     # libtiff's TIFF_ISTILED
    spp_lt = lt.get(277, (1,))[0]
    if tiled_lt and not (322 in lt.tags and 323 in lt.tags):
        # either tag sets libtiff's tile dimensions; its tiles then fail to read
        raise ValueError(f"{name}: a TIFF with one tile dimension of two (libtiff's tiles fail "
                         "to read; Pillow refuses it)")
    if tiled_lt:
        tw, th = lt.get(322, (0,))[0], lt.get(323, (0,))[0]
        nstrips = -(-width // tw) * -(-height // th) if tw and th else 0
    else:
        rps = min(lt.get(278, (height,))[0], height) or height
        nstrips = -(-height // rps) if height else 0
    if lt.get(284, (1,))[0] == 2:
        nstrips *= spp_lt
    for which, tag, other in (("offsets", 324, 273), ("counts", 325, 279)):
        if not tiled_lt:
            tag, other = other, tag
        values = lt.strip_array(which, nstrips)
        lt.tags.pop(other, None)
        if values is not None:
            lt.tags[tag] = values
        else:
            lt.tags.pop(tag, None)
    if not tiled_lt and 0x7FFFFFFF < lt.get(278, (0,))[0] < 0xFFFFFFFF:
        # Pillow sizes its strip buffer from libtiff's rows per strip, a
        # negative count past 2^31 - 1 (2^32 - 1 means the whole image)
        raise ValueError(f"{name}: {lt.get(278)[0]} rows per strip (Pillow refuses it)")
    if compression == 6 and not tiled_lt and nstrips == 1 and 273 not in lt.tags:
        lt.tags[273], lt.tags[279] = (0,), (0,)    # libtiff's old-style JPEG tolerates it
    if not tiled_lt and nstrips == 1 and lt.get(273, (0,))[0] and \
            lt.get(279, (0,)) == (0,):
        # one strip whose byte count is missing or 0: libtiff estimates it
        estimate = lt.estimated_count(lt.tags[273][0])
        if estimate is None:
            raise ValueError(f"{name}: a tag of unknown type where libtiff estimates the "
                             "strip's byte count (it refuses it)")
        lt.tags[279] = (estimate,)
    elif lt.get(279 if not tiled_lt else 325) is None and nstrips > 1:
        raise ValueError(f"{name}: no strip byte counts for {nstrips} strips (libtiff "
                         "refuses it)")
    return lt


def decode_tiff(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A TIFF file's first page -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where it is not read."""
    ifd = _Ifd(data, name)
    width, height = ifd.get(256, (0,))[0], ifd.get(257, (0,))[0]
    compression = ifd.get(259, (1,))[0]
    if ifd.kinds.get(259, 3) not in _INTEGER_TYPES:
        # Pillow's COMPRESSION_INFO has no key of a float or a rational
        raise ValueError(f"{name}: a TIFF compression of type {ifd.kinds[259]} (Pillow cannot "
                         "identify it)")
    if compression in _REFUSED:
        raise ValueError(f"{name}: TIFF with {_REFUSED[compression]} compression is not read "
                         "(Pillow refuses it too)")
    if compression not in _COMPRESSIONS:
        raise ValueError(f"{name}: TIFF compression {compression} is not read (Pillow refuses "
                         "it too)")
    # Pillow's directory gives the mode; libtiff, which decodes every strip
    # but a raw one, reads its own for the layout and the codec's tags
    lt = ifd if compression == 1 else _libtiff_view(data, ifd, name, compression, width, height)
    if compression == 6:
        from coma_tpu_torch.utils import ojpeg

        return ojpeg.decode_ojpeg(data, ifd, lt, name, native)
    photometric = ifd.get(262, (0,))[0]
    spp = ifd.get(277, (1,))[0]
    bps = tuple(ifd.get(258, (1,)))
    if spp < len(bps):                  # Pillow drops the extra bit counts
        bps = bps[:spp]
    elif len(bps) == 1 and spp > 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: {spp} samples a pixel with bit counts {bps} (Pillow "
                         "refuses it)")
    extra = tuple(ifd.get(338, ()))
    fill = ifd.get(266, (1,))[0]
    if compression != 1 and ifd.get(284, (1,))[0] not in (1, 2):
        raise ValueError(f"{name}: planar configuration {ifd.get(284)[0]} (libtiff refuses it)")
    planar = ifd.get(284, (1,))[0] == 2 and spp > 1
    if any(f != 1 for f in ifd.get(339, (1,))) and not (bps == (8,) and photometric == 1):
        raise ValueError(f"{name}: TIFF samples other than unsigned integers are not read")
    if compression == 7 and photometric == 6 and bps == (8, 8, 8) and not planar:
        mode, rawmode = "RGB", "RGB"                # libtiff's JPEGCOLORMODE_RGB
        sub = tuple(ifd.get(530, (2, 2)))[:2]
        if len(sub) < 2 or any(f not in (1, 2, 4) for f in sub):
            raise ValueError(f"{name}: YCbCr subsampling {sub} (libtiff refuses it)")
    else:
        mode, rawmode = _mode(photometric, bps, extra, name)
        # Pillow's OPEN_INFO key holds the fill order and the byte order too
        if fill not in (1, 2) or (fill == 2 and (photometric, bps, extra) not in _FILL2) \
                or (photometric, bps, ifd.order) == (0, (16,), ">"):
            raise ValueError(f"{name}: a TIFF of photometric {photometric}, bits {bps}, fill "
                             f"order {fill} has no mode in Pillow")
        if fill == 2 and compression == 1 and rawmode in ("P;1", "P;2", "P;4"):
            # Pillow's raw decoder has no unpacker of the reversed raw mode
            raise ValueError(f"{name}: an uncompressed {bps[0]}-bit palette TIFF of fill order "
                             "2 (Pillow refuses it: unknown raw mode)")
    if compression == 7 and (any(b != 8 for b in bps) or planar):
        raise ValueError(f"{name}: a JPEG TIFF of {bps} bits (planar {planar}) is not read")
    if compression in _CCITT and bps != (1,):
        raise ValueError(f"{name}: CCITT compression of {bps}-bit samples (libtiff reads 1 bit "
                         "only; Pillow refuses it)")
    if compression == 32809 and bps != (4,):
        raise ValueError(f"{name}: ThunderScan compression of {bps}-bit samples (libtiff reads "
                         "4 bits only; Pillow refuses it)")
    # libtiff undoes the predictor for the codecs that set it up
    predictor = lt.get(317, (1,))[0] if compression in _PREDICTED else 1
    if predictor not in (1, 2) or (predictor == 2 and bps[0] not in (8, 16)):
        raise ValueError(f"{name}: TIFF predictor {predictor} at {bps[0]} bits is not read")
    if planar and (rawmode not in ("RGB", "RGBA", "CMYK") or bps[0] != 8):
        # PIL unpacks each plane with one letter of the raw mode
        raise ValueError(f"{name}: separate planes of raw mode {rawmode} are not read")
    tiled = 273 not in lt.tags and 324 in lt.tags     # as Pillow, or libtiff, chooses
    if tiled:
        if 322 not in lt.tags or 323 not in lt.tags:
            raise ValueError(f"{name}: a tiled TIFF without its tile size")
        bw, bh = lt.get(322)[0], lt.get(323)[0]
        if compression != 1 and bw * sum(bps) % 8:
            # measured: Pillow's libtiff tile decoder fails on such tiles
            raise ValueError(f"{name}: a compressed TIFF tile of {bw} pixels at {sum(bps)} bits "
                             "fills no whole bytes a row (Pillow refuses it: decoder error -2)")
        offsets, counts = lt.get(324), lt.get(325)
    else:
        bw, bh = width, min(lt.get(278, (height,))[0], height) or height
        offsets, counts = lt.get(273), lt.get(279)
    if compression == 1 and counts is None and offsets is not None:
        counts = (0,) * len(offsets)              # Pillow's raw decoder does not read them
    if not width or not height or offsets is None or counts is None:
        raise ValueError(f"{name}: a TIFF without size or image data")
    planes = len(bps) if planar else 1
    per_plane = -(-len(offsets) // planes)
    raws = [_assemble(data, lt, offsets[p * per_plane:(p + 1) * per_plane],
                      counts[p * per_plane:(p + 1) * per_plane], compression,
                      lt.get(266, (1,))[0],
                      bps[p] if planar else sum(bps), 1 if planar else len(bps), tiled, bw, bh,
                      width, height, predictor, bps[0], photometric, native, name)
            for p in range(planes)]
    if planar:                                      # interleave the planes' samples
        raw = np.stack(raws, 2).reshape(height, -1)
    else:
        raw = raws[0]
    palette = None
    if mode == "P":
        cmap = ifd.get(320)
        if cmap is None:
            raise ValueError(f"{name}: a palette TIFF without a ColorMap")
        palette = (np.asarray(cmap, np.int64).reshape(3, -1).T // 256).astype(np.uint8)
    pixels = _unpack(raw, rawmode, width, ifd.order)
    if compression == 1:
        # Pillow's raw tiles leave what they do not cover as the new image's zeros (which a
        # "LAB" array shows as a and b of 128: PIL's packer flips their sign bits)
        covered = np.zeros((-(-height // bh) * bh, -(-width // bw) * bw), bool)
        across = -(-width // bw)
        for k in range(min(per_plane, covered.size // (bw * bh))):
            by, bx = divmod(k, across)
            covered[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw] = True
        blank = np.array([0, 128, 128], np.uint8) if mode == "LAB" else 0
        pixels = np.where(covered[:height, :width].reshape(
            (height, width) + (1,) * (pixels.ndim - 2)), pixels, blank).astype(pixels.dtype)
    return Decoded(pixels, mode, palette)
