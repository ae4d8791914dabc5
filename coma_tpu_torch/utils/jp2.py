"""JPEG 2000 files (JP2 and bare J2K codestreams) as Pillow 12.1.0 opens
them with OpenJPEG 2.5.4.

- ``Jpeg2KImagePlugin._accept`` and ``_open``: a ``\\xffO\\xffQ`` codestream
  takes its size and mode from SIZ (one component over 8 bits is "I;16";
  one, two, three or four components are "L", "LA", "RGB", "RGBA"); a JP2
  file from its ``jp2h`` box: ``ihdr`` (the same modes), ``colr`` with
  enumerated space 12 making four components "CMYK", ``pclr`` of at most
  8 bits making "L" or "LA" "P" or "PA" (its entries through
  ``ImagePalette.getcolor``: repeated colours dropped, entries of other than
  3 columns packed as their bytes fall). The image is
  the codestream's size less its offset.
- OpenJPEG's JP2 reader (``opj_jp2_read_header_procedure``: the signature
  and file type boxes first, a ``jp2h`` with an ``ihdr`` before the
  codestream box; ``colr`` sets the colour space: 16 sRGB, 17 gray, 18
  sYCC, 24 e-YCC, 12 CMYK; any other, or none, Pillow takes as unspecified)
  and ``utils/j2k.py``'s tiles, with no reduction and every layer.
- Pillow's ``Jpeg2KDecode.c``: tile by tile through ``opj_decode_tile_data``
  (OpenJPEG applies no palette, channel definition or colour conversion on
  that path), each tile's buffer read by Pillow's unpackers: each sample
  shifted from its precision to 8 bits (16 for "I;16") with rounding, a
  signed component offset by half its range, in C's unsigned arithmetic;
  a subsampled component replicated over its pixels (its rows taken
  ``width / dx`` samples apart, as Pillow takes them); sYCC converted to
  RGB with ``ImagingConvertYCbCr2RGB``; a colour space left unspecified
  (or unknown) taken as gray (one or two components), sYCC (three or four
  whose first subsampled component is the second or third) or sRGB.
"""
from __future__ import annotations

import struct

import numpy as np

from coma_tpu_torch.utils import j2k
from coma_tpu_torch.utils.modes import Decoded, FormatNotRead, NotThisFormat, ycbcr_to_rgb

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xffO\xffQ"
# OpenJPEG's colour spaces
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
# Pillow's j2k_unpackers: (mode, colour space, components) -> (unpacker,
# subsampled components allowed)
_UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", False), ("P", SRGB, 1): ("gray_l", False),
    ("PA", SRGB, 2): ("graya_la", False), ("I;16", GRAY, 1): ("gray_i", False),
    ("LA", GRAY, 2): ("graya_la", False),
    ("RGB", GRAY, 1): ("gray_rgb", False), ("RGB", GRAY, 2): ("gray_rgb", False),
    ("RGB", SRGB, 3): ("srgb_rgb", True), ("RGB", SYCC, 3): ("sycc_rgb", True),
    ("RGB", SRGB, 4): ("srgb_rgb", True), ("RGB", SYCC, 4): ("sycc_rgb", True),
    ("RGBA", GRAY, 1): ("gray_rgb", False), ("RGBA", GRAY, 2): ("graya_la", False),
    ("RGBA", SRGB, 3): ("srgb_rgb", True), ("RGBA", SYCC, 3): ("sycc_rgb", True),
    ("RGBA", SRGB, 4): ("srgba_rgba", True), ("RGBA", SYCC, 4): ("sycca_rgba", True),
    ("RGBA", GRAY, 4): ("srgba_rgba", True), ("CMYK", CMYK, 4): ("srgba_rgba", True),
}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == CODESTREAM or prefix[:12] == JP2_SIGNATURE


class _Boxes:
    """Pillow's ``BoxReader``."""

    def __init__(self, data: bytes, pos: int = 0, length: int = -1):
        self.data, self.pos = data, pos
        self.start = pos
        self.length = length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.pos - self.start + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, fmt: str):
        n = struct.calcsize(fmt)
        if not self._can_read(n):
            raise NotThisFormat("Not enough data in header")
        if self.pos + n > len(self.data):
            raise ValueError(f"expected to read {n} bytes of a JP2 header")
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def sub(self) -> "_Boxes":
        n = self.remaining
        if not self._can_read(n):
            raise NotThisFormat("Not enough data in header")
        if self.pos + n > len(self.data):
            raise ValueError(f"expected to read {n} bytes of a JP2 header")
        box = _Boxes(self.data[self.pos:self.pos + n], 0, n)
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return box

    def has_next(self) -> bool:
        if self.length >= 0:
            return self.pos - self.start + self.remaining < self.length
        return True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.read(">I4s")
        hlen = 8
        if lbox == 1:
            lbox = self.read(">Q")[0]
            hlen = 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise NotThisFormat("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _getcolor_palette(colors: list, width: int) -> np.ndarray:
    """``ImagePalette.getcolor`` of each colour in turn on an empty "RGB"
    (``width`` 3) or "RGBA" (4) palette: a repeated colour is dropped, a
    new one goes at ``len(palette) // width``, its bytes whatever its
    length; the (N, 3) RGB entries PIL's palette then holds."""
    pal, seen = bytearray(), set()
    for color in colors:
        if color in seen:
            continue
        index = len(pal) // width
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        seen.add(color)
        if index * width < len(pal):
            pal = pal[:index * width] + bytes(color) + pal[index * width + width:]
        else:
            pal += bytes(color)
    whole = len(pal) // width * width
    return np.frombuffer(bytes(pal[:whole]), np.uint8).reshape(-1, width)[:, :3].copy()


def _pillow_header(data: bytes):
    """``Jpeg2KImageFile._open``: (kind, (width, height), mode, palette)."""
    if data[:4] == CODESTREAM:
        if len(data) < 6:
            raise NotThisFormat("a codestream without its SIZ")
        lsiz = int.from_bytes(data[4:6], "big")
        siz = data[4:4 + max(lsiz, 2)]
        if len(siz) < 40:
            raise NotThisFormat("a SIZ shorter than Pillow unpacks")
        _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH",
                                                                              siz)
        size = (xsiz - xosiz, ysiz - yosiz)
        if csiz == 1:
            if len(siz) < 39:
                raise NotThisFormat("a SIZ shorter than Pillow unpacks")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise NotThisFormat("unable to determine J2K image mode")
        return "j2k", size, mode, None
    if data[:12] != JP2_SIGNATURE:
        raise NotThisFormat("not a JPEG 2000 file")
    reader = _Boxes(data, 12)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.read(">4s")
    if header is None:
        raise ValueError("a JP2 file without a jp2h box (Pillow fails an assertion)")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read(">HB")
            depths = header.read(">" + "B" * npc)
            if max(depths + (0,)) <= 8:
                palette = _getcolor_palette([header.read(">" + "B" * npc) for _ in range(ne)],
                                            4 if npc == 4 else 3)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.read(">HHHHBB")
                    break
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    return "jp2", size, mode, palette


def _box(data: bytes, pos: int):
    """``opj_jp2_read_boxhdr``: (type, length, header bytes) at ``pos``."""
    if pos + 8 > len(data):
        return None
    length, kind = struct.unpack_from(">I4s", data, pos)
    hdr = 8
    if length == 1:
        if pos + 16 > len(data):
            raise ValueError("cannot handle a box of a truncated XL length")
        length = struct.unpack_from(">Q", data, pos + 8)[0]
        hdr = 16
    elif length == 0:
        length = len(data) - pos           # the last box runs to the end of the file
    return kind, length, hdr


def _jp2h(body: bytes, got: dict) -> None:
    """``opj_jp2_read_jp2h``: the header's boxes, each checked by its
    handler (``opj_jp2_read_ihdr``, ``_colr``, ``_bpcc``, ``_pclr``,
    ``_cmap``, ``_cdef``); ``got`` keeps what they read."""
    p = 0
    while p < len(body):
        if p + 8 > len(body):
            raise ValueError("stream error while reading JP2 Header box")
        sl, st = struct.unpack_from(">I4s", body, p)
        sh = 8
        if sl == 1:
            if p + 16 > len(body):
                raise ValueError("stream error while reading JP2 Header box")
            sl, sh = struct.unpack_from(">Q", body, p + 8)[0], 16
        elif sl == 0:
            raise ValueError("cannot handle box of undefined sizes")
        if sl > len(body) - p or sl < sh:
            raise ValueError("JP2 Header box: box length is inconsistent")
        sub = body[p + sh:p + sl]
        if st == b"ihdr" and "ihdr" not in got:
            if len(sub) != 14:
                raise ValueError("bad image header box (bad size)")
            height, width, nc = struct.unpack_from(">IIH", sub)
            if height < 1 or width < 1 or not 1 <= nc <= 16384:
                raise ValueError("wrong values in the ihdr box")
            got.update(ihdr=(width, height), nc=nc, bpc=sub[10])
        elif st == b"colr":
            if len(sub) < 3:
                raise ValueError("bad COLR header box (bad size)")
            if "enumcs" not in got and sub[0] == 1:
                if len(sub) < 7:
                    raise ValueError("bad COLR header box (bad size)")
                got["enumcs"] = struct.unpack_from(">I", sub, 3)[0]
            elif "enumcs" not in got and sub[0] == 2:
                got["enumcs"] = 0                 # an ICC profile: the space is unknown
        elif st == b"bpcc":
            if len(sub) != got.get("nc", 0):
                raise ValueError("bad BPCC header box (bad size)")
        elif st == b"pclr":
            if "pclr" in got or len(sub) < 3:
                raise ValueError("a second or short PCLR box")
            entries, columns = struct.unpack_from(">HB", sub)
            if not 0 < entries <= 1024 or not columns or len(sub) < 3 + columns:
                raise ValueError("invalid PCLR box")
            widths = [min(((b & 0x7F) + 8) >> 3, 4) for b in sub[3:3 + columns]]
            if len(sub) < 3 + columns + entries * sum(widths):
                raise ValueError("a PCLR box shorter than its entries")
            got["pclr"] = columns
        elif st == b"cmap":
            if "pclr" not in got:
                raise ValueError("need to read a PCLR box before the CMAP box")
            if "cmap" in got:
                raise ValueError("only one CMAP box is allowed")
            if len(sub) < 4 * got["pclr"]:
                raise ValueError("insufficient data for CMAP box")
            got["cmap"] = True
        elif st == b"cdef":
            if "cdef" in got or len(sub) < 2:
                raise ValueError("a second CDEF box, or insufficient data for it")
            n = struct.unpack_from(">H", sub)[0]
            if n == 0 or len(sub) < 2 + 6 * n:
                raise ValueError("insufficient data for CDEF box")
            got["cdef"] = True
        p += sl
    if "ihdr" not in got:
        raise ValueError("JP2 Header box: no 'ihdr' box")


def _openjpeg_jp2(data: bytes):
    """OpenJPEG's JP2 header reading (``opj_jp2_read_header_procedure``):
    (the colour space from ``colr``, the offset of the codestream, the
    first ihdr's (width, height))."""
    pos, state, got = 0, set(), {}
    while True:
        box = _box(data, pos)
        if box is None:
            raise ValueError("a JP2 file without a codestream box")
        kind, length, hdr = box
        if kind == b"jp2c":
            if "header" not in state:
                raise ValueError("bad placed jpeg codestream")
            return _ENUMCS.get(got.get("enumcs"), UNKNOWN), pos + hdr, got["ihdr"]
        if struct.unpack_from(">I", data, pos)[0] == 0:
            raise ValueError("cannot handle box of undefined sizes")
        if length < hdr:
            raise ValueError(f"invalid box size {length}")
        body = data[pos + hdr:pos + length]
        if pos + length > len(data):
            raise ValueError(f"invalid box size {length} for box {kind!r}")
        if kind == b"jP  ":
            if state:
                raise ValueError("the signature box is not the first box")
            if len(body) != 4 or body != b"\r\n\x87\n":
                raise ValueError("bad JPEG 2000 signature box")
            state.add("signature")
        elif kind == b"ftyp":
            if state != {"signature"}:
                raise ValueError("the file type box is not the second box")
            if len(body) < 8 or len(body) % 4:
                raise ValueError("error with FTYP signature box size")
            state.add("ftyp")
        elif kind == b"jp2h":
            if "ftyp" not in state:
                raise ValueError("the jp2h box comes before the file type box")
            _jp2h(body, got)
            state.add("header")
        elif "signature" not in state:
            raise ValueError("first box must be JPEG 2000 signature box")
        elif "ftyp" not in state:
            raise ValueError("second box must be file type box")
        pos += length


def _buffer(tile: j2k.Tile, comps) -> tuple:
    """``opj_tcd_update_tile_data``'s bytes of a tile and each component's
    bytes a sample."""
    chunks, sizes = [], []
    for plane, comp in zip(tile.planes, comps):
        csiz = (comp.prec + 7) >> 3
        csiz = 4 if csiz == 3 else csiz
        sizes.append(csiz)
        dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[csiz]
        chunks.append((plane.astype(np.int64) & (1 << 8 * csiz) - 1).astype(dtype).tobytes())
    return b"".join(chunks), sizes


def _words(buf: bytes, base: int, csiz: int, w: int, h: int, dx: int, dy: int) -> np.ndarray:
    """Pillow's reads of one component: (h, w) unsigned words, row y at
    ``base + csiz * (y // dy) * (w // dx)`` and sample ``x // dx``."""
    stride = w // dx
    dtype = {1: np.uint8, 2: "<u2", 4: "<u4"}[csiz]
    if dx == 1 and dy == 1:
        need = base + csiz * w * h
        if need > len(buf):
            buf = buf + bytes(need - len(buf))
        return np.frombuffer(buf, dtype, w * h, base).reshape(h, w).astype(np.uint32)
    # a subsampled row may read on into the next one, as Pillow's does
    index = (np.arange(h) // dy)[:, None] * stride + (np.arange(w) // dx)[None, :]
    count = int(index.max()) + 1 if index.size else 0
    if base + csiz * count > len(buf):
        buf = buf + bytes(base + csiz * count - len(buf))
    return np.frombuffer(buf, dtype, count, base)[index].astype(np.uint32)


def _shifted(words: np.ndarray, comp, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` in C's 32-bit unsigned
    arithmetic, before the store into a ``bits``-bit sample."""
    shift = bits - comp.prec
    offset = (1 << (comp.prec - 1)) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = words + np.uint32(offset & 0xFFFFFFFF)          # wraps as C's unsigned sum
    v = v >> np.uint32(-shift) if shift < 0 else v << np.uint32(min(shift, 31))
    if shift > 31:
        v = np.zeros_like(v)
    return v.astype(np.uint8 if bits == 8 else np.uint16)


def _unpack(kind: str, tile: j2k.Tile, comps):
    """The (h, w, 4) or (h, w) samples one of Pillow's unpackers writes for
    a tile, Pillow's 4-byte pixels for the 3- and 4-band modes."""
    buf, sizes = _buffer(tile, comps)
    w, h = tile.x1 - tile.x0, tile.y1 - tile.y0
    if kind in ("gray_l", "gray_i"):
        bits = 16 if kind == "gray_i" else 8
        return _shifted(_words(buf, 0, sizes[0], w, h, 1, 1), comps[0], bits)
    if kind == "gray_rgb":
        g = _shifted(_words(buf, 0, sizes[0], w, h, 1, 1), comps[0], 8)
        return np.stack([g, g, g, np.full_like(g, 255)], -1)
    if kind == "graya_la":
        g = _shifted(_words(buf, 0, sizes[0], w, h, 1, 1), comps[0], 8)
        a = _shifted(_words(buf, sizes[0] * w * h, sizes[1], w, h, 1, 1), comps[1], 8)
        return np.stack([g, g, g, a], -1)
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    bands, base = [], 0
    for c in range(n):
        comp = comps[c]
        bands.append(_shifted(_words(buf, base, sizes[c], w, h, comp.dx, comp.dy), comp, 8))
        base += sizes[c] * (w // comp.dx) * (h // comp.dy)
    if n == 3:
        bands.append(np.full_like(bands[0], 255))
    px = np.stack(bands, -1)
    if kind.startswith("sycc"):
        px[..., :3] = ycbcr_to_rgb(px[..., :3])
    return px


def decode_jp2(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A JPEG 2000 file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where Pillow
    refuses it, ``NotThisFormat`` where its ``_open`` hands it on."""
    try:
        kind, (width, height), mode, palette = _pillow_header(data)
    except NotThisFormat as err:
        raise NotThisFormat(f"{name}: JPEG 2000: {err}") from None
    except (ValueError, struct.error) as err:
        raise ValueError(f"{name}: JPEG 2000: {err}") from None
    try:
        if kind == "jp2":
            space, at, ihdr = _openjpeg_jp2(data)
            cs = data[at:]
        else:
            space, cs, ihdr = UNSPECIFIED, data, None
        hdr, tiles = j2k.decode_tiles(cs, native, ihdr)
    except FormatNotRead as err:
        raise FormatNotRead(name, err.format) from None
    except (ValueError, IndexError) as err:
        raise ValueError(f"{name}: JPEG 2000: broken data stream ({err})") from None
    comps = hdr.comps
    if not 1 <= len(comps) <= 4:
        raise ValueError(f"{name}: JPEG 2000: broken data stream ({len(comps)} components)")
    sub = [c.dx != 1 or c.dy != 1 for c in comps]
    subsampled = any(sub)
    if space in (UNSPECIFIED, UNKNOWN):
        # Pillow's guess: YCbCr where the first subsampled component is a chroma one
        first = sub.index(True) if subsampled else -1
        space = GRAY if len(comps) <= 2 else (SYCC if first in (1, 2) else SRGB)
    found = _UNPACKERS.get((mode, space, len(comps)))
    if found is None or (subsampled and not found[1]):
        raise ValueError(f"{name}: JPEG 2000: broken data stream (no unpacker for {mode} from "
                         f"{len(comps)} components)")
    unpacker = found[0]
    bands = 1 if unpacker in ("gray_l", "gray_i") else 4
    out = np.zeros((height, width) + ((bands,) if bands > 1 else ()),
                   np.uint16 if unpacker == "gray_i" else np.uint8)
    for tile in tiles:
        if tile.x0 >= tile.x1 or tile.y0 >= tile.y1 or tile.x0 < hdr.x0 or tile.y0 < hdr.y0 \
                or tile.x1 - hdr.x0 > width or tile.y1 - hdr.y0 > height:
            raise ValueError(f"{name}: JPEG 2000: broken data stream (a tile outside the "
                             "image)")
        x0, y0 = tile.x0 - hdr.x0, tile.y0 - hdr.y0
        out[y0:y0 + tile.y1 - tile.y0, x0:x0 + tile.x1 - tile.x0] = _unpack(unpacker, tile,
                                                                             comps)
    if mode in ("L", "P", "I;16"):
        return Decoded(out, mode, palette)
    if mode in ("LA", "PA"):
        return Decoded(np.ascontiguousarray(out[..., [0, 3]]), mode, palette)
    if mode == "RGB":
        return Decoded(np.ascontiguousarray(out[..., :3]), mode)
    return Decoded(out, mode)
