"""The ISOBMFF/HEIF still-image container of AVIF files, as libavif 1.3.0's
``avifDecoderParse`` reads it for Pillow 12.1.0.

:func:`parse_avif` walks the top-level boxes (``ftyp``, ``meta``, ``moov``,
``mdat``) and the ``meta`` box's ``hdlr``, ``pitm``, ``iloc`` (versions 0-2,
construction methods 0 and 1 with ``idat``), ``iinf``/``infe`` (versions 2
and 3), ``iref`` (``auxl``, ``thmb``, ``cdsc``, ``dimg``, ``prem``) and
``iprp`` (``ipco`` and ``ipma`` of either flag width). Of the properties it reads ``ispe``, ``av1C``, ``colr`` ``nclx`` and
``auxC``. It gives the primary item's AV1 payload, its ``ispe`` size and
``nclx``, and its alpha item's payload (the ``auxl`` item whose ``auxC`` names
alpha) with whether the primary item's ``prem`` reference makes that alpha
premultiplied. libavif leaves ``irot``, ``imir``, ``clap``, ICC profiles and
``pixi`` to the application, and Pillow applies none of them to the pixels
(it reports the first two as the Exif orientation), so they are passed over.

Refused with ``utils.modes.FormatNotRead`` (format "AVIF", the detail naming
what is not read): a ``grid`` primary item, an ``avis`` sequence (the
``moov`` track path libavif takes for that brand) and a primary item that
is not ``av01``. Whatever libavif rejects (a box or extent past the end of
the file, a missing ``ispe`` or ``av1C``) raises a ``ValueError`` naming the
file. No PIL here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from coma_tpu_torch.utils.modes import FormatNotRead

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


@dataclass
class Item:
    """One ``infe`` entry with what ``iloc``, ``ipma`` and ``iref`` say of it."""
    item_id: int
    item_type: bytes = b""
    construction: int = 0
    extents: list = field(default_factory=list)        # (offset, length)
    props: list = field(default_factory=list)          # (box type, payload)
    refs: dict = field(default_factory=dict)           # reference type -> [to item ids]

    def prop(self, kind: bytes) -> Optional[bytes]:
        for t, payload in self.props:
            if t == kind:
                return payload
        return None


@dataclass
class AvifImage:
    """The primary item's AV1 payload and properties, and its alpha item's."""
    color: bytes
    alpha: Optional[bytes]
    premultiplied: bool             # the primary item's prem reference to the alpha item
    width: int                      # ispe
    height: int
    nclx: Optional[tuple]           # (primaries, transfer, matrix, full range) of colr nclx


class _Reader:
    def __init__(self, data: bytes, name: str, start: int = 0, end: Optional[int] = None):
        self.data, self.name, self.pos = data, name, start
        self.end = len(data) if end is None else end

    def fail(self, what: str):
        raise ValueError(f"{self.name}: AVIF: {what} (libavif refuses it too)")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            self.fail("a box runs past its parent or the end of the file (truncated data)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def boxes(self):
        """(type, payload start, payload end) of each box up to ``end``."""
        while self.pos < self.end:
            size = self.u(4)
            kind = self.take(4)
            if size == 1:
                size = self.u(8) - 16
            elif size == 0:
                size = self.end - self.pos
            else:
                size -= 8
            if size < 0 or self.pos + size > self.end:
                self.fail(f"box {kind!r} runs past the end of the file (truncated data)")
            start = self.pos
            self.pos += size
            yield kind, start, start + size


def _full(r: _Reader) -> tuple:
    word = r.u(4)
    return word >> 24, word & 0xFFFFFF


def _iloc(r: _Reader, items: dict) -> None:
    version, _ = _full(r)
    if version > 2:
        r.fail(f"iloc version {version}")
    sizes = r.u(1)
    offset_size, length_size = sizes >> 4, sizes & 15
    sizes = r.u(1)
    base_offset_size, index_size = sizes >> 4, (sizes & 15) if version else 0
    for n in (offset_size, length_size, base_offset_size, index_size):
        if n not in (0, 4, 8):
            r.fail(f"an iloc field of {n} bytes")
    count = r.u(2 if version < 2 else 4)
    for _ in range(count):
        item_id = r.u(2 if version < 2 else 4)
        item = items.setdefault(item_id, Item(item_id))
        if version:
            item.construction = r.u(2) & 15
        r.u(2)                                          # data_reference_index
        base = r.u(base_offset_size)
        for _ in range(r.u(2)):
            r.u(index_size)
            offset = r.u(offset_size)
            item.extents.append((base + offset, r.u(length_size)))


def _iinf(r: _Reader, items: dict) -> None:
    version, _ = _full(r)
    r.u(2 if version == 0 else 4)                       # entry_count
    for kind, start, end in r.boxes():
        if kind != b"infe":
            continue
        sub = _Reader(r.data, r.name, start, end)
        infe_version, _ = _full(sub)
        if infe_version not in (2, 3):
            sub.fail(f"infe version {infe_version}")
        item_id = sub.u(2 if infe_version == 2 else 4)
        sub.u(2)                                        # item_protection_index
        items.setdefault(item_id, Item(item_id)).item_type = sub.take(4)


def _iref(r: _Reader, items: dict) -> None:
    version, _ = _full(r)
    width = 2 if version == 0 else 4
    for kind, start, end in r.boxes():
        sub = _Reader(r.data, r.name, start, end)
        src = sub.u(width)
        for _ in range(sub.u(2)):
            items.setdefault(src, Item(src)).refs.setdefault(kind, []).append(sub.u(width))


def _iprp(r: _Reader, items: dict) -> None:
    props = []
    associations = []
    for kind, start, end in r.boxes():
        if kind == b"ipco":
            sub = _Reader(r.data, r.name, start, end)
            props = [(k, r.data[s:e]) for k, s, e in sub.boxes()]
        elif kind == b"ipma":
            sub = _Reader(r.data, r.name, start, end)
            version, flags = _full(sub)
            for _ in range(sub.u(4)):
                item_id = sub.u(2 if version < 1 else 4)
                for _ in range(sub.u(1)):
                    value = sub.u(2 if flags & 1 else 1)  # the essential bit, the index
                    associations.append((item_id, value & (0x7FFF if flags & 1 else 0x7F)))
    for item_id, index in associations:
        if index == 0:
            continue
        if index > len(props):
            r.fail(f"an ipma association to property {index} of {len(props)}")
        items.setdefault(item_id, Item(item_id)).props.append(props[index - 1])


def _payload(item: Item, data: bytes, idat: Optional[bytes], name: str) -> bytes:
    if item.construction not in (0, 1):
        raise ValueError(f"{name}: AVIF: iloc construction method {item.construction} "
                         "(libavif refuses it too)")
    source = data if item.construction == 0 else (idat or b"")
    out = bytearray()
    for offset, length in item.extents:
        if offset + length > len(source) or length == 0:
            raise ValueError(f"{name}: AVIF: item {item.item_id}'s data runs past the end of the "
                             "file (truncated data; libavif refuses it too)")
        out += source[offset:offset + length]
    if not out:
        raise ValueError(f"{name}: AVIF: item {item.item_id} has no data (libavif refuses it too)")
    return bytes(out)


def _nclx(item: Item) -> Optional[tuple]:
    for kind, payload in item.props:
        if kind == b"colr" and payload[:4] == b"nclx" and len(payload) >= 11:
            return (int.from_bytes(payload[4:6], "big"), int.from_bytes(payload[6:8], "big"),
                    int.from_bytes(payload[8:10], "big"), payload[10] >> 7)
    return None


def parse_avif(data: bytes, name: str) -> AvifImage:
    """The file's primary image as libavif's item path finds it."""
    r = _Reader(data, name)
    top = {}
    for kind, start, end in r.boxes():
        top.setdefault(kind, (start, end))
    if b"ftyp" not in top:
        r.fail("no ftyp box")
    start, end = top[b"ftyp"]
    brands = [data[start:start + 4]] + [data[k:k + 4] for k in range(start + 8, end - 3, 4)]
    if b"avif" not in brands and b"avis" not in brands:
        r.fail(f"file type brands {brands!r} name neither avif nor avis")
    if brands[0] == b"avis" and b"moov" in top:
        raise FormatNotRead(name, "AVIF", " (an avis image sequence: the moov track path)")
    if b"meta" not in top:
        r.fail("no meta box")
    meta = _Reader(data, name, *top[b"meta"])
    _full(meta)
    items, primary, idat, handler = {}, None, None, None
    for kind, start, end in meta.boxes():
        sub = _Reader(data, name, start, end)
        if kind == b"hdlr":
            _full(sub)
            sub.u(4)
            handler = sub.take(4)
        elif kind == b"pitm":
            version, _ = _full(sub)
            primary = sub.u(2 if version == 0 else 4)
        elif kind == b"iloc":
            _iloc(sub, items)
        elif kind == b"iinf":
            _iinf(sub, items)
        elif kind == b"iref":
            _iref(sub, items)
        elif kind == b"iprp":
            _iprp(sub, items)
        elif kind == b"idat":
            idat = data[start:end]
    if handler != b"pict":
        r.fail(f"meta handler {handler!r}, not 'pict'")
    if primary is None or primary not in items or not items[primary].item_type:
        r.fail("no primary item")
    item = items[primary]
    if item.item_type == b"grid":
        raise FormatNotRead(name, "AVIF", " (a grid primary item)")
    if item.item_type != b"av01":
        raise FormatNotRead(name, "AVIF", f" (a primary item of type {item.item_type!r})")
    ispe = item.prop(b"ispe")
    if ispe is None or len(ispe) < 12:
        r.fail("the primary item has no ispe property")
    if item.prop(b"av1C") is None:
        r.fail("the primary item has no av1C property")
    alpha = None
    for other in items.values():
        if other.item_type != b"av01" or primary not in other.refs.get(b"auxl", []):
            continue
        aux = other.prop(b"auxC")
        if aux is not None and aux[4:].split(b"\0")[0] in ALPHA_URNS:
            alpha = other
            break
    return AvifImage(
        color=_payload(item, data, idat, name),
        alpha=_payload(alpha, data, idat, name) if alpha is not None else None,
        premultiplied=alpha is not None and alpha.item_id in item.refs.get(b"prem", []),
        width=int.from_bytes(ispe[4:8], "big"), height=int.from_bytes(ispe[8:12], "big"),
        nclx=_nclx(item))
