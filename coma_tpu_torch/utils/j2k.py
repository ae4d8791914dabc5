"""JPEG 2000 codestreams (ISO 15444-1), as OpenJPEG 2.5.4 decodes them for
Pillow 12.1.0: the markers, the tile and code-block geometry of
``opj_tcd``, tier-2 (packets) and the calls into tier-1 and reconstruction.

- Main and tile-part headers: SIZ, COD, COC, QCD, QCC (no quantisation,
  scalar derived, scalar expounded; guard bits), RGN, POC, PPM, PPT, and
  TLM, PLM, PLT, CRG and COM passed over; SOT, SOD and EOC. A tile's COD or
  QCD is copied to all its components, as OpenJPEG copies it; COC and QCC
  then set one. A COD or QCD missing from the main header is an error.
- Tiles of one or more tile-parts, the image and tile offsets, component
  subsampling (XRsiz/YRsiz); resolutions, precincts (``PPx``/``PPy``) and
  code-blocks sized as ``opj_tcd_init_tile`` sizes them.
- Packets (``opj_t2_read_packet_header``/``_data``): the inclusion and
  zero-bit-plane tag trees, pass counts, Lblock, segment lengths per
  code-block style, SOP markers (a missing one only warns) and EPH ones (a
  missing one, or no room for it, fails, as in OpenJPEG), packet
  headers from PPM or PPT; all five progression orders and POC changes,
  iterated as ``opj_pi_next_lrcp``/``rlcp``/``rpcl``/``pcrl``/``cprl``
  iterate them (their position steps and subsampled components included),
  each packet once. A segment that runs past its tile's data is an error,
  as in OpenJPEG's strict mode.
- Tier-1 (``utils/j2k_t1.py``), dequantisation (the reversible path halves
  the samples; the irreversible one multiplies by ``0.5f * stepsize``,
  OpenJPEG's step size with its ``BUG_WEIRD_TWO_INVK`` gain of 0),
  the inverse DWT, RCT or ICT and the level shift (``utils/j2k_dwt.py``).
- HTJ2K (Part 15) code-blocks raise ``utils.modes.FormatNotRead``.

:func:`decode_tiles` gives what OpenJPEG's ``opj_decode_tile_data`` gives
each tile, in the order ``opj_read_tile_header`` returns them;
``utils/jp2.py`` unpacks them as Pillow does. With ``native`` (None: where
``native/src/j2k_decode.cpp`` builds) the packets (``j2k_tier2``), tier-1,
the DWT, the component transform and the level shift run in C++; the plain
path here is their reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from coma_tpu_torch.utils import j2k_dwt, j2k_t1
from coma_tpu_torch.utils.modes import FormatNotRead

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, RGN, POC = 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F
TLM, PLM, PLT, PPM, PPT, CRG, COM = 0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61, 0xFF63, 0xFF64
LRCP, RLCP, RPCL, PCRL, CPRL = range(5)


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def ceildivpow2(a: int, b: int) -> int:
    return -(-a >> b)


@dataclass
class Comp:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class Tccp:
    """A component's coding and quantisation parameters (``opj_tccp_t``)."""
    numres: int = 1
    cblkw: int = 6
    cblkh: int = 6
    cblksty: int = 0
    qmfbid: int = 1
    prcw: list = field(default_factory=lambda: [15] * 33)
    prch: list = field(default_factory=lambda: [15] * 33)
    qntsty: int = 0
    numgbits: int = 2
    stepsizes: list = field(default_factory=lambda: [(0, 0)] * 97)
    roishift: int = 0

    def copy(self) -> "Tccp":
        return Tccp(self.numres, self.cblkw, self.cblkh, self.cblksty, self.qmfbid,
                    list(self.prcw), list(self.prch), self.qntsty, self.numgbits,
                    list(self.stepsizes), self.roishift)


@dataclass
class Tcp:
    """A tile's coding parameters (``opj_tcp_t``)."""
    csty: int = 0
    prg: int = 0
    numlayers: int = 1
    mct: int = 0
    tccps: list = field(default_factory=list)
    pocs: list = field(default_factory=list)
    ppt_parts: dict = field(default_factory=dict)   # Zppt -> the marker's headers

    def copy(self) -> "Tcp":
        return Tcp(self.csty, self.prg, self.numlayers, self.mct,
                   [t.copy() for t in self.tccps], list(self.pocs))


@dataclass
class Header:
    x0: int
    y0: int
    x1: int
    y1: int
    tx0: int
    ty0: int
    tdx: int
    tdy: int
    comps: list
    tcp: Tcp
    ppm: Optional[bytes] = None

    @property
    def tiles_across(self) -> int:
        return ceildiv(self.x1 - self.tx0, self.tdx)

    @property
    def tiles_down(self) -> int:
        return ceildiv(self.y1 - self.ty0, self.tdy)


@dataclass
class Tile:
    """``opj_decode_tile_data``'s output for one tile: its index, bounds on
    the reference grid and each component's samples (int32, clamped to the
    component's range)."""
    index: int
    x0: int
    y0: int
    x1: int
    y1: int
    planes: list


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise ValueError("a marker segment ends early")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "big")
        self.pos += n
        return v


def _read_spcod(r: _Reader, tccp: Tccp, precincts: bool) -> None:
    """``opj_j2k_read_SPCod_SPCoc``."""
    if r.end - r.pos < 5:
        raise ValueError("error reading SPCod SPCoc element")
    tccp.numres = r.u(1) + 1
    if tccp.numres > 33:
        raise ValueError(f"invalid value for numresolutions: {tccp.numres}")
    tccp.cblkw, tccp.cblkh = r.u(1) + 2, r.u(1) + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise ValueError("invalid cblkw/cblkh combination")
    tccp.cblksty = r.u(1)
    if tccp.cblksty & 0x80:
        raise ValueError("unsupported mixed HT code-block style")
    tccp.qmfbid = r.u(1)
    if tccp.qmfbid > 1:
        raise ValueError("invalid transformation found")
    if precincts:
        if r.end - r.pos < tccp.numres:
            raise ValueError("error reading SPCod SPCoc element")
        for i in range(tccp.numres):
            v = r.u(1)
            if i and (v & 0xF == 0 or v >> 4 == 0):
                raise ValueError("invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
    else:
        tccp.prcw[:], tccp.prch[:] = [15] * 33, [15] * 33


def _read_sqcd(r: _Reader, tccp: Tccp) -> None:
    """``opj_j2k_read_SQcd_SQcc`` (more than 97 step sizes: the rest passed
    over, as OpenJPEG warns and does)."""
    if r.end - r.pos < 1:
        raise ValueError("error reading SQcd or SQcc element")
    v = r.u(1)
    tccp.qntsty, tccp.numgbits = v & 0x1F, v >> 5
    left = r.end - r.pos
    bands = 1 if tccp.qntsty == 1 else (left if tccp.qntsty == 0 else left // 2)
    width = 1 if tccp.qntsty == 0 else 2
    if left < bands * width:
        raise ValueError("error reading SQcd or SQcc element")
    steps = list(tccp.stepsizes)
    for b in range(bands):
        v = r.u(width)
        if b < 97:
            steps[b] = (v >> 3, 0) if width == 1 else (v >> 11, v & 0x7FF)
    if tccp.qntsty == 1:
        expn, mant = steps[0]
        for b in range(1, 97):
            steps[b] = (max(expn - (b - 1) // 3, 0), mant)
    tccp.stepsizes = steps


def _comp_index(r: _Reader, ncomps: int, what: str) -> int:
    c = r.u(1 if ncomps <= 256 else 2)
    if c >= ncomps:
        raise ValueError(f"error reading {what} marker (bad component number)")
    return c


def _read_marker(marker: int, r: _Reader, ncomps: int, tcp: Tcp, state: dict) -> None:
    """One marker segment of a main or tile-part header into ``tcp`` (or
    ``state``), as OpenJPEG's handler reads and checks it."""
    size = r.end - r.pos
    if marker == COD:
        if size < 5:
            raise ValueError("error reading COD marker")
        tcp.csty = r.u(1)
        if tcp.csty & ~0x7:
            raise ValueError("unknown Scod value in COD marker")
        tcp.prg = r.u(1)                     # one over 4 fails the tile's packets
        tcp.numlayers = r.u(2)
        if not 0 < tcp.numlayers <= 65535:
            raise ValueError("invalid number of layers in COD marker")
        tcp.mct = r.u(1)
        if tcp.mct > 1:
            raise ValueError("invalid multiple component transformation")
        _read_spcod(r, tcp.tccps[0], bool(tcp.csty & 1))
        if r.pos != r.end:
            raise ValueError("error reading COD marker")
        for t in tcp.tccps[1:]:
            t.numres, t.cblkw, t.cblkh = tcp.tccps[0].numres, tcp.tccps[0].cblkw, \
                tcp.tccps[0].cblkh
            t.cblksty, t.qmfbid = tcp.tccps[0].cblksty, tcp.tccps[0].qmfbid
            t.prcw, t.prch = list(tcp.tccps[0].prcw), list(tcp.tccps[0].prch)
        state["cod"] = True
    elif marker == COC:
        if size < (1 if ncomps <= 256 else 2) + 1:
            raise ValueError("error reading COC marker")
        c = _comp_index(r, ncomps, "COC")
        scoc = r.u(1)
        _read_spcod(r, tcp.tccps[c], bool(scoc & 1))
        if r.pos != r.end:
            raise ValueError("error reading COC marker")
    elif marker in (QCD, QCC):
        c = 0
        if marker == QCC:
            if size < (1 if ncomps <= 256 else 2):
                raise ValueError("error reading QCC marker")
            c = _comp_index(r, ncomps, "QCC")
        _read_sqcd(r, tcp.tccps[c])
        if r.pos != r.end:
            raise ValueError(f"error reading {'QCD' if marker == QCD else 'QCC'} marker")
        if marker == QCD:
            for t in tcp.tccps[1:]:
                t.qntsty, t.numgbits = tcp.tccps[0].qntsty, tcp.tccps[0].numgbits
                t.stepsizes = list(tcp.tccps[0].stepsizes)
            state["qcd"] = True
    elif marker == RGN:
        if size != 2 + (1 if ncomps <= 256 else 2):
            raise ValueError("error reading RGN marker")
        c = _comp_index(r, ncomps, "RGN")
        r.u(1)                               # Srgn: OpenJPEG takes any as maxshift
        tcp.tccps[c].roishift = r.u(1)
    elif marker == POC:
        room = 1 if ncomps <= 256 else 2
        n, rest = divmod(size, 5 + 2 * room)
        if n == 0 or rest:
            raise ValueError("error reading POC marker")
        if len(tcp.pocs) + n >= 32:
            raise ValueError(f"too many POCs {len(tcp.pocs) + n}")
        for _ in range(n):
            resno0, compno0 = r.u(1), r.u(room)
            layno1 = min(r.u(2), tcp.numlayers)
            resno1, compno1, prg = r.u(1), min(r.u(room), ncomps), r.u(1)
            tcp.pocs.append((resno0, compno0, layno1, resno1, compno1, prg))
    elif marker == PPT:
        if state.get("ppm"):
            raise ValueError("a PPT marker where the main header has PPM")
        if size < 2:
            raise ValueError("error reading PPT marker")
        z = r.u(1)                           # Zppt: the markers join in its order
        if z in tcp.ppt_parts:
            raise ValueError(f"Zppt {z} already read")
        tcp.ppt_parts[z] = r.data[r.pos:r.end]
    elif marker == PPM:
        if size < 2:
            raise ValueError("error reading PPM marker")
        z = r.u(1)                           # Zppm
        parts = state.setdefault("ppm_parts", {})
        if z in parts:
            raise ValueError(f"Zppm {z} already read")
        parts[z] = r.data[r.pos:r.end]
        state["ppm"] = True
    elif marker == TLM:
        if size < 2:
            raise ValueError("error reading TLM marker")
        r.u(1)
        stlm = r.u(1)
        st = (stlm >> 4) & 3
        if st == 3 or (size - 2) % (st + ((stlm >> 6) & 1) * 2 + 2):
            raise ValueError("error reading TLM marker")
    elif marker in (PLM, PLT):
        if size < 1:
            raise ValueError(f"error reading {'PLM' if marker == PLM else 'PLT'} marker")
        if marker == PLT:
            r.u(1)                           # Zplt
            length = 0
            for b in r.data[r.pos:r.end]:
                length = (length | (b & 0x7F)) << 7 if b & 0x80 else 0
            if length:
                raise ValueError("error reading PLT marker")
    elif marker == CRG:
        if size != 4 * ncomps:
            raise ValueError("error reading CRG marker")


def _merge_ppm(parts: dict) -> bytes:
    """``opj_j2k_merge_ppm``: the packet headers of every PPM marker in Zppm
    order, their Nppm lengths dropped, as one stream; an Nppm past the last
    marker is corruption."""
    out, remaining = bytearray(), 0
    for z in sorted(parts):
        part = parts[z]
        pos = 0
        while pos < len(part):
            if remaining:
                take = min(remaining, len(part) - pos)
                out += part[pos:pos + take]
                pos += take
                remaining -= take
                continue
            if len(part) - pos < 4:
                raise ValueError("not enough bytes to read Nppm")
            remaining = int.from_bytes(part[pos:pos + 4], "big")
            pos += 4
    if remaining:
        raise ValueError("corrupted PPM markers")
    return bytes(out)


# OpenJPEG's marker handlers (``j2k_memory_marker_handler_tab``) and the
# headers they may appear in: m main, t tile-part, s SIZ's place
_KNOWN = {SOT: "mt", COD: "mt", COC: "mt", RGN: "mt", QCD: "mt", QCC: "mt", POC: "mt",
          SIZ: "s", TLM: "m", PLM: "m", PLT: "t", PPM: "m", PPT: "t", 0xFF91: "", CRG: "m",
          COM: "mt", 0xFF74: "mt", 0xFF78: "m", 0xFF50: "m", 0xFF59: "m", 0xFF75: "mt",
          0xFF77: "mt"}


def _next_marker(cs: bytes, pos: int, where: str):
    """The marker at ``pos``, an unknown one passed over as
    ``opj_j2k_read_unk`` does (two bytes at a time to a known marker):
    (marker, its position)."""
    marker = int.from_bytes(cs[pos:pos + 2], "big")
    if marker < 0xFF00:
        raise ValueError(f"a marker ID was expected (0xff--) instead of {marker:#x}")
    if marker in _KNOWN or marker in (SOD, EOC):
        return marker, pos
    while True:                              # an unknown marker
        pos += 2
        if pos + 2 > len(cs):
            raise ValueError("stream too short (an unknown marker)")
        marker = int.from_bytes(cs[pos:pos + 2], "big")
        if marker < 0xFF00:
            continue
        if marker in _KNOWN:
            if where not in _KNOWN[marker]:
                raise ValueError("marker is not compliant with its position")
            return marker, pos


def read_header(cs: bytes, ihdr_size=None):
    """The main header (``opj_j2k_read_header_procedure``): (``Header``,
    position of the first SOT). ``ihdr_size`` is a JP2's (width, height),
    which SIZ must match."""
    if cs[:2] != b"\xff\x4f":
        raise ValueError("expected a SOC marker")
    if cs[2:4] != b"\xff\x51":
        raise ValueError("marker is not compliant with its position (SIZ expected)")
    if len(cs) < 6:
        raise ValueError("stream too short")
    lsiz = int.from_bytes(cs[4:6], "big")
    if lsiz < 2 or 4 + lsiz > len(cs):
        raise ValueError("stream too short (SIZ)")
    r = _Reader(cs, 6, 4 + lsiz)
    if lsiz - 2 < 36 or (lsiz - 38) % 3:
        raise ValueError("error with SIZ marker size")
    r.u(2)                                   # Rsiz
    x1, y1, x0, y0 = r.u(4), r.u(4), r.u(4), r.u(4)
    tdx, tdy, tx0, ty0 = r.u(4), r.u(4), r.u(4), r.u(4)
    ncomps = r.u(2)
    if ncomps >= 16385:
        raise ValueError(f"number of components is illegal: {ncomps}")
    if ncomps != (lsiz - 38) // 3:
        raise ValueError("number of components is not compatible with the SIZ size")
    if x0 >= x1 or y0 >= y1:
        raise ValueError("negative or zero image size")
    if not tdx or not tdy:
        raise ValueError("invalid tile size")
    if tx0 > x0 or ty0 > y0 or tx0 + tdx <= x0 or ty0 + tdy <= y0:
        raise ValueError("illegal tile offset")
    if ihdr_size is not None and ihdr_size != (x1 - x0, y1 - y0):
        raise ValueError(f"IHDR {ihdr_size} vs. SIZ {(x1 - x0, y1 - y0)}")
    comps = []
    for _ in range(ncomps):
        ssiz, dx, dy = r.u(1), r.u(1), r.u(1)
        if not dx or not dy:
            raise ValueError("invalid component subsampling")
        comps.append(Comp((ssiz & 0x7F) + 1, bool(ssiz & 0x80), dx, dy))
        if comps[-1].prec > 31:
            raise ValueError("a component precision over 31 bits")
    tcp = Tcp(tccps=[Tccp() for _ in comps])
    hdr = Header(x0, y0, x1, y1, tx0, ty0, tdx, tdy, comps, tcp)
    tw, th = hdr.tiles_across, hdr.tiles_down
    if not tw or not th or tw > 65535 // th:
        raise ValueError(f"invalid number of tiles: {tw} x {th}")
    pos = 4 + lsiz
    state: dict = {}
    while True:
        if pos + 2 > len(cs):
            raise ValueError("stream too short (main header)")
        marker, pos = _next_marker(cs, pos, "m")
        if marker == SOT:
            break
        if marker in (SIZ, SOD, EOC) or "m" not in _KNOWN[marker]:
            raise ValueError("marker is not compliant with its position")
        if pos + 4 > len(cs):
            raise ValueError("stream too short")
        length = int.from_bytes(cs[pos + 2:pos + 4], "big")
        if length < 2:
            raise ValueError("invalid marker size")
        if pos + 2 + length > len(cs):
            raise ValueError("stream too short")
        _read_marker(marker, _Reader(cs, pos + 4, pos + 2 + length), ncomps, tcp, state)
        pos += 2 + length
    if not state.get("cod"):
        raise ValueError("required COD marker not found in main header")
    if not state.get("qcd"):
        raise ValueError("required QCD marker not found in main header")
    if state.get("ppm"):
        hdr.ppm = _merge_ppm(state["ppm_parts"])
    return hdr, pos


def _neoc(parts: dict) -> None:
    """A stream that ends right after a marker's code ends the codestream
    (OpenJPEG's NEOC): fine where no tile waits for more parts; a tile that
    does is decoded and the next tile header then fails, so Pillow fails."""
    if any(e["count"] and not e["done"] for e in parts.values()):
        raise ValueError("the stream ends while a tile waits for its parts")


def tile_parts(cs: bytes, hdr: Header, pos: int):
    """The tile-parts after the main header, as ``opj_j2k_read_tile_header``
    reads them: {tile index: its parts' header marker segments and joined
    data}, and the tiles in the order OpenJPEG decodes them (a tile as its
    last part arrives, one without TNsot as the next tile's part or the end
    comes; any still open at the end in index order)."""
    ntiles = hdr.tiles_across * hdr.tiles_down
    parts: dict = {}
    order: list = []
    last = None
    while True:
        if pos + 2 > len(cs):
            raise ValueError("stream too short: no EOC after the last tile-part")
        marker = int.from_bytes(cs[pos:pos + 2], "big")
        if marker == EOC:
            break
        if marker != SOT:
            raise ValueError(f"expected a SOT marker, found {marker:#06x}")
        if pos + 2 == len(cs):               # nothing after the marker: OpenJPEG's NEOC
            _neoc(parts)
            break
        if pos + 12 > len(cs) or int.from_bytes(cs[pos + 2:pos + 4], "big") != 10:
            raise ValueError("error reading SOT marker")
        isot = int.from_bytes(cs[pos + 4:pos + 6], "big")
        psot = int.from_bytes(cs[pos + 6:pos + 10], "big")
        tpsot, tnsot = cs[pos + 10], cs[pos + 11]
        if isot >= ntiles:
            raise ValueError(f"invalid tile number {isot}")
        if last is not None and last != isot and not parts[last]["done"]:
            parts[last]["done"] = True
            order.append(last)
        entry = parts.setdefault(isot, dict(segments=[], data=bytearray(), tnsot=0, done=False,
                                            count=0))
        if tpsot != entry["count"]:
            raise ValueError(f"invalid tile part index {tpsot} for tile {isot}")
        if psot and psot < 14 and psot != 12:
            raise ValueError(f"Psot value is not correct: {psot}")
        if entry["tnsot"] and tpsot >= entry["tnsot"]:
            raise ValueError("TPsot is not valid regards to the number of tile-parts")
        if tnsot:
            if tpsot >= tnsot:
                raise ValueError("TPsot is not valid regards to TNsot")
            entry["tnsot"] = tnsot
        end = len(cs) - 2 if psot == 0 else pos + max(psot, 14)
        p, ended = pos + 12, False
        while True:
            if p + 2 > min(end, len(cs)):
                raise ValueError("stream too short (tile-part header)")
            m, p = _next_marker(cs, p, "t")
            if m == SOD:
                if end > len(cs):            # opj_j2k_read_sod, in strict mode
                    raise ValueError("tile part length size inconsistent with stream length")
                p += 2
                break
            if p + 2 == len(cs):             # a marker the stream ends with: NEOC, the end
                ended = True
                break
            if m in (SIZ, SOT, EOC) or "t" not in _KNOWN[m]:
                raise ValueError("marker is not compliant with its position")
            length = int.from_bytes(cs[p + 2:p + 4], "big")
            if p + 4 > len(cs) or length < 2:
                raise ValueError("stream too short, or an invalid marker size")
            if p + 2 + length > end:
                raise ValueError("sot length is invalid")
            if p + 2 + length > len(cs):
                raise ValueError("marker size inconsistent with stream length")
            if m in (COD, COC, QCD, QCC) and entry["count"]:
                raise ValueError("marker is not compliant with its position")
            entry["segments"].append((m, p + 4, p + 2 + length))
            p += 2 + length
        if ended:
            if tnsot and tpsot + 1 == tnsot:
                # its last part by TNsot: OpenJPEG hands the tile on, and fails it
                raise ValueError("the stream ends in a tile's last tile-part header")
            _neoc(parts)
            break
        entry["data"] += cs[p:end]
        entry["count"] += 1
        if entry["tnsot"] and entry["count"] == entry["tnsot"]:
            entry["done"] = True
            order.append(isot)
        last = isot
        pos = end
    for isot in sorted(parts):              # OpenJPEG decodes only tiles that hold data
        if not parts[isot]["done"] and parts[isot]["count"]:
            order.append(isot)
    return parts, order


class _Bio:
    """``opj_bio_t`` reading packet headers (a byte after 0xFF gives 7
    bits; past the end it reads zeros)."""

    def __init__(self, data, pos: int, end: int):
        self.data, self.start, self.bp, self.end = data, pos, pos, end
        self.buf = 0
        self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


class _TagTree:
    """``opj_tgt_tree_t``: one flat list of nodes, level by level, each
    node's parent at (i // 2, j // 2) one level up; ``value`` 999 and
    ``low`` 0 at a reset."""

    _shapes: dict = {}                       # (w, h) -> (paths, size), shared by every tree

    def __init__(self, w: int, h: int):
        if (w, h) not in _TagTree._shapes:
            _TagTree._shapes[w, h] = self._shape(w, h)
        self.paths, self.size = _TagTree._shapes[w, h]
        self.reset()

    @staticmethod
    def _shape(w: int, h: int):
        """Each leaf's nodes, root first, and the count of nodes."""
        paths, levels, base = [], [], 0
        while True:
            levels.append((w, base))
            base += w * h
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        w0 = levels[0][0]
        for leaf in range(levels[1][1] if len(levels) > 1 else 1):
            i, j, path = leaf % w0, leaf // w0, []
            for w, start in levels:
                path.append(start + j * w + i)
                i, j = i >> 1, j >> 1
            paths.append(path[::-1])
        return paths, base

    def reset(self) -> None:
        self.value = [999] * self.size
        self.low = [0] * self.size

    def decode(self, bio: _Bio, leaf: int, threshold: int) -> int:
        value, lows = self.value, self.low
        low = 0
        for n in self.paths[leaf]:
            if low > lows[n]:
                lows[n] = low
            else:
                low = lows[n]
            while low < threshold and low < value[n]:
                if bio.bit():
                    value[n] = low
                else:
                    low += 1
            lows[n] = low
        return int(value[self.paths[leaf][-1]] < threshold)


class _Seg:
    __slots__ = ("maxpasses", "numpasses", "len", "newlen", "numnewpasses")

    def __init__(self, maxpasses: int):
        self.maxpasses, self.numpasses, self.len = maxpasses, 0, 0
        self.newlen = self.numnewpasses = 0


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs", "numsegs",
                 "numnewpasses", "chunks")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = self.numlenbits = 0
        self.segs: List[_Seg] = []
        self.numsegs = self.numnewpasses = 0
        self.chunks = bytearray()


class _Band:
    def __init__(self, bandno, x0, y0, x1, y1, numbps, stepsize):
        self.bandno, self.x0, self.y0, self.x1, self.y1 = bandno, x0, y0, x1, y1
        self.numbps, self.stepsize = numbps, stepsize
        self.precincts = []

    def empty(self) -> bool:
        return self.x1 - self.x0 == 0 or self.y1 - self.y0 == 0


class _Res:
    def __init__(self, x0, y0, x1, y1, pdx, pdy, pw, ph):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy, self.pw, self.ph = pdx, pdy, pw, ph
        self.bands: List[_Band] = []


def _init_tilec(comp: Comp, tccp: Tccp, tx0, ty0, tx1, ty1):
    """``opj_tcd_init_tile`` for one component: its bounds and resolutions,
    with their bands, precincts and code-blocks."""
    cx0, cy0 = ceildiv(tx0, comp.dx), ceildiv(ty0, comp.dy)
    cx1, cy1 = ceildiv(tx1, comp.dx), ceildiv(ty1, comp.dy)
    numres = tccp.numres
    resolutions = []
    for resno in range(numres):
        levelno = numres - 1 - resno
        rx0, ry0 = ceildivpow2(cx0, levelno), ceildivpow2(cy0, levelno)
        rx1, ry1 = ceildivpow2(cx1, levelno), ceildivpow2(cy1, levelno)
        pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
        tlpx, tlpy = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brpx, brpy = ceildivpow2(rx1, pdx) << pdx, ceildivpow2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brpx - tlpx) >> pdx
        ph = 0 if ry0 == ry1 else (brpy - tlpy) >> pdy
        res = _Res(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph)
        if resno == 0:
            tlcbgx, tlcbgy, cbgw, cbgh = tlpx, tlpy, pdx, pdy
        else:
            tlcbgx, tlcbgy, cbgw, cbgh = ceildivpow2(tlpx, 1), ceildivpow2(tlpy, 1), pdx - 1, \
                pdy - 1
        cblkw, cblkh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
        for bandno in ([0] if resno == 0 else [1, 2, 3]):
            if resno == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
            else:
                xb, yb = bandno & 1, bandno >> 1
                bx0 = ceildivpow2(cx0 - (xb << levelno), levelno + 1)
                by0 = ceildivpow2(cy0 - (yb << levelno), levelno + 1)
                bx1 = ceildivpow2(cx1 - (xb << levelno), levelno + 1)
                by1 = ceildivpow2(cy1 - (yb << levelno), levelno + 1)
            expn, mant = tccp.stepsizes[0 if resno == 0 else 3 * (resno - 1) + bandno]
            numbps = expn + tccp.numgbits - 1
            stepsize = float(np.float32((1.0 + mant / 2048.0) * 2.0 ** (comp.prec - expn)))
            band = _Band(bandno, bx0, by0, bx1, by1, numbps, stepsize)
            for precno in range(pw * ph):
                gx0 = tlcbgx + (precno % pw) * (1 << cbgw)
                gy0 = tlcbgy + (precno // pw) * (1 << cbgh)
                px0, py0 = max(gx0, bx0), max(gy0, by0)
                px1, py1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                tlx, tly = (px0 >> cblkw) << cblkw, (py0 >> cblkh) << cblkh
                brx, bry = ceildivpow2(px1, cblkw) << cblkw, ceildivpow2(py1, cblkh) << cblkh
                cw, ch = max((brx - tlx) >> cblkw, 0), max((bry - tly) >> cblkh, 0)
                cblks = []
                for k in range(cw * ch):
                    x = tlx + (k % cw) * (1 << cblkw)
                    y = tly + (k // cw) * (1 << cblkh)
                    cblks.append(_Cblk(max(x, px0), max(y, py0), min(x + (1 << cblkw), px1),
                                       min(y + (1 << cblkh), py1)))
                band.precincts.append(dict(cw=cw, ch=ch, cblks=cblks, incl=None, imsb=None,
                                           x0=px0, y0=py0, x1=px1, y1=py1))
            res.bands.append(band)
        resolutions.append(res)
    return (cx0, cy0, cx1, cy1), resolutions


class _EndPoc(Exception):
    """``opj_pi_next_*`` giving up on a progression (it returns false: the
    progression's packets end there, the tile goes on)."""


def _packets(hdr: Header, tcp: Tcp, tilecs, tx0, ty0, tx1, ty1):
    """The packets of a tile, (layer, resolution, component, precinct), in
    the order of ``opj_pi_next_*`` over each progression (POC) in turn."""
    comps = hdr.comps
    ncomps = len(comps)
    max_res = max(t.numres for t in tcp.tccps)
    max_prec = max([r.pw * r.ph for _, resolutions in tilecs for r in resolutions] + [0])
    if tcp.pocs:
        progs = [(p[5], p[0], min(p[3], 33), p[1], p[4], p[2]) for p in tcp.pocs]
    else:
        progs = [(tcp.prg, 0, max_res, 0, ncomps, tcp.numlayers)]
    seen = set()

    def grid_step(compnos, per_comp):
        dx = dy = 0
        for c in compnos:
            comp = comps[c]
            resolutions = tilecs[c][1]
            n = len(resolutions)
            for resno, res in enumerate(resolutions):
                sx = res.pdx + n - 1 - resno
                sy = res.pdy + n - 1 - resno
                if sx < 32 and comp.dx <= 0xFFFFFFFF // (1 << sx):
                    v = comp.dx * (1 << sx)
                    dx = v if not dx else min(dx, v)
                if sy < 32 and comp.dy <= 0xFFFFFFFF // (1 << sy):
                    v = comp.dy * (1 << sy)
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def position(compno, resno, x, y):
        """The precinct at position (x, y), or None where OpenJPEG's
        ``opj_pi_next_rpcl`` body continues."""
        comp = comps[compno]
        resolutions = tilecs[compno][1]
        if resno >= len(resolutions):
            return None
        res = resolutions[resno]
        levelno = len(resolutions) - 1 - resno
        trx0, try0 = ceildiv(tx0, comp.dx << levelno), ceildiv(ty0, comp.dy << levelno)
        trx1, try1 = ceildiv(tx1, comp.dx << levelno), ceildiv(ty1, comp.dy << levelno)
        rpx, rpy = res.pdx + levelno, res.pdy + levelno
        if not (y % (comp.dy << rpy) == 0 or (y == ty0 and (try0 << levelno) % (1 << rpy))):
            return None
        if not (x % (comp.dx << rpx) == 0 or (x == tx0 and (trx0 << levelno) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (ceildiv(x, comp.dx << levelno) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, comp.dy << levelno) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def emit(layno, resno, compno, precno):
        key = (layno, resno, compno, precno)
        if key in seen:
            return None
        if precno >= max_prec or resno >= max_res:
            raise _EndPoc("invalid access to pi->include")
        seen.add(key)
        return key

    def one(prg, res0, res1, comp0, comp1, lay1):
        if prg > CPRL and not tcp.pocs:
            raise ValueError("unknown progression order in COD marker")
        if comp0 >= ncomps or comp1 > ncomps:
            return                       # opj_pi_next_*: an error, and no packets
        if prg == LRCP:
            for lay in range(lay1):
                for r in range(res0, res1):
                    for c in range(comp0, comp1):
                        if r >= len(tilecs[c][1]):
                            continue
                        res = tilecs[c][1][r]
                        for p in range(res.pw * res.ph):
                            if emit(lay, r, c, p):
                                yield lay, r, c, p
        elif prg == RLCP:
            for r in range(res0, res1):
                for lay in range(lay1):
                    for c in range(comp0, comp1):
                        if r >= len(tilecs[c][1]):
                            continue
                        res = tilecs[c][1][r]
                        for p in range(res.pw * res.ph):
                            if emit(lay, r, c, p):
                                yield lay, r, c, p
        elif prg in (RPCL, PCRL):
            dx, dy = grid_step(range(ncomps), True)
            if not dx or not dy:
                return
            if prg == RPCL:
                for r in range(res0, res1):
                    for y in _steps(ty0, ty1, dy):
                        for x in _steps(tx0, tx1, dx):
                            for c in range(comp0, comp1):
                                p = position(c, r, x, y)
                                if p is None:
                                    continue
                                for lay in range(lay1):
                                    if emit(lay, r, c, p):
                                        yield lay, r, c, p
            else:
                for y in _steps(ty0, ty1, dy):
                    for x in _steps(tx0, tx1, dx):
                        for c in range(comp0, comp1):
                            for r in range(res0, min(res1, len(tilecs[c][1]))):
                                p = position(c, r, x, y)
                                if p is None:
                                    continue
                                for lay in range(lay1):
                                    if emit(lay, r, c, p):
                                        yield lay, r, c, p
        elif prg == CPRL:
            for c in range(comp0, comp1):
                dx, dy = grid_step([c], False)
                if not dx or not dy:
                    break
                for y in _steps(ty0, ty1, dy):
                    for x in _steps(tx0, tx1, dx):
                        for r in range(res0, min(res1, len(tilecs[c][1]))):
                            p = position(c, r, x, y)
                            if p is None:
                                continue
                            for lay in range(lay1):
                                if emit(lay, r, c, p):
                                    yield lay, r, c, p

    for prog in progs:
        try:
            yield from one(*prog)
        except _EndPoc:                      # opj_pi_next_* ends this progression
            continue


def _steps(start: int, stop: int, step: int):
    v = start
    while v < stop:
        yield v
        v += step - v % step


def _init_seg(cblk: _Cblk, index: int, cblksty: int, first: bool) -> None:
    """``opj_t2_init_seg``."""
    while len(cblk.segs) <= index:
        cblk.segs.append(_Seg(0))
    seg = cblk.segs[index] = _Seg(0)
    if cblksty & j2k_t1.TERMALL:
        seg.maxpasses = 1
    elif cblksty & j2k_t1.LAZY:
        if first:
            seg.maxpasses = 10
        else:
            seg.maxpasses = 2 if cblk.segs[index - 1].maxpasses in (1, 10) else 1
    else:
        seg.maxpasses = 109


def _numpasses(bio: _Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _read_packet(data: bytes, pos: int, end: int, hdrsrc, tcp: Tcp, tilecs, key):
    """``opj_t2_decode_packet``: one packet's header (from the tile data, or
    the PPM/PPT stream ``hdrsrc``) and its code-block data; the positions
    in the tile data after the packet's header and after its data."""
    layno, resno, compno, precno = key
    res = tilecs[compno][1][resno]
    tccp = tcp.tccps[compno]
    if layno == 0:
        for band in res.bands:
            if band.empty():
                continue
            if precno >= len(band.precincts):
                raise ValueError("invalid precinct")
            prc = band.precincts[precno]
            if prc["cw"] * prc["ch"]:            # the tag trees, new (opj_tgt_reset)
                prc["incl"] = _TagTree(prc["cw"], prc["ch"])
                prc["imsb"] = _TagTree(prc["cw"], prc["ch"])
            for cblk in prc["cblks"]:
                cblk.numsegs = 0
                cblk.segs = []
                cblk.chunks = bytearray()
    if tcp.csty & 2 and end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
        pos += 6                             # SOP (a missing one only warns in OpenJPEG)
    if hdrsrc is None:
        hbuf, hpos, hend = data, pos, end
    else:
        hbuf, hpos, hend = hdrsrc["data"], hdrsrc["pos"], len(hdrsrc["data"])
    bio = _Bio(hbuf, hpos, hend)
    present = bio.bit()
    included = []
    if present:
        for band in res.bands:
            if band.empty():
                continue
            prc = band.precincts[precno]
            if prc["incl"] is None and prc["cw"] * prc["ch"]:
                prc["incl"] = _TagTree(prc["cw"], prc["ch"])
                prc["imsb"] = _TagTree(prc["cw"], prc["ch"])
            for cblkno, cblk in enumerate(prc["cblks"]):
                if not cblk.numsegs:
                    inc = prc["incl"].decode(bio, cblkno, layno + 1)
                else:
                    inc = bio.bit()
                if not inc:
                    cblk.numnewpasses = 0
                    continue
                if not cblk.numsegs:
                    i = 0
                    while not prc["imsb"].decode(bio, cblkno, i):
                        i += 1
                        if i > 0x7FFFFFFE:
                            raise ValueError("a zero bit-plane count out of range")
                    cblk.numbps = band.numbps + 1 - i
                    cblk.numlenbits = 3
                cblk.numnewpasses = _numpasses(bio)
                increment = 0
                while bio.bit():
                    increment += 1
                cblk.numlenbits += increment
                segno = 0
                if not cblk.numsegs:
                    _init_seg(cblk, 0, tccp.cblksty, True)
                else:
                    segno = cblk.numsegs - 1
                    if cblk.segs[segno].numpasses == cblk.segs[segno].maxpasses:
                        segno += 1
                        _init_seg(cblk, segno, tccp.cblksty, False)
                n = cblk.numnewpasses
                while True:
                    seg = cblk.segs[segno]
                    seg.numnewpasses = min(seg.maxpasses - seg.numpasses, n)
                    bits = cblk.numlenbits + seg.numnewpasses.bit_length() - 1
                    if bits > 32:
                        raise ValueError(f"invalid bit number {bits} in a packet header")
                    seg.newlen = bio.read(bits)
                    n -= seg.numnewpasses
                    if n <= 0:
                        break
                    segno += 1
                    _init_seg(cblk, segno, tccp.cblksty, False)
                included.append(cblk)
        bio.inalign()
    else:
        bio.inalign()
    hpos = bio.bp
    if tcp.csty & 4:                                          # EPH
        if hend - hpos < 2 or hbuf[hpos] != 0xFF or hbuf[hpos + 1] != 0x92:
            raise ValueError("expected EPH marker")
        hpos += 2
    if hdrsrc is None:
        pos = hpos
    else:
        hdrsrc["pos"] = hpos
    header_end = pos
    for cblk in included:                                     # opj_t2_read_packet_data
        if not cblk.numsegs:
            segno = 0
            cblk.numsegs = 1
        else:
            segno = cblk.numsegs - 1
            if cblk.segs[segno].numpasses == cblk.segs[segno].maxpasses:
                segno += 1
                cblk.numsegs += 1
        while True:
            seg = cblk.segs[segno]
            if pos + seg.newlen > end:
                raise ValueError(f"read: segment too long ({seg.newlen}) with max "
                                 f"({end - pos}) for a code-block")
            cblk.chunks += data[pos:pos + seg.newlen]
            pos += seg.newlen
            seg.len += seg.newlen
            seg.numpasses += seg.numnewpasses
            cblk.numnewpasses -= seg.numnewpasses
            if cblk.numnewpasses <= 0:
                break
            segno += 1
            cblk.numsegs += 1
    return header_end, pos


def _t1_python(cblk: _Cblk, band: _Band, tccp: Tccp) -> np.ndarray:
    segments, at = [], 0
    for seg in cblk.segs[:cblk.numsegs]:
        segments.append((bytes(cblk.chunks[at:at + seg.len]), seg.numpasses))
        at += seg.len
    return j2k_t1.decode_cblk(segments, cblk.x1 - cblk.x0, cblk.y1 - cblk.y0, band.bandno,
                              cblk.numbps, tccp.roishift, tccp.cblksty)


def _decode_tile(hdr: Header, tcp: Tcp, index: int, data: bytes, ppm_src, native: bool,
                 resno_decoded: list) -> Tile:
    """``opj_tcd_decode_tile`` on one tile's data. ``resno_decoded`` is
    OpenJPEG's per image component (kept from tile to tile): the highest
    resolution a decoded packet held. A component is reconstructed, and
    given out, at that resolution only (a POC that leaves the higher
    resolutions out gives a smaller component, as in OpenJPEG)."""
    p, q = index % hdr.tiles_across, index // hdr.tiles_across
    tx0 = max(hdr.tx0 + p * hdr.tdx, hdr.x0)
    ty0 = max(hdr.ty0 + q * hdr.tdy, hdr.y0)
    tx1 = min(hdr.tx0 + (p + 1) * hdr.tdx, hdr.x1)
    ty1 = min(hdr.ty0 + (q + 1) * hdr.tdy, hdr.y1)
    for tccp in tcp.tccps:
        if tccp.cblksty & j2k_t1.HT:
            raise FormatNotRead("", "HTJ2K (JPEG 2000 Part 15)")
    tilecs = [_init_tilec(c, t, tx0, ty0, tx1, ty1) for c, t in zip(hdr.comps, tcp.tccps)]
    hdrsrc = ppm_src if ppm_src is not None else (
        dict(data=b"".join(tcp.ppt_parts[z] for z in sorted(tcp.ppt_parts)), pos=0)
        if tcp.ppt_parts else None)
    keys = list(_packets(hdr, tcp, tilecs, tx0, ty0, tx1, ty1))
    for key in keys:
        resno_decoded[key[2]] = max(resno_decoded[key[2]], key[1])
    if native:
        planes = _tile_native(tcp, tilecs, data, hdrsrc, keys, resno_decoded)
    else:
        pos = 0
        for key in keys:
            pos = _read_packet(data, pos, len(data), hdrsrc, tcp, tilecs, key)[1]
        planes = []
        for compno, ((cx0, cy0, cx1, cy1), resolutions) in enumerate(tilecs):
            kept = resolutions[:resno_decoded[compno] + 1]
            plane = _reconstruct_comp(tcp.tccps[compno], cx1 - cx0, cy1 - cy0, kept)
            planes.append(plane)
    for compno, (_, resolutions) in enumerate(tilecs):
        last = resolutions[resno_decoded[compno]]
        planes[compno] = np.ascontiguousarray(
            planes[compno][:last.y1 - last.y0, :last.x1 - last.x0])
    _mct_and_shift(tcp, hdr, tilecs, planes, native, resno_decoded)
    return Tile(index, tx0, ty0, tx1, ty1, planes)


def _cblk_jobs(resolutions):
    for resno, res in enumerate(resolutions):
        for band in res.bands:
            if band.empty():
                continue
            for prc in band.precincts:
                for cblk in prc["cblks"]:
                    if cblk.x1 <= cblk.x0 or cblk.y1 <= cblk.y0 or not cblk.numsegs:
                        continue
                    x, y = cblk.x0 - band.x0, cblk.y0 - band.y0
                    if band.bandno & 1:
                        prev = resolutions[resno - 1]
                        x += prev.x1 - prev.x0
                    if band.bandno & 2:
                        prev = resolutions[resno - 1]
                        y += prev.y1 - prev.y0
                    yield band, cblk, x, y


def _reconstruct_comp(tccp: Tccp, w: int, h: int, resolutions):
    """The plain path: each code-block through ``utils/j2k_t1.py``,
    dequantised and placed, then ``utils/j2k_dwt.idwt2d``."""
    reversible = tccp.qmfbid == 1
    buf = np.zeros((h, w), np.int32 if reversible else np.float32)
    for band, cblk, x, y in _cblk_jobs(resolutions):
        samples = _t1_python(cblk, band, tccp)
        if reversible:
            vals = np.trunc(samples / 2).astype(np.int32)
        else:
            vals = samples.astype(np.float32) * (np.float32(0.5) * np.float32(band.stepsize))
        buf[y:y + samples.shape[0], x:x + samples.shape[1]] = vals
    return j2k_dwt.idwt2d(buf, [(r.x0, r.y0, r.x1, r.y1) for r in resolutions], reversible)


def _tile_native(tcp: Tcp, tilecs, data: bytes, hdrsrc, keys, resno_decoded: list) -> list:
    """The native path of a tile: its packets through ``j2k_tier2`` (C++,
    what :func:`_read_packet` does packet by packet), then each component's
    code-blocks and wavelet through ``j2k_reconstruct_comp``; the planes
    before the component transform."""
    from coma_tpu_torch.native import codecs

    recs, recmap, rows = [], {}, []          # rows: comp, res, x, y, w, h, band, step bits
    for compno, (_, resolutions) in enumerate(tilecs):
        for resno, res in enumerate(resolutions):
            for band in res.bands:
                if band.empty():
                    continue
                offx = offy = 0
                if band.bandno & 1:
                    offx = resolutions[resno - 1].x1 - resolutions[resno - 1].x0
                if band.bandno & 2:
                    offy = resolutions[resno - 1].y1 - resolutions[resno - 1].y0
                bits = int(np.float32(band.stepsize).view(np.uint32))
                for precno, prc in enumerate(band.precincts):
                    recmap.setdefault((compno, resno, precno), []).append(len(recs))
                    recs.append((prc["cw"], prc["ch"], len(rows), band.numbps,
                                 tcp.tccps[compno].cblksty))
                    rows += [(compno, resno, c.x0 - band.x0 + offx, c.y0 - band.y0 + offy,
                              c.x1 - c.x0, c.y1 - c.y0, band.bandno, bits) for c in prc["cblks"]]
    packets, pk_recs = [], []
    for layno, resno, compno, precno in keys:
        ids = recmap.get((compno, resno, precno), [])
        packets.append((layno, len(pk_recs), len(ids)))
        pk_recs += ids
    state, lens, passes, cdata = codecs.j2k_tier2(data, hdrsrc, tcp.csty, np.array(packets),
                                                  np.array(pk_recs), np.array(recs), len(rows))
    rows = np.array(rows, np.int64).reshape(-1, 8)
    planes = []
    for compno, ((cx0, cy0, cx1, cy1), resolutions) in enumerate(tilecs):
        kept = resolutions[:resno_decoded[compno] + 1]
        mine = (rows[:, 0] == compno) & (rows[:, 1] < len(kept)) & (rows[:, 4] > 0) \
            & (rows[:, 5] > 0) & (state[:, 1] > 0)
        blocks = np.concatenate([rows[mine][:, 2:7], state[mine], rows[mine][:, 7:]], 1)
        tccp = tcp.tccps[compno]
        planes.append(codecs.j2k_reconstruct_comp(
            cdata, blocks, lens, passes, tccp.roishift, tccp.cblksty, cx1 - cx0, cy1 - cy0,
            [(r.x0, r.y0, r.x1, r.y1) for r in kept], tccp.qmfbid == 1))
    return planes


def _mct_and_shift(tcp: Tcp, hdr: Header, tilecs, planes, native: bool,
                   resno_decoded: list) -> None:
    """``opj_tcd_mct_decode`` then ``opj_tcd_dc_level_shift_decode``, in
    place on ``planes``."""
    if tcp.mct and len(planes) >= 3:
        full = [tilecs[c][1][-1] for c in range(3)]
        if len({tcp.tccps[c].numres for c in range(3)}) != 1 or len(
                {(r.x0, r.x1, r.y0, r.y1) for r in full}) != 1 \
                or len({resno_decoded[c] for c in range(3)}) != 1:
            raise ValueError("tiles don't all have the same dimension; skip the MCT step")
        reversible = tcp.tccps[0].qmfbid == 1
        dtype = np.int32 if reversible else np.float32
        three = [np.ascontiguousarray(planes[c], dtype) for c in range(3)]
        if native:
            from coma_tpu_torch.native import codecs

            codecs.j2k_mct(three, reversible)
        else:
            three = list((j2k_dwt.rct_inverse if reversible else j2k_dwt.ict_inverse)(*three))
        planes[:3] = three
    for c, comp in enumerate(hdr.comps):
        reversible = tcp.tccps[c].qmfbid == 1
        if native:
            from coma_tpu_torch.native import codecs

            planes[c] = codecs.j2k_level_shift(planes[c], comp.prec, comp.sgnd, reversible)
        else:
            planes[c] = j2k_dwt.level_shift(planes[c], comp.prec, comp.sgnd, reversible)


def decode_tiles(cs: bytes, native: Optional[bool] = None, ihdr_size=None):
    """A codestream -> (``Header``, [``Tile``] in OpenJPEG's decoding order).
    Raises ``ValueError`` where OpenJPEG fails; ``ihdr_size`` is a JP2's
    (width, height), which SIZ must match."""
    if native is None:
        from coma_tpu_torch.native import codecs

        native = codecs.j2k_available()
    hdr, pos = read_header(cs, ihdr_size)
    parts, order = tile_parts(cs, hdr, pos)
    ppm_src = dict(data=hdr.ppm, pos=0) if hdr.ppm is not None else None
    tiles = []
    resno_decoded = [0] * len(hdr.comps)
    for index in order:
        entry = parts[index]
        tcp = hdr.tcp.copy()
        state: dict = dict(ppm=hdr.ppm is not None)
        for marker, start, end in entry["segments"]:
            _read_marker(marker, _Reader(cs, start, end), len(hdr.comps), tcp, state)
        tiles.append(_decode_tile(hdr, tcp, index, bytes(entry["data"]), ppm_src, native,
                                  resno_decoded))
    return hdr, tiles
