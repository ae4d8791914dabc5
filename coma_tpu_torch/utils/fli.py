"""Autodesk FLI/FLC animations, first frame, as Pillow's ``FliImagePlugin``
reads them.

A 128-byte little-endian header (magic 0xAF11 or 0xAF12 at byte 4, flags
0 or 3, the reserved bytes zero, at least one frame); mode "P". The
palette is gray unless the first frame chunk after the header (or after a
0xF100 prefix chunk, which PIL skips only here) holds a COLOR256 (4) or
COLOR (11, values shifted left by 2) subchunk before a subchunk of size 0:
packets of a skip, a count (0 meaning 256) and that many RGB triples.

The first frame is decoded from byte 128 (a prefix chunk there is refused,
as PIL refuses it) by libImaging's ``FliDecode.c``, :func:`frame_decode_python`,
into a zeroed image: BRUN (15) run-length rows, LC (12) byte deltas, SS2
(7) word deltas, BLACK (13) and COPY (16); colour and stamp subchunks are
skipped and any other is refused. PIL feeds the decoder the file in reads of
the frame's size, as :func:`decode_fli` does, so a frame cut short or a
subchunk that runs past its data is refused as PIL refuses it.

The frame decoder has a native twin in ``native/src/image_codecs.cpp``
(``fli_decode``); ``decode_fli(..., native=)`` picks it where it builds.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

# libImaging's codec statuses and PIL's messages for them
OVERRUN, BROKEN, UNKNOWN = -1, -2, -3
_ERRORS = {OVERRUN: "buffer overrun", BROKEN: "broken data stream",
           UNKNOWN: "unrecognized data stream contents"}


def _i16(data, at: int) -> int:
    return data[at] | data[at + 1] << 8


def _i32(data, at: int) -> int:
    v = data[at] | data[at + 1] << 8 | data[at + 2] << 16 | data[at + 3] << 24
    return v - (1 << 32) if v >= 1 << 31 else v      # C's int


def frame_decode_python(buf: bytes, width: int, height: int, out: np.ndarray) -> tuple:
    """``ImagingFliDecode`` on ``buf`` into ``out`` ((height, width) uint8):
    (status, error) as libImaging returns them: status -1 at the frame's end
    (error 0, or a negative code), else the bytes consumed before it asks
    for more. The reference of ``native/codecs.fli_decode``."""
    n = len(buf)
    if n < 4:
        return 0, 0
    if n + n % 2 < _i32(buf, 0):
        return 0, 0
    if n < 8:
        return -1, OVERRUN
    if _i16(buf, 4) != 0xF1FA:
        return -1, UNKNOWN
    chunks = _i16(buf, 6)
    ptr, left = 16, n - 16
    img = out.reshape(-1)
    for _ in range(chunks):
        if left < 10:
            return -1, OVERRUN
        end = ptr + left                            # ERR_IF_DATA_OOB's bound
        data = ptr + 6
        kind = _i16(buf, ptr + 4)
        if kind == 7:                               # SS2, word delta
            lines = _i16(buf, data)
            data += 2
            l = y = 0
            while l < lines and y < height:
                row = y * width
                if data + 2 > end:
                    return -1, OVERRUN
                packets = _i16(buf, data)
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets        # skip lines
                        if y >= height:
                            return -1, OVERRUN
                        row = y * width
                    else:                           # the last byte of an odd row
                        img[row + width - 1] = packets & 0xFF
                    if data + 2 > end:
                        return -1, OVERRUN
                    packets = _i16(buf, data)
                    data += 2
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return -1, OVERRUN
                    x += buf[data]
                    if buf[data + 1] >= 128:
                        if data + 4 > end:
                            return -1, OVERRUN
                        i = 256 - buf[data + 1]
                        if x + 2 * i > width:
                            break
                        img[row + x:row + x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, data + 2), i)
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * buf[data + 1]
                        if x + i > width:
                            break
                        if data + 2 + i > end:
                            return -1, OVERRUN
                        img[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l += 1
                y += 1
            if l < lines:
                return -1, OVERRUN
        elif kind == 12:                            # LC, byte delta
            y = _i16(buf, data)
            ymax = y + _i16(buf, data + 2)
            data += 4
            while y < ymax and y < height:
                row = y * width
                if data + 1 > end:
                    return -1, OVERRUN
                packets = buf[data]
                data += 1
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return -1, OVERRUN
                    x += buf[data]
                    if buf[data + 1] & 0x80:
                        i = 256 - buf[data + 1]
                        if x + i > width:
                            break
                        if data + 3 > end:
                            return -1, OVERRUN
                        img[row + x:row + x + i] = buf[data + 2]
                        data += 3
                    else:
                        i = buf[data + 1]
                        if x + i > width:
                            break
                        if data + 2 + i > end:
                            return -1, OVERRUN
                        img[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                        data += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return -1, OVERRUN
        elif kind == 13:                            # BLACK
            img[:] = 0
        elif kind == 15:                            # BRUN, byte run length
            for y in range(height):
                row = y * width
                data += 1                           # the packet count, ignored
                x = 0
                while x < width:
                    if data + 2 > end:
                        return -1, OVERRUN
                    if buf[data] & 0x80:
                        i = 256 - buf[data]
                        if x + i > width:
                            break
                        if data + i + 1 > end:
                            return -1, OVERRUN
                        img[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, data + 1)
                        data += i + 1
                    else:
                        i = buf[data]
                        if x + i > width:
                            break
                        img[row + x:row + x + i] = buf[data + 1]
                        data += 2
                    x += i
                if x != width:
                    return -1, OVERRUN
        elif kind == 16:                            # COPY
            if data + width * height > end:
                return ptr, 0                       # "bytes consumed": PIL reads on
            img[:] = np.frombuffer(buf, np.uint8, width * height, data)
        elif kind not in (4, 11, 18):               # colour and stamp: skipped
            return -1, UNKNOWN
        advance = _i32(buf, ptr)
        if advance == 0:
            return -1, BROKEN
        if advance < 0 or advance > left:
            return -1, OVERRUN
        ptr += advance
        left -= advance
    return -1, 0


def frame_decode(buf: bytes, width: int, height: int, out: np.ndarray, native=None) -> tuple:
    """:func:`frame_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return frame_decode_python(buf, width, height, out)
    return codecs.fli_decode(buf, width, height, out)


def _palette(data: bytes, pos: int, shift: int, palette: list, name: str) -> None:
    """``FliImageFile._palette`` from ``data[pos:]``."""
    if len(data) < pos + 2:
        raise NotThisFormat(f"{name}: an FLI colour chunk cut short")
    packets = _i16(data, pos)
    pos += 2
    i = 0
    for _ in range(packets):
        s = data[pos:pos + 2]
        pos += 2
        if len(s) < 2:
            raise NotThisFormat(f"{name}: an FLI colour packet cut short")
        i += s[0]
        count = s[1] or 256
        s = data[pos:pos + 3 * count]
        pos += len(s)
        if len(s) % 3 or i + len(s) // 3 > 256:
            raise NotThisFormat(f"{name}: an FLI colour packet PIL cannot read")
        for k in range(0, len(s), 3):
            palette[i] = ((s[k] << shift) & 255, (s[k + 1] << shift) & 255,
                          (s[k + 2] << shift) & 255)
            i += 1


def _header(data: bytes, name: str):
    """``FliImageFile._open``: (width, height, palette (256, 3))."""
    if not (len(data) >= 128 and _i16(data, 4) in (0xAF11, 0xAF12) and _i16(data, 14) in (0, 3)
            and data[20:22] == bytes(2) and data[42:80] == bytes(38)
            and data[88:128] == bytes(40)):
        raise NotThisFormat(f"{name}: not an FLI/FLC file")
    frames, width, height = _i16(data, 6), _i16(data, 8), _i16(data, 10)
    palette = [(a, a, a) for a in range(256)]
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if len(s) < 6:
        raise NotThisFormat(f"{name}: an FLI file without its first chunk")
    if _i16(s, 4) == 0xF100:                        # a prefix chunk: PIL looks past it
        pos = 128 + _i32(data, 128) % (1 << 32)
        s = data[pos:pos + 16]
        pos += len(s)
        if len(s) < 6:
            raise NotThisFormat(f"{name}: an FLI file without a chunk after its prefix")
    if _i16(s, 4) == 0xF1FA:
        if len(s) < 8:
            raise NotThisFormat(f"{name}: an FLI frame chunk cut short")
        size = None
        for _ in range(_i16(s, 6)):
            if size is not None:
                pos += size - 6
            s = data[pos:pos + 6]
            pos += len(s)
            if len(s) < 6:
                raise NotThisFormat(f"{name}: an FLI subchunk cut short")
            kind = _i16(s, 4)
            if kind in (4, 11):
                _palette(data, pos, 2 if kind == 11 else 0, palette, name)
                break
            size = _i32(s, 0) % (1 << 32)
            if not size:
                break
    if frames == 0:                                 # PIL's seek(0) is out of its sequence
        raise NotThisFormat(f"{name}: an FLI file of no frames")
    if len(data) < 132:
        raise NotThisFormat(f"{name}: an FLI file without its first frame")
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an FLI animation of {width} x {height} pixels")
    return width, height, np.asarray(palette, np.uint8)


def decode_fli(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """An FLI/FLC file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives (its first frame, mode "P"); ``NotThisFormat`` where PIL's plugin
    does not take it, a ``ValueError`` naming ``name`` where PIL refuses it."""
    width, height, palette = _header(data, name)
    framesize = _i32(data, 128) % (1 << 32)        # PIL's read size, unsigned
    out = np.zeros((height, width), np.uint8)
    pos, buf = 128, b""
    while True:                                     # ImageFile.load's loop
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise ValueError(f"{name}: FLI: image file is truncated ({len(buf)} bytes not "
                             "processed)")
        buf += s
        status, error = frame_decode(buf, width, height, out, native)
        if status < 0:
            break
        buf = buf[status:]
    if error < 0:
        raise ValueError(f"{name}: FLI: {_ERRORS[error]} when reading image file")
    return Decoded(out, "P", palette)
