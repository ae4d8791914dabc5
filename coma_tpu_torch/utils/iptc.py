"""IPTC/NAA files, as Pillow's ``IptcImagePlugin`` reads them.

Fields of ``1C``, a record and a dataset number (records 1-9 and 240) and
a length (two bytes, or past 0x80 a count of length bytes, at most four;
over 132 is refused), read until a first byte that is not ``1C`` (left
to the next format), the end of the file, or dataset (8, 10), the image
data. (3, 60) gives the layers and the component flag: one layer without
it is "L", three or four with it "RGB" or "CMYK"; (3, 20) and (3, 30) the
width and height; (3, 120) the compression, 1 raw or 5 JPEG (another is
refused, as PIL refuses it).

The (8, 10) fields that follow one another are the image: raw data behind
PIL's ``P5`` header, so read as a PGM, or a file of its own (a JPEG) read
through ``utils/image_io.decode_image``, as PIL opens it with
``Image.open``. An "L" image is that file's; an "RGB" or "CMYK" one puts
it, which must be one band of "L", in the band (3, 65) names (the first
without it), the other bands zero, as ``Image.merge`` does. A header PIL's
``_open`` gives up (an exception it passes on) is left to the next format.
"""
from __future__ import annotations

import io
import struct

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

COMPRESSION = {1: "raw", 5: "jpeg"}
# what ImageFile turns into SyntaxError, so Image.open tries the next format
_NEXT = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)


class _Refused(Exception):
    """What PIL raises past ``Image.open`` (OSError and the like)."""


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp: io.BytesIO):
    """``IptcImageFile.field``: (tag or None, size)."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise _Refused("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _open(fp: io.BytesIO):
    """``IptcImageFile._open``: (mode, size, compression, band, data offset)."""
    info: dict = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except KeyError:
        raise _Refused("Unknown IPTC image compression") from None
    return mode, size, compression, band, offset if tag == (8, 10) else None


def decode_iptc(data: bytes, name: str = "<bytes>") -> Decoded:
    """An IPTC/NAA file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; ``NotThisFormat`` where PIL's plugin does not take
    it, a ``ValueError`` naming ``name`` where PIL refuses it."""
    from coma_tpu_torch.utils.image_io import decode_image

    fp = io.BytesIO(data)
    try:
        mode, (width, height), compression, band, offset = _open(fp)
    except _NEXT as err:
        raise NotThisFormat(f"{name}: not an IPTC/NAA file ({err})") from None
    except _Refused as err:
        raise ValueError(f"{name}: IPTC: {err}") from None
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an IPTC/NAA file PIL does not identify")
    if offset is None:
        raise ValueError(f"{name}: IPTC: cannot load this image (no image data field)")
    fp.seek(offset)
    o = io.BytesIO()
    if compression == "raw":
        o.write(b"P5\n%d %d\n255\n" % (width, height))
    try:
        while True:
            tag, size = _field(fp)
            if tag != (8, 10):
                break
            while size > 0:
                s = fp.read(min(size, 8192))
                if not s:
                    break
                o.write(s)
                size -= len(s)
    except (_Refused, *_NEXT) as err:
        raise ValueError(f"{name}: IPTC: {err}") from None
    inner = decode_image(o.getvalue(), f"{name} (its IPTC image data)")
    if band is None:
        if inner.mode != "L" or inner.pixels.shape != (height, width):
            raise ValueError(f"{name}: IPTC: image data of mode {inner.mode} and shape "
                             f"{inner.pixels.shape} in an L image of {width} x {height} (not "
                             "read)")
        return Decoded(inner.pixels, "L")
    bands = 3 if mode == "RGB" else 4
    if not -bands <= band < bands:
        raise ValueError(f"{name}: IPTC: band {band + 1} of a {mode} image (PIL fails on it)")
    if inner.mode != "L":
        raise ValueError(f"{name}: IPTC: image data of mode {inner.mode} merged as a band of "
                         f"{mode} (PIL refuses it)")
    if inner.pixels.shape != (height, width):
        raise ValueError(f"{name}: IPTC: image data of {inner.pixels.shape[::-1]} in an image of "
                         f"{width} x {height} (not read)")
    out = np.zeros((height, width, bands), np.uint8)
    out[..., band] = inner.pixels
    return Decoded(out, mode)
