"""Apple icon images (ICNS), as Pillow's ``IcnsImagePlugin`` reads them.

An ``icns`` header with the file's length, then blocks of a 4-byte type
and a length. PIL opens the largest size it knows (``IcnsFile.SIZES``,
compared as (width, height, scale) tuples) and reads that size's blocks in
its order: a PNG member (``ic07``-``ic14``, ``icp4``-``icp6``) is the
image, in the PNG's own mode; else the 24-bit ``is32``/``il32``/``ih32``
/``it32`` data (``it32`` after four zero bytes), raw where its length is
three bytes a pixel, else each channel run-length coded in turn (a byte
n < 128 is n + 1 literal bytes, n >= 128 repeats the next byte n - 125
times; a channel that overshoots is refused), gives "RGB", and a mask
(``s8mk``/``l8mk``/``h8mk``/``t8mk``) makes it "RGBA". A JPEG 2000 member
(a codestream, a JP2 file, or bytes starting ``\r\n\x87\n``, which
Pillow hands to its JPEG 2000 plugin too) is read by ``utils/jp2.py`` and
converted to "RGBA" as ``IcnsImagePlugin`` converts it.

The run-length loop has a native twin in ``native/src/image_codecs.cpp``
(``icns_rle_decode``); :func:`rle_decode` picks it, or
:func:`rle_decode_python`, its reference.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils import jp2
from coma_tpu_torch.utils.modes import Decoded, FormatNotRead, NotThisFormat, to_mode
from coma_tpu_torch.utils.png import decode_png_pil

# (width, height, scale) -> the block types PIL reads for it, in its order
SIZES = {
    (512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")], (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "rgb32t"), (b"t8mk", "mask")],
    (64, 64, 1): [(b"icp6", "png")], (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "rgb"), (b"h8mk", "mask")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")],
}
_JP2 = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")


def rle_decode_python(data: bytes, pos: int, pixels: int) -> bytes:
    """``read_32``'s run-length channels from ``data[pos:]``: three planes of
    ``pixels`` bytes (R, G, B). The reference of
    ``native/codecs.icns_rle_decode``."""
    planes = []
    for _ in range(3):
        out, left = bytearray(), pixels
        while left > 0:
            if pos >= len(data):
                break
            byte = data[pos]
            pos += 1
            if byte & 0x80:
                count = byte - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = byte + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"error reading channel [{left} left]")
        if len(out) < pixels:
            raise ValueError("not enough image data")
        planes.append(bytes(out[:pixels]))
    return b"".join(planes)


def rle_decode(data: bytes, pos: int, pixels: int, native=None) -> bytes:
    """:func:`rle_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return rle_decode_python(data, pos, pixels)
    return codecs.icns_rle_decode(data, pos, pixels)


def _jp2_rgba(member: bytes, name: str, native) -> Decoded:
    """A JPEG 2000 member, ``convert("RGBA")`` unless it is "RGBA" already."""
    try:
        img = jp2.decode_jp2(member, name, native)
    except NotThisFormat as err:              # Jpeg2KImageFile's SyntaxError
        raise ValueError(f"a JPEG 2000 member Pillow's plugin does not open ({err})") from None
    if img.mode == "RGBA":
        return img
    alpha = np.full(img.pixels.shape[:2], 255, np.uint8)
    if img.mode in ("LA", "PA"):
        alpha = img.pixels[..., 1]
    rgb = to_mode(img, "RGB")
    return Decoded(np.concatenate([rgb, alpha[..., None]], -1), "RGBA")


def blocks(data: bytes, name: str) -> dict:
    """``IcnsFile.__init__``: block type -> (start, length) of its data."""
    if len(data) < 8 or data[:4] != b"icns":
        raise NotThisFormat(f"{name}: not an ICNS file")
    found, i, end, pos = {}, 8, int.from_bytes(data[4:8], "big"), 8
    while i < end:
        if pos + 8 > len(data):
            raise NotThisFormat(f"{name}: an ICNS block header past the end of the file")
        kind, size = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "big")
        if size <= 0:
            raise NotThisFormat(f"{name}: an invalid ICNS block header")
        i += 8
        found[kind] = (i, size - 8)
        pos = i + size - 8
        i += size - 8
    return found


def decode_icns(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """An ICNS file's bytes -> what ``np.asarray(PIL.Image.open(f))`` gives,
    and its mode; a ``ValueError`` naming ``name`` where PIL refuses it."""
    found = blocks(data, name)
    sizes = [size for size, kinds in SIZES.items() if any(k in found for k, _ in kinds)]
    if not sizes:
        raise NotThisFormat(f"{name}: no 32-bit ICNS icon")
    size = max(sizes)
    side = size[0] * size[2], size[1] * size[2]
    channels = {}
    try:
        for kind, reader in SIZES[size]:
            if kind not in found:
                continue
            start, length = found[kind]
            if reader == "png":
                head = data[start:start + 12]
                if head.startswith(b"\x89PNG\r\n\x1a\n"):
                    channels["RGBA"] = decode_png_pil(data[start:], name)
                elif head.startswith(_JP2[:2]) or head == _JP2[2]:
                    channels["RGBA"] = _jp2_rgba(data[start:start + length], name, native)
                else:
                    raise ValueError("an icon member that is neither PNG nor JPEG 2000")
            elif reader == "mask":
                plane = np.frombuffer(data[start:start + side[0] * side[1]], np.uint8)
                if plane.size < side[0] * side[1]:
                    raise ValueError("not enough image data in a mask")
                channels["A"] = plane.reshape(side[1], side[0])
            else:
                if reader == "rgb32t":
                    if data[start:start + 4] != bytes(4):
                        raise ValueError("unknown it32 signature, expecting 0x00000000")
                    start, length = start + 4, length - 4
                pixels = side[0] * side[1]
                if length == 3 * pixels:
                    rgb = np.frombuffer(data[start:start + length], np.uint8)
                    if rgb.size < length:
                        raise ValueError("not enough image data")
                    rgb = rgb.reshape(side[1], side[0], 3)
                else:
                    planes = np.frombuffer(rle_decode(data, start, pixels, native), np.uint8)
                    rgb = planes.reshape(3, side[1], side[0]).transpose(1, 2, 0)
                channels["RGB"] = rgb
    except FormatNotRead:
        raise
    except ValueError as err:
        raise ValueError(f"{name}: ICNS: {err}") from None
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError(f"{name}: ICNS: a mask without its image (PIL fails on it)")
    rgb = np.ascontiguousarray(channels["RGB"])
    if "A" not in channels:
        return Decoded(rgb, "RGB")
    return Decoded(np.concatenate([rgb, channels["A"][..., None]], -1), "RGBA")
