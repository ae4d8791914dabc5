"""GIF files, as Pillow's ``GifImagePlugin`` reads them.

:func:`decode_gif` gives the first frame as ``np.asarray(PIL.Image.open(f))``
does: "P" (palette indices, with the frame's palette) or "L" where there is
no palette or it is the identity gray ramp, on the logical screen (filled
with the transparent index, or 0, outside the frame). :func:`decode_gif_frames`
gives every frame as ``im.seek(k); im.convert("RGB")`` does, composed as
PIL composes them (a transparent index keeps the pixel below, disposal 2
fills the frame's area with its background or transparent colour, 3
restores it), with each frame's duration in ms and the loop count. Frames
may be interlaced and carry local palettes.

The LZW decoding has a native twin in ``native/src/image_codecs.cpp``;
:func:`lzw_decode` picks it, or :func:`lzw_decode_python`, its reference.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from coma_tpu_torch.utils.modes import Decoded

MAX_CODE = 4096            # GIF's 12-bit LZW table


def lzw_decode_python(data: bytes, min_code_size: int, cap: int, end_from: int = 0) -> bytes:
    """GIF's variable-width LZW: codes least-significant bit first from
    ``min_code_size + 1`` bits, growing when the table reaches 2^width exactly (12
    bits at most, no entries added past 4096), a clear code resetting, the
    end of the data stopping, and an end code ending in byte ``end_from`` or
    later (one before it is passed over). At most ``cap`` bytes."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    padded = data + bytes(3)
    total = len(data) * 8
    table: list = [bytes([i & 0xFF]) for i in range(clear)] + [b"", b""]   # UINT8 past 8 bits
    width, pos, prev = min_code_size + 1, 0, None
    out = bytearray()
    while pos + width <= total and len(out) < cap:
        i = pos >> 3
        code = ((padded[i] | padded[i + 1] << 8 | padded[i + 2] << 16) >> (pos & 7)) \
            & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = table[:end + 1]
            width, prev = min_code_size + 1, None
            continue
        if code == end:
            if (pos - 1) >> 3 < end_from:
                continue
            break
        if prev is None:
            if code >= clear:
                raise ValueError("an LZW code that is not in the table (corrupt data)")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < MAX_CODE:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < MAX_CODE:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("an LZW code that is not in the table (corrupt data)")
        if len(table) == 1 << width and width < 12:     # GifDecode.c: next == codemask
            width += 1
        out += entry
        prev = entry
    return bytes(out[:cap])


def lzw_decode(data: bytes, min_code_size: int, cap: int, native=None,
               end_from: int = 0) -> bytes:
    """:func:`lzw_decode_python`, or its C++ twin (``native`` None: where it
    builds)."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.available()
    if not native:
        return lzw_decode_python(data, min_code_size, cap, end_from)
    return codecs.lzw_decode(data, min_code_size, False, cap, end_from)


CHUNK = 65536              # Pillow's ImageFile.load reads a file in blocks of this


def _pillow_stream(data: bytes, offset: int, to_end: bool) -> tuple:
    """The LZW bytes Pillow's GIF decoder (``libImaging/GifDecode.c``) takes
    from ``data[offset:]``: every data sub-block it has whole, read as a
    length byte and that many bytes with no regard for terminators (past the
    frame's own ones only where ``to_end``); and the first of those bytes in
    Pillow's last read of the file, from which on an end code stops it
    (before that one, it reads on)."""
    n, pos, out = len(data), offset, bytearray()
    last_read = offset + max(-(-(n - offset) // CHUNK) - 1, 0) * CHUNK
    end_from = None
    while pos < n and (to_end or data[pos]):
        c = data[pos]
        if pos + 1 + c > n:
            break
        if end_from is None and pos + 1 + c > last_read:
            end_from = len(out)
        out += data[pos + 1:pos + 1 + c]
        pos += 1 + c
    return bytes(out), len(out) if end_from is None else end_from


def _frame_indices(data: bytes, offset: int, min_code_size: int, w: int, h: int, name: str,
                   native) -> bytes:
    """A frame's w x h palette indices as Pillow's decoder gives them; a
    ``ValueError`` where it wants bytes past the end of the file (Pillow:
    "image file is truncated") or meets a code not in the table."""
    for to_end in (False, True):
        stream, end_from = _pillow_stream(data, offset, to_end)
        try:
            raw = lzw_decode(stream, min_code_size, w * h, native, end_from)
        except ValueError as err:
            raise ValueError(f"{name}: {err}") from None
        if len(raw) >= w * h:
            return raw
    raise ValueError(f"{name}: the GIF image data ends before its {w} x {h} pixels "
                     "(truncated; Pillow refuses it)")


class _Frame(NamedTuple):
    box: Tuple[int, int, int, int]           # x0, y0, x1, y1
    indices: np.ndarray                      # (h, w) uint8
    palette: Optional[np.ndarray]            # (N, 3), or None: gray
    transparency: Optional[int]
    disposal: int
    duration: Optional[int]


def _palette_needed(p: np.ndarray) -> bool:
    """PIL's ``_is_palette_needed``: anything but the identity gray ramp."""
    return not (p == np.arange(len(p))[:, None]).all()


def _deinterlace(idx: np.ndarray) -> np.ndarray:
    h = idx.shape[0]
    order = [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(start, h, step)]
    out = np.empty_like(idx)
    out[order] = idx
    return out


def _parse(data: bytes, name: str, native, first_only: bool):
    """(screen size, background index, loop, frames)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    le16 = lambda at: data[at] | data[at + 1] << 8
    W, H, flags = le16(6), le16(8), data[10]
    pos, global_palette, background = 13, None, None
    if flags & 0x80:
        background = data[11]
        n = 3 << ((flags & 7) + 1)
        p = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
        pos += n
        if _palette_needed(p):
            global_palette = p

    def sub_blocks(at: int):
        chunks = []
        while at < len(data) and data[at]:
            chunks.append(data[at + 1:at + 1 + data[at]])
            at += 1 + data[at]
        return b"".join(chunks), at + 1

    frames: List[_Frame] = []
    loop, transparency, disposal, duration = None, None, 0, None
    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            if pos + 1 >= len(data):
                raise ValueError(f"{name}: the GIF file ends inside an extension")
            label = data[pos + 1]
            first = data[pos + 3:pos + 3 + data[pos + 2]] if pos + 2 < len(data) else b""
            body, pos = sub_blocks(pos + 2)
            if label == 0xF9 and first:
                # PIL reads the duration (and, flagged, the transparency) unchecked
                if len(first) < 3 or (first[0] & 1 and len(first) < 4):
                    raise ValueError(f"{name}: a GIF graphic control extension cut short "
                                     "(PIL refuses it)")
                transparency = first[3] if first[0] & 1 else None
                duration = (first[1] | first[2] << 8) * 10
                disposal = (first[0] >> 2) & 7 or disposal
            elif label == 0xFF and not frames and first == b"NETSCAPE2.0":
                if len(body) >= 14 and body[11] == 1:
                    loop = body[12] | body[13] << 8
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise ValueError(f"{name}: a GIF image descriptor runs past the end of the file")
            x0, y0, w, h, fl = le16(pos + 1), le16(pos + 3), le16(pos + 5), le16(pos + 7), \
                data[pos + 9]
            pos += 10
            palette = global_palette
            if fl & 0x80:
                n = 3 << ((fl & 7) + 1)
                p = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
                pos += n
                palette = p if _palette_needed(p) else None
            if pos >= len(data):
                raise ValueError(f"{name}: the GIF file ends before a frame's LZW code size")
            min_code_size = data[pos]
            if min_code_size > 12:                   # GifDecode.c's only check
                raise ValueError(f"{name}: a GIF LZW code size of {min_code_size}")
            raw = _frame_indices(data, pos + 1, min_code_size, w, h, name, native)
            body, pos = sub_blocks(pos + 1)
            idx = np.frombuffer(raw, np.uint8)[:w * h].reshape(h, w).copy()
            if fl & 0x40:
                idx = _deinterlace(idx)
            frames.append(_Frame((x0, y0, x0 + w, y0 + h), idx, palette, transparency,
                                 disposal, duration))
            transparency, duration = None, None
            if first_only:
                break
        else:
            pos += 1                            # PIL passes over unknown bytes
    if not frames:
        raise ValueError(f"{name}: no image in the GIF file")
    return (W, H), background, loop, frames


def _first_canvas(screen: tuple, f: _Frame) -> np.ndarray:
    """The first frame on the logical screen (grown to hold it), filled
    with its transparent index, or 0, outside it."""
    x0, y0, x1, y1 = f.box
    canvas = np.full((max(screen[1], y1), max(screen[0], x1)), f.transparency or 0, np.uint8)
    canvas[y0:y1, x0:x1] = f.indices
    return canvas


def decode_gif(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A GIF file's first frame -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where PIL refuses."""
    screen, _, _, frames = _parse(data, name, native, first_only=True)
    canvas = _first_canvas(screen, frames[0])
    if frames[0].palette is None:
        return Decoded(canvas, "L")
    return Decoded(canvas, "P", frames[0].palette)


def _rgb(palette: Optional[np.ndarray], idx) -> np.ndarray:
    """RGB of palette indices: entries past the palette are black; no
    palette is the gray ramp."""
    if palette is None:
        return np.repeat(np.asarray(idx, np.uint8)[..., None], 3, axis=-1)
    full = np.zeros((256, 3), np.uint8)
    full[:min(256, len(palette))] = palette[:256]
    return full[idx]


def decode_gif_frames(data: bytes, name: str = "<bytes>", native=None):
    """Every frame as PIL shows it in RGB -> (frames (S, H, W, 3) uint8,
    durations in ms (None where a frame has none), loop count or None)."""
    screen, background, loop, frames = _parse(data, name, native, first_only=False)
    canvas = np.ascontiguousarray(_rgb(frames[0].palette, _first_canvas(screen, frames[0])))
    H, W = canvas.shape[:2]
    out, durations, restore = [canvas.copy()], [frames[0].duration], None
    for k in range(1, len(frames)):
        prev, f = frames[k - 1], frames[k]
        x0, y0, x1, y1 = prev.box
        if prev.disposal == 2:              # the frame's area to its transparent colour,
            color = prev.transparency       # else to the background colour
            color = (background or 0) if color is None else color
            canvas[y0:y1, x0:x1] = _rgb(prev.palette, color)
        elif prev.disposal == 3:            # back to what was under the frame
            if restore is not None:
                canvas[y0:y1, x0:x1] = restore
            elif prev.transparency is not None:
                canvas[y0:y1, x0:x1] = _rgb(prev.palette, prev.transparency)
        x0, y0, x1, y1 = f.box
        if x1 > W or y1 > H:
            raise ValueError(f"{name}: GIF frame {k} reaches past the logical screen")
        restore = canvas[y0:y1, x0:x1].copy()
        rgb = _rgb(f.palette, f.indices)
        if f.transparency is None:
            canvas[y0:y1, x0:x1] = rgb
        else:
            keep = f.indices == f.transparency
            canvas[y0:y1, x0:x1] = np.where(keep[..., None], canvas[y0:y1, x0:x1], rgb)
        out.append(canvas.copy())
        durations.append(f.duration)
    return np.stack(out), durations, loop
