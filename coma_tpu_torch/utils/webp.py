"""WebP files, as Pillow 12.1.0 reads them through libwebp's
``WebPAnimDecoder`` (frame 0).

- The RIFF container: a simple lossy (``VP8 ``) or lossless (``VP8L``)
  file, or ``VP8X`` with an ``ALPH`` chunk before a lossy image; ICCP, EXIF,
  XMP and unknown chunks are skipped (Pillow's ``convert`` applies no ICC).
  An animation (``ANIM``/``ANMF``) gives its first frame placed at its
  offset on a transparent canvas of the canvas size, as the animation
  decoder draws frame 0.
- The mode is Pillow's: "RGBA" when the file says it has alpha (the VP8X
  flag, a VP8L header's alpha bit, an ``ALPH`` chunk), else "RGB" (decoded as
  RGBX). Alpha is not premultiplied, so ``convert("RGB")`` drops it.
- Lossy pictures (``utils/vp8.py``) are converted as libwebp's default
  output: the "fancy" upsampler of 4:2:0 chroma (two halvings through the
  diagonals, the first and last rows mirrored) and the 14-bit
  ``VP8YUVToR/G/B`` with ``VP8Clip8``. Lossless ones: ``utils/vp8l.py``.
- ``ALPH``: raw or lossless-coded (the green channel) levels, then the
  horizontal, vertical or gradient unfilter with libwebp's first-row and
  first-column rules; no dithering, the animation decoder's default.

Every file decodes in ``native/src/webp_decode.cpp`` where ``g++`` builds it
(``native/codecs.webp_decode``); the plain Python/numpy decoders here and in
``utils/vp8.py``/``utils/vp8l.py`` are its reference. A file libwebp's
demuxer refuses is refused with a ``ValueError`` naming the file.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils import vp8, vp8l
from coma_tpu_torch.utils.modes import Decoded


def _le(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _chunks(data: bytes, start: int, end: int) -> list:
    """(fourcc, payload offset, payload size) of each chunk in
    ``data[start:end]``; a chunk past the end is refused."""
    out, pos = [], start
    while pos + 8 <= end:
        size = _le(data, pos + 4, 4)
        if pos + 8 + size > end:
            raise ValueError(f"chunk {data[pos:pos + 4]!r} runs past the end of the file")
        out.append((data[pos:pos + 4], pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def _parse(data: bytes) -> tuple:
    """(canvas width, canvas height, has_alpha, frame): ``frame`` is (x, y,
    image chunk, ALPH chunk or None) of the first (or only) image."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a RIFF WebP file")
    riff = _le(data, 4, 4)
    if riff < 12 or 8 + riff > len(data):
        raise ValueError("the RIFF size runs past the end of the file")
    chunks = _chunks(data, 12, 8 + riff)
    if not chunks:
        raise ValueError("no chunks")
    kind, at, size = chunks[0]
    if kind == b"VP8 ":
        w, h = vp8.frame_info(data[at:at + size])
        return w, h, False, (0, 0, (kind, at, size), None)
    if kind == b"VP8L":
        w, h, alpha = vp8l.header(data[at:at + size])
        return w, h, alpha, (0, 0, (kind, at, size), None)
    if kind != b"VP8X" or size < 10:
        raise ValueError(f"a first chunk {kind!r} that is not VP8, VP8L or VP8X")
    flags = data[at]
    cw, ch = _le(data, at + 4, 3) + 1, _le(data, at + 7, 3) + 1
    has_alpha = bool(flags & 0x10)
    if flags & 0x02:                                # an animation: its first frame
        frames = [c for c in chunks[1:] if c[0] == b"ANMF"]
        if not any(c[0] == b"ANIM" for c in chunks) or not frames:
            raise ValueError("an animation without ANIM or frames")
        _, fat, fsize = frames[0]
        x, y = 2 * _le(data, fat, 3), 2 * _le(data, fat + 3, 3)
        fw, fh = _le(data, fat + 6, 3) + 1, _le(data, fat + 9, 3) + 1
        if x + fw > cw or y + fh > ch:
            raise ValueError("a frame outside the canvas")
        image, alph = _image(data, _chunks(data, fat + 16, fat + fsize), in_frame=True)
        return cw, ch, has_alpha, (x, y, image, alph, fw, fh)
    image, alph = _image(data, chunks[1:])
    has_alpha |= alph is not None
    return cw, ch, has_alpha, (0, 0, image, alph, cw, ch)


def _image(data: bytes, chunks: list, in_frame: bool = False) -> tuple:
    """The image chunk and the ALPH before it (None) among ``chunks``; in an
    ANMF frame libwebp's demuxer stops at a chunk of another kind."""
    alph = None
    for c in chunks:
        if in_frame and c[0] not in (b"ALPH", b"VP8 ", b"VP8L"):
            break
        if c[0] == b"ALPH" and alph is None:
            alph = c
        elif c[0] in (b"VP8 ", b"VP8L"):
            return c, (alph if c[0] == b"VP8 " else None)
    raise ValueError("no image data")


def unfilter(levels: np.ndarray, method: int) -> np.ndarray:
    """libwebp's ``WebPUnfilters``: horizontal (1), vertical (2) or gradient
    (3) prediction undone on (H, W) alpha levels; the first row is always
    horizontal from 0, the first column of later rows predicted from above."""
    if method == 0:
        return levels
    h, w = levels.shape
    out = np.zeros((h, w), np.int64)
    src = levels.astype(np.int64)
    out[0] = np.cumsum(src[0]) & 0xFF
    for y in range(1, h):
        prev = out[y - 1]
        if method == 1:
            out[y] = (prev[0] + np.cumsum(src[y])) & 0xFF
        elif method == 2:
            out[y] = (prev + src[y]) & 0xFF
        else:
            left = top_left = int(prev[0])
            row = out[y]
            for x in range(w):
                top = int(prev[x])
                g = left + top - top_left
                g = 0 if g < 0 else 255 if g > 255 else g
                left = (int(src[y, x]) + g) & 0xFF
                top_left = top
                row[x] = left
    return out.astype(np.uint8)


def _alpha(data: bytes, at: int, size: int, width: int, height: int) -> np.ndarray:
    if size < 1:
        raise ValueError("an empty ALPH chunk")
    head = data[at]
    method, filt, pre, rsrv = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("an ALPH chunk of an unknown kind")
    if method == 0:
        if size - 1 < width * height:
            raise ValueError("an ALPH chunk shorter than the image")
        levels = np.frombuffer(data, np.uint8, width * height, at + 1).reshape(height, width)
    else:
        argb = vp8l.decode_stream(data[:at + size], at + 1, width, height)
        levels = ((argb >> 8) & 0xFF).astype(np.uint8)
    return unfilter(levels, filt)


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YUVToR/G/B``: 14-bit fixed point, ``VP8Clip8``."""
    def mult_hi(a, c):
        return (a * c) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    r = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234)
    g = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _upsample_pair(top_c: np.ndarray, cur_c: np.ndarray, width: int) -> tuple:
    """libwebp's fancy upsampler of one chroma plane between chroma rows
    ``top_c`` and ``cur_c``: the chroma of the output row nearer ``top_c``
    and of the one nearer ``cur_c``, each (width,)."""
    tl, l_ = top_c[:-1].astype(np.int64), cur_c[:-1].astype(np.int64)
    t, c = top_c[1:].astype(np.int64), cur_c[1:].astype(np.int64)
    avg = tl + t + l_ + c + 8
    diag_12 = (avg + 2 * (t + l_)) >> 3
    diag_03 = (avg + 2 * (tl + c)) >> 3
    top = np.zeros(width, np.int64)
    bot = np.zeros(width, np.int64)
    top[0] = (3 * int(top_c[0]) + int(cur_c[0]) + 2) >> 2
    bot[0] = (3 * int(cur_c[0]) + int(top_c[0]) + 2) >> 2
    pairs = (width - 1) >> 1
    top[1:2 * pairs:2] = ((diag_12 + tl) >> 1)[:pairs]
    top[2:2 * pairs + 1:2] = ((diag_03 + t) >> 1)[:pairs]
    bot[1:2 * pairs:2] = ((diag_03 + l_) >> 1)[:pairs]
    bot[2:2 * pairs + 1:2] = ((diag_12 + c) >> 1)[:pairs]
    if not width & 1:
        k = width // 2 - 1
        top[width - 1] = (3 * int(top_c[k]) + int(cur_c[k]) + 2) >> 2
        bot[width - 1] = (3 * int(cur_c[k]) + int(top_c[k]) + 2) >> 2
    return top, bot


def yuv420_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """(H, W) luma and ((H+1)//2, (W+1)//2) chroma -> (H, W, 3), as libwebp's
    ``EmitFancyRGB``: row 0 and (for an even height) the last row from one
    chroma row, each other pair of rows between two."""
    H, W = Y.shape
    u_full = np.zeros((H, W), np.int64)
    v_full = np.zeros((H, W), np.int64)
    for P, full in ((U, u_full), (V, v_full)):
        full[0] = _upsample_pair(P[0], P[0], W)[0]
        for k in range(1, (H + 1) // 2 + 1):
            if 2 * k - 1 >= H:
                break
            if 2 * k >= H:                           # the last row of an even height
                full[2 * k - 1] = _upsample_pair(P[k - 1], P[k - 1], W)[0]
                break
            top, bot = _upsample_pair(P[k - 1], P[k], W)
            full[2 * k - 1], full[2 * k] = top, bot
    return _yuv_to_rgb(Y, u_full, v_full)


def _frame_rgba(data: bytes, frame: tuple, native: bool) -> np.ndarray:
    """One image (with its ALPH) -> (h, w, 4) RGBA."""
    _, _, (kind, at, size), alph = frame[:4]
    # libwebp's demuxer hands the decoder the chunk with its padding byte
    payload = data[at:at + size + (size & 1)]
    if native:
        from coma_tpu_torch.native import codecs

        w, h = vp8l.header(payload)[:2] if kind == b"VP8L" else vp8.frame_info(payload)
        return codecs.webp_decode_image(payload, kind == b"VP8L", None if alph is None else
                                        data[alph[1]:alph[1] + alph[2]], w, h)
    if kind == b"VP8L":
        argb = vp8l.decode(payload)
        return np.stack([(argb >> s) & 0xFF for s in (16, 8, 0, 24)], -1).astype(np.uint8)
    Y, U, V = vp8.decode(payload)
    rgb = yuv420_to_rgb(Y, U, V)
    alpha = np.full(Y.shape, 255, np.uint8)
    if alph is not None:
        alpha = _alpha(data, alph[1], alph[2], Y.shape[1], Y.shape[0])
    return np.concatenate([rgb, alpha[..., None]], -1)


def decode_webp(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A WebP file -> what ``np.asarray(PIL.Image.open(f))`` gives (frame 0)
    and its mode; a ``ValueError`` naming ``name`` where Pillow refuses it."""
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.webp_available()
    try:
        cw, ch, has_alpha, frame = _parse(data)
        img = _frame_rgba(data, frame, native)
        if len(frame) > 4 and img.shape[:2] != (frame[5], frame[4]):
            raise ValueError("a frame whose image is not its size")
        if img.shape[:2] == (ch, cw):
            rgba = img
        else:                               # frame 0 of an animation on its canvas
            rgba = np.zeros((ch, cw, 4), np.uint8)
            x, y = frame[0], frame[1]
            rgba[y:y + img.shape[0], x:x + img.shape[1]] = img
    except ValueError as err:
        raise ValueError(f"{name}: WebP: {err}") from None
    if has_alpha:
        return Decoded(rgba, "RGBA")
    return Decoded(np.ascontiguousarray(rgba[..., :3]), "RGB")
