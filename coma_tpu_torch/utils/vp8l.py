"""WebP's lossless bitstream (VP8L), as libwebp's ``vp8l_dec.c`` decodes it:
the plain Python reference of ``native/src/webp_decode.cpp``.

An image stream is its transforms (at the top level only: predictor with
its 14 modes, cross-colour, subtract-green and colour indexing with pixel
bundling; each at most once, applied in reverse order), an optional colour
cache (the hash ``0x1e35a7bd``), Huffman groups chosen per tile by the
meta-Huffman image, and LZ77 backward references whose short distance codes
map through the 120-entry plane-code table. A code of one symbol takes no
bits. Transform data, the meta-Huffman image and a palette are image
streams of their own, without transforms.

:func:`decode` gives the ARGB pixels as (H, W) uint32; a malformed stream
raises ``ValueError``.
"""
from __future__ import annotations

import numpy as np

CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# (dy << 4) | (8 - dx) of the 120 short distance codes
CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)


class BitReader:
    """Least-significant bit first, as VP8L packs them."""

    def __init__(self, data: bytes, pos: int = 0):
        self.value = int.from_bytes(data[pos:], "little")
        self.total = 8 * (len(data) - pos)
        self.bit = 0

    def read(self, n: int) -> int:
        if self.bit + n > self.total:
            raise ValueError("the lossless bitstream ends early")
        v = (self.value >> self.bit) & ((1 << n) - 1)
        self.bit += n
        return v


class Huffman:
    """A canonical code from its lengths; one symbol of any length takes no
    bits, an incomplete or over-full code is refused."""

    def __init__(self, lengths):
        symbols = [s for s, n in enumerate(lengths) if n]
        if not symbols:
            raise ValueError("a Huffman code without symbols")
        self.single = symbols[0] if len(symbols) == 1 else None
        if self.single is not None:
            return
        maxlen = max(lengths)
        self.count = [0] * (maxlen + 1)
        for n in lengths:
            if n:
                self.count[n] += 1
        left = 1
        for n in range(1, maxlen + 1):
            left = 2 * left - self.count[n]
            if left < 0:
                raise ValueError("an over-subscribed Huffman code")
        if left:
            raise ValueError("an incomplete Huffman code")
        self.symbols = sorted(symbols, key=lambda s: (lengths[s], s))

    def read(self, br: BitReader) -> int:
        if self.single is not None:
            return self.single
        code = first = index = 0
        for n in range(1, len(self.count)):
            code |= br.read(1)
            count = self.count[n]
            if code - first < count:
                return self.symbols[index + code - first]
            index += count
            first = (first + count) << 1
            code <<= 1
        raise ValueError("a Huffman code out of its table")


def _code_lengths(br: BitReader, alphabet: int) -> list:
    lengths = [0] * alphabet
    if br.read(1):                                  # a simple code: one or two symbols
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        if first < alphabet:
            lengths[first] = 1
        if two:
            second = br.read(8)
            if second < alphabet:
                lengths[second] = 1
        return lengths
    num = br.read(4) + 4
    cl = [0] * 19
    for i in range(num):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    table = Huffman(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("more code lengths than symbols")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        code = table.read(br)
        if code < 16:
            lengths[symbol] = code
            symbol += 1
            if code:
                prev = code
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[code - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise ValueError("a code-length repeat past the alphabet")
        value = prev if code == 16 else 0
        lengths[symbol:symbol + repeat] = [value] * repeat
        symbol += repeat
    return lengths


def _prefix_value(symbol: int, br: BitReader) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image_stream(br: BitReader, xsize: int, ysize: int, top: bool) -> tuple:
    """(pixels (ysize', xsize') uint32, transforms): the entropy-coded image,
    its width narrowed by colour indexing, and the transforms in the order
    read (top level only)."""
    transforms = []
    if top:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("a transform twice")
            seen.add(kind)
            if kind in (0, 1):
                bits = br.read(3) + 2
                data, _ = _image_stream(br, _subsample(xsize, bits), _subsample(ysize, bits), False)
                transforms.append((kind, bits, data, xsize))
            elif kind == 3:
                num = br.read(8) + 1
                bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
                data, _ = _image_stream(br, num, 1, False)
                palette = np.zeros(1 << (8 >> bits), np.uint32)
                raw = data.reshape(-1).view(np.uint8).reshape(-1, 4)
                palette[:num] = np.cumsum(raw, axis=0, dtype=np.uint8).view(np.uint32).reshape(-1)
                transforms.append((3, bits, palette, xsize))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((2, 0, None, xsize))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"colour cache bits {cache_bits}")
    meta, meta_bits, groups = None, 0, 1
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        mx = _subsample(xsize, meta_bits)
        image, _ = _image_stream(br, mx, _subsample(ysize, meta_bits), False)
        meta = ((image >> 8) & 0xFFFF).astype(np.int64)
        groups = int(meta.max()) + 1
    cache_size = 1 << cache_bits if cache_bits else 0
    sizes = (256 + 24 + cache_size, 256, 256, 256, 40)
    tables = [[Huffman(_code_lengths(br, n)) for n in sizes] for _ in range(groups)]
    return _entropy_decode(br, xsize, ysize, tables, meta, meta_bits, cache_bits), transforms


def _entropy_decode(br, xsize, ysize, tables, meta, meta_bits, cache_bits) -> np.ndarray:
    total = xsize * ysize
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = pos = 0
    while pos < total:
        y, x = divmod(pos, xsize)
        green, red, blue, alpha, dist = tables[0 if meta is None else
                                               int(meta[y >> meta_bits, x >> meta_bits])]
        code = green.read(br)
        if code < 256:
            r, b, a = red.read(br), blue.read(br), alpha.read(br)
            out[pos] = a << 24 | r << 16 | code << 8 | b
            pos += 1
        elif code < 256 + 24:
            length = _prefix_value(code - 256, br)
            dcode = _prefix_value(dist.read(br), br)
            if dcode > 120:
                d = dcode - 120
            else:
                plane = CODE_TO_PLANE[dcode - 1]
                d = max((plane >> 4) * xsize + 8 - (plane & 15), 1)
            if d > pos or length > total - pos:
                raise ValueError("a backward reference out of the image")
            for k in range(length):
                out[pos + k] = out[pos + k - d]
            pos += length
        else:
            if cache is None:
                raise ValueError("a colour-cache code without a cache")
            while cached < pos:
                cache[((out[cached] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = out[cached]
                cached += 1
            out[pos] = cache[code - 280]
            pos += 1
        if cache is not None:
            while cached < pos:
                cache[((out[cached] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = out[cached]
                cached += 1
    return np.array(out, np.uint32).reshape(ysize, xsize)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    if mode == 0 or mode > 13:
        return 0xFF000000
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:                                  # Select
        diff = sum(abs((L >> s & 255) - (TL >> s & 255)) - abs((T >> s & 255) - (TL >> s & 255))
                   for s in (24, 16, 8, 0))
        return T if diff <= 0 else L
    if mode == 12:                                  # ClampAddSubtractFull
        return sum(_clip((L >> s & 255) + (T >> s & 255) - (TL >> s & 255)) << s
                   for s in (24, 16, 8, 0))
    avg = _avg(L, T)                                # 13: ClampAddSubtractHalf
    out = 0
    for s in (24, 16, 8, 0):
        a, b = avg >> s & 255, TL >> s & 255
        out |= _clip(a + int((a - b) / 2)) << s
    return out


def _inverse(kind: int, bits: int, data, xsize: int, px: np.ndarray) -> np.ndarray:
    ysize = px.shape[0]
    if kind == 2:                                   # subtract green
        g = (px >> 8) & 0xFF
        r = (((px >> 16) & 0xFF) + g) & 0xFF
        b = ((px & 0xFF) + g) & 0xFF
        return (px & 0xFF00FF00) | r << 16 | b
    if kind == 3:                                   # colour indexing
        per = 1 << bits
        idx = ((px >> 8) & 0xFF).astype(np.int64)
        if bits:
            width = 8 >> bits
            shifts = np.arange(per) * width
            idx = ((idx[..., None] >> shifts) & ((1 << width) - 1)).reshape(ysize, -1)
        return data[idx[:, :xsize]]
    if kind == 1:                                   # cross colour
        out = px.copy()
        for y in range(ysize):
            for x in range(xsize):
                m = int(data[y >> bits, x >> bits])
                g2r, g2b, r2b = [np.int8(np.uint8(m >> s & 255)) for s in (0, 8, 16)]
                argb = int(px[y, x])
                green = int(np.int8(np.uint8(argb >> 8 & 255)))
                red = ((argb >> 16 & 255) + ((int(g2r) * green) >> 5)) & 255
                blue = (argb & 255) + ((int(g2b) * green) >> 5)
                blue = (blue + ((int(r2b) * int(np.int8(np.uint8(red)))) >> 5)) & 255
                out[y, x] = (argb & 0xFF00FF00) | red << 16 | blue
        return out
    flat = [int(v) for v in px.reshape(-1)]         # predictor, in place row by row
    for y in range(ysize):
        for x in range(xsize):
            i = y * xsize + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else flat[i - 1]
            elif x == 0:
                pred = flat[i - xsize]
            else:
                mode = (int(data[y >> bits, x >> bits]) >> 8) & 15
                pred = _predict(mode, flat[i - 1], flat[i - xsize], flat[i - xsize + 1],
                                flat[i - xsize - 1])
            flat[i] = _add(flat[i], pred)
    return np.array(flat, np.uint32).reshape(ysize, xsize)


def decode_stream(data: bytes, pos: int, width: int, height: int) -> np.ndarray:
    """A headerless image stream (an ``ALPH`` chunk's) at ``data[pos:]`` ->
    (H, W) ARGB uint32."""
    br = BitReader(data, pos)
    px, transforms = _image_stream(br, width, height, True)
    for kind, bits, tdata, xsize in reversed(transforms):
        px = _inverse(kind, bits, tdata, xsize, px)
    return px


def header(data: bytes) -> tuple:
    """A ``VP8L`` chunk's (width, height, alpha_is_used); refuses a bad
    signature or version."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("not a VP8L bitstream")
    bits = int.from_bytes(data[1:5], "little")
    if bits >> 29:
        raise ValueError(f"VP8L version {bits >> 29}")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool(bits >> 28 & 1)


def decode(data: bytes) -> np.ndarray:
    """A ``VP8L`` chunk's payload -> (H, W) ARGB uint32."""
    width, height, _ = header(data)
    return decode_stream(data, 5, width, height)
