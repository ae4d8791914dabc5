#!/usr/bin/env python3
"""Write the image fixtures of ``tests/data/images/`` and their manifest.

    python3 tools/make_image_fixtures.py

Needs Pillow and gcc with libjpeg-turbo's headers and library (the CPU test
host has them; the card machine has neither, which is why the files and the
manifest are committed). Every image is made from a numpy seed. Pillow
writes what it can (baseline and progressive JPEGs, CMYK, BMP, TGA, PNM,
TIFF, GIF); ``tools/jpeg_fixture_writer.c``, compiled here against the
system's libjpeg-turbo 2.1.5 (``C_ARITH_CODING_SUPPORTED``), writes the
arithmetic-coded, odd-sampled, YCCK and block-smoothed JPEGs; the Python
writers below write what neither can: Adam7 PNGs, lossless (SOF3), 12-bit,
DNL and hierarchical JPEGs, RLE and bitfield BMPs, tiled and predicted
TIFFs, and TGAs and PNMs of every type. ``manifest.json`` records, per file,
Pillow's mode, the shape and dtype of ``np.asarray(Image.open(f))`` and the
SHA-256 of it and of ``convert(m)`` for m in RGB and L, or ``"raises": true``
where Pillow refuses the file (the port must refuse it too), with the
Pillow and libjpeg-turbo versions that decoded them. ``step_video`` records
the hash of Pillow's decoding of the seeded step-video frames
(:func:`step_video_frames`) written by ``coma_tpu``'s PIL call. The readers'
tests and ``chip_smoke.py`` phase 16 hold the port against these hashes.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "images")
BEHAVE_SIZE = (1536, 2048)       # BEHAVE's Kinect colour frames: 2048 x 1536
STEP_VIDEO = dict(frames=17, height=256, width=512, seed=21)   # ⌈50/3⌉ frames of a 256² run


def array_sha(a: np.ndarray) -> str:
    """SHA-256 of an array's values in C order; a bool array as 0/1 bytes
    (PIL's "1" arrays hold 0/255 bytes behind numpy's bool)."""
    a = np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
                          .tobytes()).hexdigest()


def seeded_rgb(shape, seed: int, noise: float = 20.0) -> np.ndarray:
    """Smooth colour waves plus Gaussian noise, uint8 (H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0) for c in range(3)],
                      -1)
    return np.clip(smooth + rng.normal(0, noise, shape + (3,)), 0, 255).astype(np.uint8)


def behave_frame(seed: int) -> np.ndarray:
    """A smooth 2048 x 1536 colour frame: room-like gradients and a few
    soft-edged blobs, little noise (so the file stays small)."""
    rng = np.random.default_rng(seed)
    H, W = BEHAVE_SIZE
    yy, xx = np.mgrid[:H, :W] / np.float32(max(H, W))
    img = np.stack([90 + 80 * xx + 30 * np.sin(3 * yy), 100 + 60 * yy + 20 * np.cos(4 * xx),
                    120 - 50 * xx * yy + 10 * np.sin(9 * xx)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0.1, 0.7), rng.uniform(0.1, 1.2), rng.uniform(0.05, 0.2)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2) ** 2)
        img += blob[..., None] * rng.uniform(-70, 70, 3)
    img += rng.normal(0, 1.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def behave_mask() -> np.ndarray:
    """A person-shaped 2048 x 1536 mask (head, torso, legs as ellipses), 0/255."""
    H, W = BEHAVE_SIZE
    yy, xx = np.mgrid[:H, :W]
    inside = np.zeros((H, W), bool)
    for cy, cx, ry, rx in ((380, 1000, 90, 75), (700, 1000, 260, 170), (1150, 930, 300, 60),
                           (1150, 1070, 300, 60), (650, 800, 200, 45), (650, 1200, 200, 45)):
        inside |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return np.where(inside, 255, 0).astype(np.uint8)


def fabric(seed: int) -> np.ndarray:
    """The 512² fabric pattern of ``chip_smoke.write_chair`` with less noise
    (so the JPEG stays small), uint8 (512, 512, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:512, :512] / 512
    tex = np.stack([0.55 + 0.25 * np.sin(40 * xx), 0.35 + 0.15 * np.sin(25 * yy),
                    np.full_like(xx, 0.25)], -1) + rng.uniform(0, 0.04, (512, 512, 3))
    return np.uint8(np.clip(tex, 0, 1) * 255)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _filter_rows(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row with a filter type of its own (cycling None, Sub, Up,
    Average, Paeth from ``first``), so a reader meets all five."""
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for i, row in enumerate(rows.astype(np.int32)):
        kind = (first + i) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def adam7_png(samples: np.ndarray, ctype: int, depth: int = 8, palette=None) -> bytes:
    """An Adam7-interlaced PNG of uint8 samples (H, W, C): colour type 2 (RGB,
    depth 8) or 3 (palette indices, depth 1-8, with ``palette`` (N, 3))."""
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)
    data = []
    for p, (x0, y0, dx, dy) in enumerate(_ADAM7):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        h, w = sub.shape[:2]
        if depth < 8:
            bits = np.unpackbits(sub.reshape(h, w * C, 1), axis=-1)[..., 8 - depth:]
            rows = np.packbits(bits.reshape(h, -1), axis=1)
        else:
            rows = sub.reshape(h, w * C)
        data.append(_filter_rows(rows, bpp, first=p))
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 1)
    extra = _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if ctype == 3 else b""
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(b"".join(data), 9)) + _chunk(b"IEND", b""))


def texture_atlas(seed: int) -> np.ndarray:
    """A 2048 x 1536 texture atlas: smooth gradients with flat-shaded islands,
    posterised to steps of 24 (so run-length and LZW files stay small)."""
    rng = np.random.default_rng(seed)
    H, W = BEHAVE_SIZE
    yy, xx = np.mgrid[:H, :W] / np.float32(W)
    img = np.stack([90 + 80 * xx + 30 * np.sin(3 * yy), 100 + 60 * yy + 20 * np.cos(4 * xx),
                    120 - 50 * xx * yy], -1)
    for _ in range(24):
        y0, x0 = rng.integers(0, H - 200), rng.integers(0, W - 300)
        h, w = rng.integers(80, 400), rng.integers(120, 600)
        img[y0:y0 + h, x0:x0 + w] = img[y0:y0 + h, x0:x0 + w] * 0.6 + rng.uniform(0, 255, 3) * 0.4
    return np.clip(img, 0, 255).astype(np.uint8) // 24 * 24


def step_video_frames(frames: int, height: int, width: int, seed: int) -> np.ndarray:
    """(frames, height, width, 3) uint8 frames shaped like ``compose_step_frames``'
    output: on the left a picture emerging from noise, on the right the
    adaptive mask, a 32 x 32 latent grid upsampled by nearest, growing."""
    rng = np.random.default_rng(seed)
    half = width // 2
    yy, xx = np.mgrid[:height, :half] / np.float32(height)
    picture = np.stack([120 + 90 * np.sin(5 * xx + 1) * np.cos(3 * yy),
                        110 + 70 * np.cos(4 * yy), 100 + 60 * xx], -1)
    grid = rng.uniform(size=(32, 32))
    out = np.empty((frames, height, width, 3), np.uint8)
    for k in range(frames):
        t = k / max(1, frames - 1)
        noisy = picture + rng.normal(0, 60 * (1 - t) + 4, picture.shape)
        mask = (grid < 0.2 + 0.6 * t).astype(np.float32) * 255
        mask = np.repeat(np.repeat(mask, height // 32, 0), half // 32, 1)
        out[k, :, :half] = np.clip(noisy, 0, 255).astype(np.uint8)
        out[k, :, half:] = mask[..., None].astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# JPEG writers: libjpeg-turbo through the C helper, and what it cannot write
# ---------------------------------------------------------------------------

def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _BitWriter:
    """JPEG entropy-coded bits, most significant first, 0xFF stuffed."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out += bytes([self.acc, 0]) if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def lossless_jpeg(samples: np.ndarray, predictor: int, pt: int = 0, restart: int = 0,
                  adobe_rgb: bool = True, marker: int = 0xC3) -> bytes:
    """A lossless (SOF3) 8-bit JPEG of (H, W) or (H, W, C) samples, 1x1
    sampling: predictor 1-7, point transform ``pt``, a restart interval of
    ``restart`` MCUs (whole rows), one Huffman table of 17 five-bit codes.
    ``adobe_rgb`` adds an Adobe marker (transform 0: no colour conversion)."""
    x = np.asarray(samples, np.int64)
    x = (x[..., None] if x.ndim == 2 else x) >> pt
    H, W, C = x.shape
    out = b"\xff\xd8"
    if C == 3 and adobe_rgb:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    out += _segment(marker, bytes([8]) + struct.pack(">HH", H, W) + bytes([C])
                    + b"".join(bytes([i + 1, 0x11, 0]) for i in range(C)))
    counts = [0] * 16
    counts[4] = 17
    out += _segment(0xC4, bytes([0x00] + counts) + bytes(range(17)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([C]) + b"".join(bytes([i + 1, 0]) for i in range(C))
                    + bytes([predictor, 0, pt]))
    segments, bits = [], _BitWriter()
    first_row = 0
    for y in range(H):
        for xx in range(W):
            m = y * W + xx
            if restart and m and m % restart == 0:
                segments.append(bits.flush())
                bits, first_row = _BitWriter(), y
            for c in range(C):
                if y == first_row and xx == 0:
                    p = 1 << (7 - pt)
                elif y == first_row:
                    p = x[y, xx - 1, c]
                elif xx == 0:
                    p = x[y - 1, xx, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c]
                    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                         6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                d = int(x[y, xx, c] - p) & 0xFFFF
                d = d - 0x10000 if d >= 0x8000 else d
                size = 16 if d == -32768 else abs(d).bit_length()
                bits.put(size, 5)
                if 0 < size < 16:
                    bits.put(d if d > 0 else d - 1 + (1 << size), size)
    segments.append(bits.flush())
    body = b"".join((bytes([0xFF, 0xD0 + (i - 1) % 8]) if i else b"") + seg
                    for i, seg in enumerate(segments))
    return out + body + b"\xff\xd9"


def twelve_bit_jpeg() -> bytes:
    """A 16 x 16 gray SOF1 file at 12-bit precision: flat blocks, each a DC
    difference of 0 and an end of block (one-code Huffman tables)."""
    table = bytes(range(64))
    one_code = bytes([1] + [0] * 15) + b"\x00"
    out = b"\xff\xd8" + _segment(0xDB, b"\x00" + table)
    out += _segment(0xC1, bytes([12]) + struct.pack(">HH", 16, 16) + b"\x01\x01\x11\x00")
    out += _segment(0xC4, b"\x00" + one_code) + _segment(0xC4, b"\x10" + one_code)
    out += _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00")
    bits = _BitWriter()
    for _ in range(4):
        bits.put(0, 2)
    return out + bits.flush() + b"\xff\xd9"


def _sof_patched(data: bytes, marker: int, prefix: bytes = b"") -> bytes:
    """``data`` with its SOF0 marker code replaced by ``marker`` (and
    ``prefix`` segments put before it)."""
    i = data.index(b"\xff\xc0")
    return data[:i] + prefix + bytes([0xFF, marker]) + data[i + 2:]


def dnl_jpeg(data: bytes) -> bytes:
    """``data`` (a one-scan baseline file) with a frame height of 0 and the
    height in a DNL marker after the scan."""
    i = data.index(b"\xff\xc0")
    height = data[i + 5:i + 7]
    return (data[:i + 5] + b"\x00\x00" + data[i + 7:-2] + b"\xff\xdc\x00\x04" + height
            + b"\xff\xd9")


def sampling_patched(data: bytes, factors: list) -> bytes:
    """``data`` with the frame's per-component sampling bytes replaced."""
    out = bytearray(data)
    i = data.index(b"\xff\xc0")
    for k, (h, v) in enumerate(factors):
        out[i + 11 + 3 * k] = h << 4 | v
    return bytes(out)


def drop_scans(data: bytes, keep) -> bytes:
    """``data`` with every scan for which ``keep(scan header)`` is false
    removed (a progressive file whose components lack their AC scans)."""
    out, pos = bytearray(b"\xff\xd8"), 2
    while data[pos + 1] != 0xD9:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        end = pos + 2 + length
        if data[pos + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
                end += 1
            if keep(data[pos + 4:pos + 2 + length]):
                out += data[pos:end]
        else:
            out += data[pos:end]
        pos = end
    return bytes(out + b"\xff\xd9")


class LibjpegWriter:
    """``tools/jpeg_fixture_writer.c`` built with gcc against the system's
    libjpeg-turbo, in a temporary directory."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="jpeg_fixture_writer_")
        self.exe = os.path.join(self.dir, "jfw")
        subprocess.run(["gcc", "-O2", os.path.join(REPO, "tools", "jpeg_fixture_writer.c"),
                        "-ljpeg", "-o", self.exe], check=True)

    def __call__(self, image: np.ndarray, space: str = "ycc", quality: int = 75, arith: int = 0,
                 progression: int = 0, sampling: str = "", restart_rows: int = 0,
                 conditioning=(0, 1, 5)) -> bytes:
        raw = os.path.join(self.dir, "raw.bin")
        out = os.path.join(self.dir, "out.jpg")
        np.ascontiguousarray(image, np.uint8).tofile(raw)
        H, W = image.shape[:2]
        subprocess.run([self.exe, out, raw, str(W), str(H), space, str(quality), str(arith),
                        str(progression), sampling, str(restart_rows),
                        *map(str, conditioning)], check=True)
        with open(out, "rb") as fh:
            return fh.read()

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# BMP, TGA, PNM and TIFF writers for what Pillow does not write
# ---------------------------------------------------------------------------

def bmp_file(rows: bytes, width: int, height: int, bits: int, compression: int = 0,
             palette=None, masks=None, top_down: bool = False, header: int = 40) -> bytes:
    """A BMP of pixel ``rows`` (already packed and padded, file order) with
    a ``header``-byte info header (12: OS/2 1.x, 24-bit palette entries)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(rows), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        extra = b"" if masks is None else struct.pack(f"<{len(masks)}I", *masks)
        info = (info + extra).ljust(header, b"\x00")
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(rows), 0, 0, offset) + info + pal + rows


def bmp_rows(pixels: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows of (H, W) indices or (H, W, C) bytes, padded to 4."""
    H = pixels.shape[0]
    if bits < 8:
        per = 8 // bits
        idx = pixels.astype(np.uint8)
        pad = (-idx.shape[1]) % per
        idx = np.pad(idx, ((0, 0), (0, pad)))
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        packed = (idx.reshape(H, -1, per) << shifts).sum(-1).astype(np.uint8)
    elif bits == 16:
        packed = pixels.astype("<u2").view(np.uint8).reshape(H, -1)
    else:
        packed = pixels.reshape(H, -1).astype(np.uint8)
    packed = np.pad(packed, ((0, 0), (0, (-packed.shape[1]) % 4)))
    return packed[::-1].tobytes()


def bmp_rle8(idx: np.ndarray) -> bytes:
    """RLE8 of bottom-up (H, W) indices: runs, absolute runs (word aligned),
    a delta escape, end-of-line and end-of-bitmap escapes."""
    out = bytearray()
    for r, row in enumerate(idx[::-1]):
        x = 0
        row = row.tolist()
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 3 or len(row) - x < 3:
                out += bytes([run, row[x]])
                x += run
            else:
                n = min(len(row) - x, 8)
                out += bytes([0, n]) + bytes(row[x:x + n]) + (b"\x00" if n % 2 else b"")
                x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_rle4(idx: np.ndarray) -> bytes:
    """RLE4 of bottom-up (H, W) 4-bit indices: two-colour runs and absolute
    runs of an even count (PIL reads the pixel pairs of count // 2 bytes)."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x = 0
        while x < len(row):
            if x + 4 <= len(row) and x % 3 == 0:
                n = 4
                out += bytes([0, n]) + bytes([row[x] << 4 | row[x + 1], row[x + 2] << 4 | row[x + 3]])
            else:
                n = min(len(row) - x, 2 + x % 5)
                second = row[x + 1] if n > 1 else 0
                out += bytes([n, row[x] << 4 | second])
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def tga_file(image_type: int, width: int, height: int, depth: int, data: bytes,
             cmap: bytes = b"", cmap_start: int = 0, cmap_len: int = 0, cmap_depth: int = 0,
             origin: int = 0, alpha_bits: int = 0, image_id: bytes = b"") -> bytes:
    header = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if cmap_len else 0, image_type,
                         cmap_start, cmap_len, cmap_depth, 0, 0, width, height, depth,
                         origin | alpha_bits)
    return header + image_id + cmap + data


def tga_rle(rows: np.ndarray, pixel_bytes: int, across_rows: bool = False) -> bytes:
    """Run-length packets of (H, W * pixel_bytes) rows: runs of repeated
    pixels, literals otherwise; ``across_rows`` lets literals continue into
    the next row (runs never do)."""
    H = rows.shape[0]
    px = rows.reshape(H, -1, pixel_bytes)
    out = bytearray()
    pending = []                                      # a literal carried across rows
    for y in range(H):
        row = [bytes(p) for p in px[y]]
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 128:
                run += 1
            if run >= 2:
                if pending:
                    out += bytes([len(pending) - 1]) + b"".join(pending)
                    pending = []
                out += bytes([0x80 | (run - 1)]) + row[x]
                x += run
            else:
                pending.append(row[x])
                x += 1
                if len(pending) == 128:
                    out += bytes([127]) + b"".join(pending)
                    pending = []
        if pending and not across_rows:
            out += bytes([len(pending) - 1]) + b"".join(pending)
            pending = []
    if pending:
        out += bytes([len(pending) - 1]) + b"".join(pending)
    return bytes(out)


def tiff_file(pixels: np.ndarray, bits: tuple, photometric: int, compression: int = 1,
              predictor: int = 1, tile=None, rows_per_strip: int = 0, extra=(),
              colormap=None, big_endian: bool = False, width: int = 0) -> bytes:
    """A one-page TIFF of (H, W, C) byte samples (or packed (H, row bytes)
    rows of ``width`` pixels for bits below 8), in strips or ``tile`` =
    (w, h) tiles, compressed with none (1), Deflate (8) or PackBits (32773),
    with horizontal differencing (predictor 2)."""
    o = ">" if big_endian else "<"
    px = pixels if pixels.ndim == 3 else pixels[..., None]
    H, W = px.shape[0], width or px.shape[1]
    spp = len(bits)

    def encode(block: np.ndarray) -> bytes:
        b = block.copy()
        if predictor == 2:
            b[:, 1:] = (b[:, 1:].astype(np.int16) - block[:, :-1]).astype(np.uint8)
        raw = b.tobytes()
        if compression == 8:
            return zlib.compress(raw, 9)
        if compression == 32773:
            return _packbits(raw, b.shape[1] * b.shape[2] if b.ndim == 3 else b.shape[1])
        return raw

    chunks = []
    if tile:
        tw, th = tile
        for ty in range(0, H, th):
            for tx in range(0, W, tw):
                block = np.zeros((th, tw, px.shape[2]), np.uint8)
                part = px[ty:ty + th, tx:tx + tw]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(encode(block))
    else:
        rps = rows_per_strip or H
        chunks = [encode(px[y:y + rps]) for y in range(0, H, rps)]
    entries = {256: (4, [W]), 257: (4, [H]), 258: (3, list(bits)), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [1])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.reshape(-1) * 257))
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or H])
    data = bytearray((b"MM\x00*" if big_endian else b"II*\x00") + b"\x00" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + (b"\x00" if len(c) % 2 else b"")
    entries[324 if tile else 273] = (4, offsets)
    entries[325 if tile else 279] = (4, [len(c) for c in chunks])
    blobs = bytearray()
    ifd_at = len(data)
    n = len(entries)
    table = bytearray(struct.pack(o + "H", n))
    blob_at = ifd_at + 2 + 12 * n + 4
    for tag in sorted(entries):
        kind, values = entries[tag]
        code = "H" if kind == 3 else "I"
        packed = struct.pack(o + code * len(values), *values)
        if len(packed) <= 4:
            table += struct.pack(o + "HHI", tag, kind, len(values)) + packed.ljust(4, b"\x00")
        else:
            table += struct.pack(o + "HHII", tag, kind, len(values), blob_at + len(blobs))
            blobs += packed + (b"\x00" if len(packed) % 2 else b"")
    table += b"\x00\x00\x00\x00"
    data += table + blobs
    data[4:8] = struct.pack(o + "I", ifd_at)
    return bytes(data)


def _packbits(raw: bytes, row: int) -> bytes:
    """PackBits, row by row: runs of 3 or more, literals otherwise."""
    out = bytearray()
    for r in range(0, len(raw), row):
        line, i = raw[r:r + row], 0
        while i < len(line):
            j = i
            while j < len(line) and j - i < 128 and line[j] == line[i]:
                j += 1
            if j - i >= 3:
                out += bytes([257 - (j - i)]) + line[i:i + 1]
                i = j
                continue
            j = i + 1
            while j < len(line) and j - i < 128 and not line[j:j + 3] == line[j:j + 1] * 3:
                j += 1
            out += bytes([j - i - 1]) + line[i:j]
            i = j
    return bytes(out)


def fixtures() -> dict:
    """{file name: (kind, bytes)}."""
    from PIL import Image

    def jpeg(image, **kw):
        buf = io.BytesIO()
        (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(
            buf, "JPEG", **kw)
        return buf.getvalue()

    out = {}
    base = seeded_rgb((48, 64), 1)
    for sub, tag in ((2, "420"), (1, "422"), (0, "444")):
        for q in (30, 75, 95):
            out[f"baseline_{tag}_q{q}.jpg"] = (f"baseline {tag} q{q}",
                                               jpeg(base, quality=q, subsampling=sub))
    out["gray_q75.jpg"] = ("grayscale", jpeg(base[..., 1], quality=75))
    for h, w in ((37, 53), (17, 16), (8, 8)):
        out[f"odd_{h}x{w}.jpg"] = ("odd size", jpeg(seeded_rgb((h, w), h + w), quality=75))
    out["optimized.jpg"] = ("optimize=True", jpeg(base, quality=75, optimize=True))
    out["restart.jpg"] = ("restart_marker_blocks=5",
                          jpeg(base, quality=75, restart_marker_blocks=5))
    out["progressive_420.jpg"] = ("progressive 4:2:0", jpeg(seeded_rgb((72, 96), 3), quality=80,
                                                            progressive=True))
    out["progressive_gray.jpg"] = ("progressive grayscale",
                                   jpeg(seeded_rgb((72, 96), 4)[..., 0], quality=80,
                                        progressive=True))
    exif = Image.Exif()
    exif[0x010F] = "seeded camera"          # Make
    exif[0x0112] = 6                        # Orientation (Pillow's open leaves it alone)
    icc = b"\x00\x00\x02\x0c" + bytes(range(256)) * 2
    out["metadata.jpg"] = ("EXIF, ICC and COM segments",
                           jpeg(base, quality=75, exif=exif.tobytes(), icc_profile=icc,
                                comment=b"seeded fixture"))
    cmyk = Image.fromarray(base).convert("CMYK")
    out["cmyk.jpg"] = ("CMYK, Pillow's inverted Adobe CMYK", jpeg(cmyk, quality=75))
    rgb = seeded_rgb((29, 37), 5)
    out["interlaced_rgb.png"] = ("Adam7 RGB", adam7_png(rgb, 2))
    rng = np.random.default_rng(6)
    palette = rng.integers(0, 256, (16, 3))
    out["interlaced_palette.png"] = ("Adam7 palette, 4-bit",
                                     adam7_png(rng.integers(0, 16, (29, 37, 1)).astype(np.uint8),
                                               3, depth=4, palette=palette))
    out["fabric_512.jpg"] = ("512² progressive texture (phase 16's chair)",
                             jpeg(fabric(7), quality=85, progressive=True))
    out["behave_color_2048x1536.jpg"] = ("BEHAVE colour frame, 4:2:0 q90",
                                         jpeg(behave_frame(8), quality=90))
    out["behave_mask_2048x1536.jpg"] = ("BEHAVE person mask, grayscale",
                                        jpeg(behave_mask(), quality=90))
    out.update(jpeg_processes(jpeg))
    out.update(other_formats())
    return out


def jpeg_processes(jpeg) -> dict:
    """The JPEG processes libjpeg-turbo decodes beyond baseline and Huffman
    progressive, and the files it refuses."""
    writer = LibjpegWriter()
    try:
        base, small = seeded_rgb((48, 64), 11), seeded_rgb((21, 27), 12)
        cmyk = np.concatenate([base, base[..., 1:2] // 2], -1)
        out = {
            "arith_420.jpg": ("arithmetic sequential (SOF9), 4:2:0", writer(base, arith=1)),
            "arith_dac_restart.jpg": ("arithmetic sequential (SOF9), DAC L=2 U=6 K=12, restart "
                                      "every row", writer(base, arith=1, restart_rows=1,
                                                          conditioning=(2, 6, 12))),
            "arith_progressive.jpg": ("arithmetic progressive (SOF10)",
                                      writer(seeded_rgb((56, 72), 13), arith=1, progression=1)),
            "arith_gray.jpg": ("arithmetic sequential grayscale",
                               writer(base[..., 0], space="gray", arith=1, quality=90)),
            "sampling_411.jpg": ("4:1:1 sampling", writer(base, sampling="4x1,1x1,1x1")),
            "sampling_440.jpg": ("4:4:0 sampling (h1v2 fancy upsampling)",
                                 writer(base, sampling="1x2,1x1,1x1")),
            "sampling_mixed.jpg": ("mixed sampling (2,2),(2,1),(1,1)",
                                   writer(seeded_rgb((45, 61), 14), sampling="2x2,2x1,1x1")),
            "sampling_odd.jpg": ("mixed sampling (1,1),(2,2),(1,1), 3x1 chroma",
                                 writer(small, sampling="3x1,1x1,3x1")),
            "ycck.jpg": ("YCCK, Adobe transform 2", writer(cmyk, space="ycck")),
            "cmyk_libjpeg.jpg": ("CMYK, Adobe transform 0, 2x2 K-less sampling",
                                 writer(cmyk, space="cmyk", quality=85)),
            "smoothed_420.jpg": ("progressive cut at Al 1 (libjpeg's block smoothing), 4:2:0",
                                 writer(seeded_rgb((61, 77), 15), progression=2)),
            "smoothed_arith.jpg": ("arithmetic progressive cut at Al 1 (block smoothing)",
                                   writer(seeded_rgb((40, 56), 16), arith=1, progression=2)),
            "smoothed_gray_2x2.jpg": ("grayscale progressive cut at Al 1, 2x2 factors, two iMCU "
                                      "rows (block smoothing)",
                                      writer(seeded_rgb((17, 23), 17)[..., 0], space="gray",
                                             progression=2, sampling="2x2")),
            "rgb_stored.jpg": ("RGB stored (Adobe transform 0), progressive",
                               writer(base, space="rgb", progression=1)),
        }
        prog = writer(seeded_rgb((40, 48), 18), progression=1)
        out["dc_only_chroma.jpg"] = ("progressive, chroma without AC scans (DC interpolation)",
                                     drop_scans(prog, lambda h: h[1 + 2 * h[0]] == 0
                                                or (h[0] == 1 and h[1] == 1)))
        atlas = texture_atlas(9)
        out["atlas_arith_2048x1536.jpg"] = ("2048 x 1536 atlas, arithmetic (SOF9)",
                                            writer(atlas, arith=1, quality=90))
        out["atlas_smoothed_2048x1536.jpg"] = ("2048 x 1536 atlas, progressive cut at Al 1 "
                                               "(block smoothing)",
                                               writer(atlas, progression=2, quality=90))
    finally:
        writer.close()
    gray, rgb = seeded_rgb((20, 26), 19)[..., 0], seeded_rgb((18, 22), 20)
    out.update({
        "lossless_gray_p1.jpg": ("lossless (SOF3) grayscale, predictor 1", lossless_jpeg(gray, 1)),
        "lossless_gray_p4_pt2.jpg": ("lossless (SOF3) grayscale, predictor 4, point transform 2",
                                     lossless_jpeg(gray, 4, pt=2)),
        "lossless_rgb_p7_restart.jpg": ("lossless (SOF3) RGB, predictor 7, restart every 2 rows",
                                        lossless_jpeg(rgb, 7, restart=44)),
        "lossless_ycc_p6.jpg": ("lossless (SOF3) with ids 1, 2, 3 (converted as YCbCr), "
                                "predictor 6", lossless_jpeg(rgb, 6, adobe_rgb=False)),
    })
    baseline = jpeg(seeded_rgb((16, 16), 1), quality=75)
    frame = baseline[baseline.index(b"\xff\xc0") + 2:]
    frame = frame[:int.from_bytes(frame[:2], "big")]
    out.update({
        "refused_12bit.jpg": ("12-bit samples (refused)", twelve_bit_jpeg()),
        "refused_dnl.jpg": ("a DNL height (refused)",
                            dnl_jpeg(jpeg(seeded_rgb((16, 24), 2)[..., 0], quality=75))),
        "refused_hierarchical.jpg": ("hierarchical (SOF5 after DHP, refused)",
                                     _sof_patched(baseline, 0xC5, b"\xff\xde" + frame)),
        "refused_arith_lossless.jpg": ("arithmetic lossless (SOF11, refused)",
                                       lossless_jpeg(gray, 1, marker=0xCB)),
        "refused_fractional.jpg": ("sampling ratios not whole (3x1 luma, 2x1 chroma, refused)",
                                   sampling_patched(baseline, [(3, 1), (2, 1), (1, 1)])),
    })
    return out


def other_formats() -> dict:
    """BMP, TGA, PNM, TIFF and GIF files of every kind the readers take,
    and the 2048 x 1536 atlas as TGA and TIFF-LZW."""
    from PIL import Image

    def pil(image, fmt, **kw):
        buf = io.BytesIO()
        image.save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(30)
    rgb = seeded_rgb((37, 53), 31)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (37, 53, 1)).astype(np.uint8)], -1)
    im = Image.fromarray(rgb)
    p = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=40)
    gray = Image.fromarray(rgb[..., 0])
    idx16 = rng.integers(0, 16, (29, 35)).astype(np.uint8)
    idx16[:, 10:20] = 7                                 # runs for RLE4
    pal16 = rng.integers(0, 256, (16, 3))
    idx256 = rng.integers(0, 256, (31, 45)).astype(np.uint8)
    idx256[5:20, 3:30] = 200
    pal256 = rng.integers(0, 256, (256, 3))
    out = {
        "bmp_rgb24.bmp": ("BMP 24-bit", pil(im, "BMP")),
        "bmp_p8.bmp": ("BMP 8-bit palette", pil(p, "BMP")),
        "bmp_l8.bmp": ("BMP 8-bit gray ramp (L)", pil(gray, "BMP")),
        "bmp_1bit.bmp": ("BMP 1-bit black and white (1)", pil(gray.convert("1"), "BMP")),
        "bmp_rgba32.bmp": ("BMP 32-bit BI_RGB (alpha byte ignored)",
                           pil(Image.fromarray(rgba), "BMP")),
        "bmp_rle8.bmp": ("BMP RLE8", bmp_file(bmp_rle8(idx256), 45, 31, 8, compression=1,
                                              palette=pal256)),
        "bmp_rle4.bmp": ("BMP RLE4", bmp_file(bmp_rle4(idx16), 35, 29, 4, compression=2,
                                              palette=pal16)),
        "bmp_p4_topdown.bmp": ("BMP 4-bit palette, top-down",
                               bmp_file(_top_down(bmp_rows(idx16, 4), 29), 35, 29, 4,
                                        palette=pal16, top_down=True)),
        "bmp_os2_p1.bmp": ("BMP OS/2 1.x header, 1-bit palette",
                           bmp_file(bmp_rows(idx16 & 1, 1), 35, 29, 1, palette=pal16[:2],
                                    header=12)),
        "bmp_rgb555.bmp": ("BMP 16-bit 5-5-5", bmp_file(bmp_rows(_rgb16(rgb, 5), 16), 53, 37, 16)),
        "bmp_bitfields565.bmp": ("BMP BI_BITFIELDS 16-bit 5-6-5",
                                 bmp_file(bmp_rows(_rgb16(rgb, 6), 16), 53, 37, 16, compression=3,
                                          masks=(0xF800, 0x7E0, 0x1F), header=52)),
        "bmp_bitfields32_bgra.bmp": ("BMP BI_BITFIELDS 32-bit with alpha (RGBA), V4 header",
                                     bmp_file(bmp_rows(rgba[..., [2, 1, 0, 3]], 32), 53, 37, 32,
                                              compression=3, header=108,
                                              masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))),
        "tga_rgb24.tga": ("TGA type 2, 24-bit", pil(im, "TGA")),
        "tga_rgba32_rle.tga": ("TGA type 10, 32-bit", pil(Image.fromarray(rgba), "TGA",
                                                          compression="tga_rle")),
        "tga_l8.tga": ("TGA type 3, 8-bit gray", pil(gray, "TGA")),
        "tga_la16.tga": ("TGA type 3, 16-bit gray and alpha",
                         pil(Image.fromarray(rgba[..., [0, 3]], "LA"), "TGA")),
        "tga_p8.tga": ("TGA type 1, 24-bit colour map", pil(p, "TGA")),
        "tga_p8_rle.tga": ("TGA type 9", pil(p, "TGA", compression="tga_rle")),
        "tga_l8_rle.tga": ("TGA type 11", pil(gray, "TGA", compression="tga_rle")),
        "tga_rgb16.tga": ("TGA type 2, 16-bit 5-5-5 with an alpha bit, top-left origin",
                          tga_file(2, 53, 37, 16, _rgb16(rgb, 5, alpha=rgba[..., 3] > 127)
                                   .astype("<u2").tobytes(), origin=0x20, alpha_bits=1)),
        "tga_cmap16_right.tga": ("TGA type 1, 16-bit colour map from entry 3, bottom-right "
                                 "origin, an image id",
                                 tga_file(1, 35, 29, 8, (idx16 + 3).astype(np.uint8).tobytes(),
                                          cmap=_rgb16(pal16[None], 5)[0].astype("<u2").tobytes(),
                                          cmap_start=3, cmap_len=16, cmap_depth=16, origin=0x10,
                                          image_id=b"seeded")),
        "refused_tga_cmap32_rle.tga": ("TGA type 9, 32-bit colour map (refused: PIL has no "
                                       "BGRA palette mode)",
                               tga_file(9, 45, 31, 8, tga_rle(idx256, 1), origin=0x30,
                                        cmap=np.concatenate([pal256[:, ::-1],
                                                             np.full((256, 1), 255)], 1)
                                        .astype(np.uint8).tobytes(),
                                        cmap_len=256, cmap_depth=32)),
        "tga_rgb24_rle_across.tga": ("TGA type 10, 24-bit, literal packets across rows",
                                     tga_file(10, 53, 37, 24, tga_rle(
                                         rgb[::-1, :, ::-1].reshape(37, -1), 3, across_rows=True))),
        "pbm_plain.pbm": ("PBM P1, plain", _pnm(b"P1", 35, 29, None, " ".join(
            "".join(str(1 - b) for b in row) for row in (idx16 > 7).astype(int)).encode())),
        "pbm_raw.pbm": ("PBM P4", pil(gray.convert("1"), "PPM")),
        "pgm_raw.pgm": ("PGM P5, maxval 255", pil(gray, "PPM")),
        "pgm_maxval100.pgm": ("PGM P5, maxval 100 (scaled as Pillow)",
                              _pnm(b"P5", 53, 37, 100, (rgb[..., 0] * 100 // 255).astype(np.uint8)
                                   .tobytes())),
        "pgm_16bit.pgm": ("PGM P5, 16-bit maxval 65535 (mode I)",
                          _pnm(b"P5", 53, 37, 65535, (rgb[..., 0].astype(np.uint32) * 257)
                               .astype(">u2").tobytes())),
        "pgm_plain_maxval1000.pgm": ("PGM P2, plain, maxval 1000 (mode I), comments",
                                     _pnm(b"P2", 35, 29, 1000, "\n".join(
                                         " ".join(str(int(v) * 62) for v in row)
                                         for row in idx16).encode(), comment=True)),
        "ppm_raw.ppm": ("PPM P6, maxval 255", pil(im, "PPM")),
        "ppm_plain.ppm": ("PPM P3, plain, maxval 255", _pnm(b"P3", 53, 37, 255, " ".join(
            str(v) for v in rgb.reshape(-1)).encode())),
        "ppm_12bit.ppm": ("PPM P6, 16-bit samples, maxval 4095 (scaled to 8 bits)",
                          _pnm(b"P6", 53, 37, 4095, (rgb.astype(np.uint32) * 4095 // 255)
                               .astype(">u2").tobytes())),
        "tiff_rgb_none.tif": ("TIFF RGB, uncompressed", pil(im, "TIFF")),
        "tiff_rgb_lzw.tif": ("TIFF RGB, LZW", pil(im, "TIFF", compression="tiff_lzw")),
        "tiff_rgb_deflate.tif": ("TIFF RGB, Deflate", pil(im, "TIFF",
                                                         compression="tiff_adobe_deflate")),
        "tiff_rgb_packbits.tif": ("TIFF RGB, PackBits", pil(im, "TIFF", compression="packbits")),
        "tiff_rgba_lzw.tif": ("TIFF RGBA, LZW", pil(Image.fromarray(rgba), "TIFF",
                                                    compression="tiff_lzw")),
        "tiff_la.tif": ("TIFF LA", pil(Image.fromarray(rgba[..., [0, 3]], "LA"), "TIFF")),
        "tiff_l_lzw.tif": ("TIFF L, LZW", pil(gray, "TIFF", compression="tiff_lzw")),
        "tiff_1bit.tif": ("TIFF 1-bit", pil(gray.convert("1"), "TIFF")),
        "tiff_p_lzw.tif": ("TIFF palette, LZW", pil(p, "TIFF", compression="tiff_lzw")),
        "tiff_cmyk.tif": ("TIFF CMYK", pil(im.convert("CMYK"), "TIFF")),
        "tiff_i16.tif": ("TIFF 16-bit gray (I;16)",
                         pil(Image.fromarray(rgb[..., 0].astype(np.uint16) * 257), "TIFF")),
        "tiff_rgb_tiled_deflate_pred.tif": ("TIFF RGB, 16x16 tiles, Deflate, predictor 2",
                                            tiff_file(rgb, (8, 8, 8), 2, compression=8,
                                                      predictor=2, tile=(16, 16))),
        "tiff_l_tiled_packbits_be.tif": ("TIFF L, 16x32 tiles, PackBits, big-endian",
                                         tiff_file(rgb[..., 1:2], (8,), 1, compression=32773,
                                                   tile=(16, 32), big_endian=True)),
        "tiff_rgba_assoc_strips.tif": ("TIFF RGBA with associated alpha, strips of 5 rows, "
                                       "Deflate", tiff_file(_premultiply(rgba), (8, 8, 8, 8), 2,
                                                            compression=8, rows_per_strip=5,
                                                            extra=(1,))),
        "tiff_p4_whiteiszero.tif": ("TIFF 4-bit gray, white is zero",
                                    tiff_file(_pack4(idx16), (4,), 0, width=35)),
        "gif_p.gif": ("GIF palette, interlaced (Pillow's default)", pil(p, "GIF")),
        "gif_l.gif": ("GIF gray ramp (L)", pil(gray, "GIF")),
        "gif_small.gif": ("GIF under 16 rows (not interlaced)",
                          pil(Image.fromarray(rgb[:12]).convert("P", palette=Image.Palette.ADAPTIVE),
                              "GIF")),
        "gif_transparent.gif": ("GIF with a transparent index",
                                pil(p, "GIF", transparency=int(np.asarray(p)[0, 0]))),
        "gif_animated.gif": ("GIF, 5 frames written by coma_tpu's PIL call (delta frames)",
                             _pil_animation(step_video_frames(5, 32, 64, 33))),
        "refused_tga_rle_1bit.tga": ("TGA type 11 at 1 bit (refused)",
                                     pil(gray.convert("1"), "TGA", compression="tga_rle")),
        "refused_tga_run_across.tga": ("TGA run-length run across a row end (refused)",
                                       tga_file(11, 4, 2, 8, b"\x87\x05")),
        "refused_bmp_depth.bmp": ("BMP 2-bit (refused)",
                                  bmp_file(bmp_rows(idx16 & 3, 2), 35, 29, 2, palette=pal16[:4])),
        "refused_gif_no_image.gif": ("GIF without an image (refused)",
                                     b"GIF89a" + bytes(7) + b"\x3b"),
        "refused_ppm_maxval.ppm": ("PPM maxval 0 (refused)", _pnm(b"P6", 2, 2, 0, bytes(12))),
    }
    atlas = texture_atlas(9)
    out["atlas_rle_2048x1536.tga"] = ("2048 x 1536 atlas, TGA type 10",
                                      pil(Image.fromarray(atlas), "TGA", compression="tga_rle"))
    out["atlas_lzw_2048x1536.tif"] = ("2048 x 1536 atlas, TIFF LZW, predictor 2",
                                      pil(Image.fromarray(atlas), "TIFF", compression="tiff_lzw",
                                          tiffinfo={317: 2}))
    return out


def _top_down(rows: bytes, height: int) -> bytes:
    """Bottom-up padded rows in top-down order."""
    stride = len(rows) // height
    return b"".join(rows[(height - 1 - y) * stride:(height - y) * stride] for y in range(height))


def _rgb16(rgb: np.ndarray, green_bits: int, alpha=None) -> np.ndarray:
    """(H, W, 3) -> 16-bit 5-5-5 (``green_bits`` 5, with ``alpha`` in bit 15)
    or 5-6-5 words, red highest."""
    c = rgb.astype(np.uint32)
    r, g, b = c[..., 0] >> 3, c[..., 1] >> (8 - green_bits), c[..., 2] >> 3
    word = r << (5 + green_bits) | g << 5 | b
    if alpha is not None:
        word |= np.where(alpha, 0, 1 << 15).astype(np.uint32)
    return word.astype(np.uint16)


def _pnm(magic: bytes, width: int, height: int, maxval, body: bytes, comment=False) -> bytes:
    head = magic + (b"\n# seeded fixture\n" if comment else b"\n")
    head += f"{width} {height}\n".encode()
    if maxval is not None:
        head += (b"# maxval next\n" if comment else b"") + f"{maxval}\n".encode()
    return head + body + (b"\n" if magic in (b"P1", b"P2", b"P3") else b"")


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    c = rgba.astype(np.uint32)
    out = c.copy()
    out[..., :3] = c[..., :3] * c[..., 3:] // 255
    return out.astype(np.uint8)


def _pack4(idx: np.ndarray) -> np.ndarray:
    """(H, W) 4-bit levels -> (H, ceil(W / 2)) bytes, high nibble first."""
    padded = np.pad(idx, ((0, 0), (0, idx.shape[1] % 2)))
    return (padded[:, 0::2] << 4 | padded[:, 1::2]).astype(np.uint8)


def _pil_animation(frames: np.ndarray) -> bytes:
    """``coma_tpu/visualization/video.write_gif``'s PIL call, to bytes."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    imgs[0].save(buf, "GIF", save_all=True, append_images=imgs[1:], duration=125, loop=0)
    return buf.getvalue()


def step_video_entry() -> dict:
    """Pillow's decoding of ``coma_tpu``'s GIF of the seeded step-video
    frames: every frame in RGB, stacked, hashed; the durations and loop."""
    from PIL import Image

    with Image.open(io.BytesIO(_pil_animation(step_video_frames(**STEP_VIDEO)))) as im:
        frames, durations = [], []
        for k in range(im.n_frames):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB")))
            durations.append(im.info.get("duration"))
        loop = im.info.get("loop")
    stack = np.stack(frames)
    return dict(STEP_VIDEO, decoded_shape=list(stack.shape), durations=durations, loop=loop,
                sha256=array_sha(stack))


def main() -> int:
    try:
        import PIL
        from PIL import Image, features
    except ImportError:
        print("make_image_fixtures: needs Pillow", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    entries = []
    for name, (kind, data) in fixtures().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as fh:
            fh.write(data)
        entry = dict(file=name, kind=kind, bytes=len(data))
        try:
            with Image.open(path) as im:
                own = np.asarray(im)
                arrays = {"None": own, "RGB": np.asarray(im.convert("RGB")),
                          "L": np.asarray(im.convert("L"))}
                entry.update(mode=im.mode, shape=list(own.shape), dtype=str(own.dtype),
                             sha256={m: array_sha(a) for m, a in arrays.items()})
        except (OSError, SyntaxError, ValueError) as err:
            entry.update(raises=True, pillow_error=f"{type(err).__name__}: {err}")
        entries.append(entry)
    manifest = dict(pillow=PIL.__version__, libjpeg_turbo=features.version("libjpeg_turbo"),
                    files=entries, step_video=step_video_entry())
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    total = sum(e["bytes"] for e in entries)
    print(f"wrote {len(entries)} fixtures, {total} bytes, under {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
