#!/usr/bin/env python3
"""Write the image fixtures of ``tests/data/images/`` and their manifest.

    python3 tools/make_image_fixtures.py [--damaged | --only GROUP]

``--damaged`` writes only the damaged set of ``tests/data/images/damaged/``
(:func:`damaged_fixtures`: libjpeg-turbo's recovery from corrupt data and
the refusals of Pillow, libtiff and libwebp, with its own ``manifest.json``).
``--only GROUP`` writes only the files of one group, a ``*_formats``
function of this module (``--only avif_lossy_formats``), and puts their
entries into the existing manifest in place, new ones at its end, leaving
the others as they are. A whole run rewrites every file and the manifest
with the bytes that are committed: where a writer of Pillow's or its
libraries leaves memory it never wrote or the time in its output (1-bit
TGA RLE rows, libtiff's alignment byte, libavif's ``avis`` timestamps), the
tool writes the committed bytes there (:func:`tga_rle_1bit`,
:func:`tiff_pad_byte`, :func:`avis_times`).
Needs Pillow and gcc with libjpeg-turbo's headers and library (the CPU test
host has them; the card machine has neither, which is why the files and the
manifest are committed). Every image is made from a numpy seed. Pillow
writes what it can (baseline and progressive JPEGs, CMYK, BMP, TGA, PNM,
TIFF, GIF); ``tools/jpeg_fixture_writer.c``, compiled here against the
system's libjpeg-turbo 2.1.5 (``C_ARITH_CODING_SUPPORTED``), writes the
arithmetic-coded, odd-sampled, YCCK and block-smoothed JPEGs; the Python
writers below write what neither can: Adam7 PNGs, lossless (SOF3), 12-bit,
DNL and hierarchical JPEGs, RLE and bitfield BMPs, tiled and predicted
TIFFs, TIFFs in CCITT RLEW and Group 3 with EOLs, ThunderScan, tiled LZMA
and Zstandard (through the libzstd bundled with Pillow) and old-style JPEG,
and TGAs and PNMs of every type. ``manifest.json`` records, per file,
Pillow's mode, the shape and dtype of ``np.asarray(Image.open(f))`` and the
SHA-256 of it and of ``convert(m)`` for m in RGB and L (null where Pillow
refuses that conversion, as "LAB" to "L"), or ``"raises": true`` where
Pillow refuses the file (the port must refuse it too), with the
Pillow and libjpeg-turbo versions that decoded them. ``step_video`` records
the hash of Pillow's decoding of the seeded step-video frames
(:func:`step_video_frames`) written by ``coma_tpu``'s PIL call. The readers'
tests and ``chip_smoke.py`` phase 16 hold the port against these hashes.
"""
from __future__ import annotations

import gzip
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


# The 46 bytes past each packed row that Pillow's TGA RLE encoder read into
# every row of the committed ``refused_tga_rle_1bit.tga`` (it runs over a
# 1-bit row as if each pixel were a byte, so it reads past the row's seven
# packed bytes into memory it never wrote, different on every run)
TGA_1BIT_TAIL = bytes.fromhex("0000000000000000000000000000000000d10c00000000000001000000000000"
                              "0008090147000000004e00000000")


def tga_rle_1bit(image) -> bytes:
    """Pillow's TGA type 11 file of a mode "1" ``image`` (bottom-up rows,
    its TGA 2.0 footer) with each row as Pillow's encoder reads it: the
    packed bits, then :data:`TGA_1BIT_TAIL` where Pillow's read memory it
    never wrote. Pillow's own writer gives other bytes on every run."""
    packed = np.packbits(np.asarray(image), axis=1)[::-1]
    tail = np.frombuffer(TGA_1BIT_TAIL, np.uint8)[:image.width - packed.shape[1]]
    rows = np.concatenate([packed, np.broadcast_to(tail, (image.height, tail.size))], 1)
    return (tga_file(11, image.width, image.height, 1, tga_rle(rows, 1)) + bytes(8)
            + b"TRUEVISION-XFILE.\x00")


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
              colormap=None, big_endian: bool = False, width: int = 0, planar: bool = False,
              fill_order: int = 1, bigtiff: bool = False, chunks=None, tags=None) -> bytes:
    """A one-page TIFF of (H, W, C) byte samples (or packed (H, row bytes)
    rows of ``width`` pixels for bits below 8), in strips or ``tile`` =
    (w, h) tiles, compressed with none (1), Deflate (8) or PackBits (32773),
    with horizontal differencing (predictor 2); ``planar`` stores each
    sample in planes of its own (planar configuration 2), ``fill_order`` 2
    reverses the bits of every stored byte, ``bigtiff`` writes the BigTIFF
    header and 8-byte offsets. ``chunks`` gives the stored strips or tiles
    as they are (a JPEG's, compression 7) and ``tags`` more entries: tag ->
    (type, values), type 7 (undefined) taking bytes and type 5 (rational)
    (numerator, denominator) pairs."""
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
            raw = zlib.compress(raw, 9)
        elif compression == 32773:
            raw = _packbits(raw, b.shape[1] * b.shape[2] if b.ndim == 3 else b.shape[1])
        if fill_order == 2:
            raw = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(-1, 8)[:, ::-1]
            raw = np.packbits(raw.reshape(-1)).tobytes()
        return raw

    planes = [px[..., c:c + 1] for c in range(px.shape[2])] if planar else [px]
    if chunks is None:
        chunks = []
        for plane in planes:
            if tile:
                tw, th = tile
                for ty in range(0, H, th):
                    for tx in range(0, W, tw):
                        block = np.zeros((th, tw, plane.shape[2]), np.uint8)
                        part = plane[ty:ty + th, tx:tx + tw]
                        block[:part.shape[0], :part.shape[1]] = part
                        chunks.append(encode(block))
            else:
                rps = rows_per_strip or H
                chunks += [encode(plane[y:y + rps]) for y in range(0, H, rps)]
    entries = {256: (4, [W]), 257: (4, [H]), 258: (3, list(bits)), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
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
    entries.update(tags or {})
    word, head = (8, 16) if bigtiff else (4, 8)
    if bigtiff:
        data = bytearray((b"MM\x00+" if big_endian else b"II+\x00") + struct.pack(o + "HH", 8, 0)
                         + bytes(8))
    else:
        data = bytearray((b"MM\x00*" if big_endian else b"II*\x00") + b"\x00" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + (b"\x00" if len(c) % 2 else b"")
    entries[324 if tile else 273] = (16 if bigtiff else 4, offsets)
    entries[325 if tile else 279] = (16 if bigtiff else 4, [len(c) for c in chunks])
    blobs = bytearray()
    ifd_at = len(data)
    n = len(entries)
    size = 20 if bigtiff else 12
    table = bytearray(struct.pack(o + ("Q" if bigtiff else "H"), n))
    blob_at = ifd_at + (8 if bigtiff else 2) + size * n + word
    for tag in sorted(entries):
        kind, values = entries[tag]
        if kind == 7:
            packed = bytes(values)
        elif kind == 5:                    # rationals: (numerator, denominator) pairs
            packed = struct.pack(o + "II" * len(values), *(v for pair in values for v in pair))
        else:
            packed = struct.pack(o + {3: "H", 4: "I", 16: "Q"}[kind] * len(values), *values)
        count = len(packed) if kind == 7 else len(values)
        fmt = o + ("HHQ" if bigtiff else "HHI")
        if len(packed) <= word:
            table += struct.pack(fmt, tag, kind, count) + packed.ljust(word, b"\x00")
        else:
            table += struct.pack(fmt, tag, kind, count) + struct.pack(
                o + ("Q" if bigtiff else "I"), blob_at + len(blobs))
            blobs += packed + (b"\x00" if len(packed) % 2 else b"")
    table += bytes(word)
    data += table + blobs
    data[head - word:head] = struct.pack(o + ("Q" if bigtiff else "I"), ifd_at)
    return bytes(data)


def jpeg_tiff(writer, pixels: np.ndarray, rows_per_strip: int, sampling: str = "2x2,1x1,1x1",
              quality: int = 80) -> bytes:
    """A YCbCr (photometric 6) TIFF with JPEG compression (7) as libtiff
    writes one: each strip a JPEG of its own rows written by libjpeg
    (``writer``, a :class:`LibjpegWriter`) at ``sampling``, its quantisation
    and Huffman tables moved into the JPEGTables tag and the strips left
    abbreviated."""
    strips = [writer(pixels[y:y + rows_per_strip], space="ycc", quality=quality,
                     sampling=sampling) for y in range(0, pixels.shape[0], rows_per_strip)]
    tables, stripped = b"", []
    for k, jpg in enumerate(strips):
        pos, keep = 2, bytearray(b"\xff\xd8")
        while True:
            marker, length = jpg[pos + 1], int.from_bytes(jpg[pos + 2:pos + 4], "big")
            segment = jpg[pos:pos + 2 + length]
            if marker in (0xDB, 0xC4):
                if k == 0:
                    tables += segment
            elif marker != 0xE0:
                keep += segment
            pos += 2 + length
            if marker == 0xDA:
                keep += jpg[pos:]
                break
        stripped.append(bytes(keep))
    h, v = (int(x) for x in sampling.split(",")[0].split("x"))
    return tiff_file(pixels, (8, 8, 8), 6, compression=7, rows_per_strip=rows_per_strip,
                     chunks=stripped, tags={347: (7, b"\xff\xd8" + tables + b"\xff\xd9"),
                                            530: (3, [h, v])})


def tiff_pad_byte(data: bytes, value: int) -> bytes:
    """``data`` (a little-endian TIFF from Pillow's libtiff writer) with the
    byte that aligns its first IFD after the last strip set to ``value``:
    libtiff leaves it unwritten, so it differs from run to run (``value`` is
    the committed file's). No reader reads it."""
    out = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    values = {}
    for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        tag, kind, count, at = struct.unpack("<HHII", data[ifd + 2 + 12 * k:ifd + 14 + 12 * k])
        if tag not in (273, 279):                # StripOffsets, StripByteCounts
            continue
        fmt = f"<{count}{'I' if kind == 4 else 'H'}"
        size = struct.calcsize(fmt)
        values[tag] = struct.unpack(fmt, data[at:at + size] if size > 4
                                    else data[ifd + 10 + 12 * k:ifd + 10 + 12 * k + size])
    end = max(o + n for o, n in zip(values[273], values[279]))
    assert end == ifd - 1, (end, ifd)           # one byte of alignment before the IFD
    out[end] = value
    return bytes(out)


def psd_file(planes: np.ndarray, ps_mode: int, bits: int = 8, rle: bool = False,
             color_data: bytes = b"", resources: bool = True, layer: bool = True,
             channels: int = 0) -> bytes:
    """A Photoshop file of (C, H, row bytes) composite planes in colour mode
    ``ps_mode`` (0 bitmap, 1 gray, 2 indexed, 3 RGB, 4 CMYK, 7 multichannel,
    8 duotone, 9 Lab) at ``bits``: raw or, with ``rle``, PackBits rows with
    their byte counts; ``color_data`` the colour-mode section (a 768-byte
    planar palette for mode 2), an image resource with an odd-length name
    and data, and a layer (its own raw channels) that readers of the
    composite skip. ``channels`` overrides the header's count."""
    C, H, row = planes.shape
    width = row * 8 if bits == 1 else row
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or C, H, width, bits, ps_mode)
    res = b""
    if resources:
        res = b"8BIM" + struct.pack(">H", 1005) + b"\x03abc" + struct.pack(">I", 5) + b"12345\x00"
        res += b"8BIM" + struct.pack(">H", 1039) + b"\x00\x00" + struct.pack(">I", 4) + b"icc!"
    lay = b""
    if layer:
        lw, lh = 3, 2
        rec = struct.pack(">iiiiH", 0, 0, lh, lw, 1) + struct.pack(">hI", 0, 2 + lw * lh)
        rec += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(">I", 12) + bytes(8)
        rec += b"\x03ab\x00"
        body = struct.pack(">h", 1) + rec + struct.pack(">H", 0) + bytes(range(lw * lh))
        body += bytes(len(body) % 2)
        lay = struct.pack(">I", len(body)) + body + struct.pack(">I", 0)
    if rle:
        rows = [_packbits(planes[c, y].tobytes(), row) for c in range(C) for y in range(H)]
        pixels = struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows) \
            + b"".join(rows)
    else:
        pixels = struct.pack(">H", 0) + planes.tobytes()
    return (head + struct.pack(">I", len(color_data)) + color_data + struct.pack(">I", len(res))
            + res + struct.pack(">I", len(lay)) + lay + pixels)


def dds_file(width: int, height: int, body: bytes, fourcc: bytes = b"", dxgi: int = 0,
             pfflags: int = 0, bitcount: int = 0, masks=(0, 0, 0, 0), mipmaps: int = 0) -> bytes:
    """A DDS file: the 124-byte header over ``body``, FourCC-compressed when
    ``fourcc`` is given (``b"DX10"`` with its DXGI header for ``dxgi``),
    else uncompressed with ``pfflags``, ``bitcount`` and the channel
    ``masks``. Pillow decodes any block bytes, so seeded random blocks
    reach every BC6H and BC7 mode."""
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | (0x20000 if mipmaps else 0)
    if fourcc:
        pfflags, bitcount, masks = 0x4, 0, (0, 0, 0, 0)
    head = struct.pack("<4s7I", b"DDS ", 124, flags, height, width, 0, 0, mipmaps)
    head += bytes(44) + struct.pack("<2I4sI4I", 32, pfflags, fourcc or bytes(4), bitcount, *masks)
    head += struct.pack("<5I", 0x1000 | (0x400008 if mipmaps else 0), 0, 0, 0, 0)
    if fourcc == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def bc_blocks(width: int, height: int, block_bytes: int, seed: int, first=None) -> bytes:
    """Seeded random blocks covering ``width`` x ``height``; ``first`` fixes
    the low bits of each block's first byte (a BC6H or BC7 mode)."""
    rng = np.random.default_rng(seed)
    n = -(-width // 4) * -(-height // 4)
    blocks = rng.integers(0, 256, (n, block_bytes)).astype(np.uint8)
    if first is not None:
        bits, value = first
        blocks[:, 0] = (blocks[:, 0] & ~np.uint8((1 << bits) - 1)) | value
    return blocks.tobytes()


_WEBP_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size", "target_psnr",
                "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
                "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                "show_compressed", "preprocessing", "partitions", "partition_limit",
                "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
                "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


def libwebp_encode(pixels: np.ndarray, **config) -> bytes:
    """A WebP file written by the libwebp that Pillow carries, through its
    advanced API, so that settings Pillow does not pass reach the file: the
    simple loop filter (``filter_type=0``), ``filter_sharpness``, several
    token ``partitions``, ``segments``, ``sns_strength``. ``pixels`` (H, W, 3)
    or (H, W, 4) uint8."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not found:
        raise OSError("Pillow's libwebp is not in " + libs)
    lib = ctypes.CDLL(found[0])
    cfg = (ctypes.c_int32 * 32)()
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), 0x0210):
        raise OSError("WebPConfigInit failed")
    for key, value in config.items():
        at = _WEBP_CONFIG.index(key)
        if key in ("quality", "target_psnr"):
            ctypes.c_float.from_buffer(cfg, 4 * at).value = value
        else:
            cfg[at] = value
    pic = (ctypes.c_uint8 * 256)()                  # WebPPicture: 256 bytes on x86-64
    writer = (ctypes.c_uint64 * 4)()                # WebPMemoryWriter
    if not lib.WebPPictureInitInternal(pic, 0x0210):
        raise OSError("WebPPictureInit failed")
    H, W, C = pixels.shape
    ctypes.c_int32.from_buffer(pic, 0).value = int(config.get("lossless", 0))   # use_argb
    ctypes.c_int32.from_buffer(pic, 8).value = W
    ctypes.c_int32.from_buffer(pic, 12).value = H
    lib.WebPMemoryWriterInit(writer)
    ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite,
                                                             ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
    px = np.ascontiguousarray(pixels, np.uint8)
    importer = lib.WebPPictureImportRGBA if C == 4 else lib.WebPPictureImportRGB
    if not importer(pic, px.ctypes.data_as(ctypes.c_void_p), W * C):
        raise OSError("WebPPictureImport failed")
    ok = lib.WebPEncode(cfg, pic)
    data = ctypes.string_at(writer[0], writer[1]) if ok else b""
    lib.WebPPictureFree(pic)
    lib.WebPMemoryWriterClear(writer)
    if not ok:
        raise OSError(f"WebPEncode failed with error {ctypes.c_int32.from_buffer(pic, 136).value}")
    return data


def webp_animation(canvas: tuple, frames: list, alpha: bool = True) -> bytes:
    """An animated WebP (VP8X, ANIM, ANMF) of (x, y, still WebP file) frames
    on a ``canvas`` = (width, height): each frame's image chunks (ALPH, VP8
    or VP8L) moved into an ANMF at its offset (even, as the format needs)."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    body = chunk(b"VP8X", struct.pack("<B3x", 0x02 | (0x10 if alpha else 0))
                 + (canvas[0] - 1).to_bytes(3, "little") + (canvas[1] - 1).to_bytes(3, "little"))
    body += chunk(b"ANIM", struct.pack("<IH", 0, 0))
    for x, y, still in frames:
        pos, inner, size = 12, b"", None
        while pos + 8 <= len(still):
            kind, n = still[pos:pos + 4], struct.unpack_from("<I", still, pos + 4)[0]
            if kind == b"VP8X":
                size = (int.from_bytes(still[pos + 12:pos + 15], "little") + 1,
                        int.from_bytes(still[pos + 15:pos + 18], "little") + 1)
            elif kind in (b"ALPH", b"VP8 ", b"VP8L"):
                inner += chunk(kind, still[pos + 8:pos + 8 + n])
                if kind == b"VP8 ":
                    size = size or (int.from_bytes(still[pos + 14:pos + 16], "little") & 0x3FFF,
                                    int.from_bytes(still[pos + 16:pos + 18], "little") & 0x3FFF)
                elif kind == b"VP8L":
                    bits = int.from_bytes(still[pos + 9:pos + 13], "little")
                    size = ((bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1)
            pos += 8 + n + (n & 1)
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
        head += (size[0] - 1).to_bytes(3, "little") + (size[1] - 1).to_bytes(3, "little")
        head += (100).to_bytes(3, "little") + b"\x00"
        body += chunk(b"ANMF", head + inner)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def alpha_filter(levels: np.ndarray, method: int) -> np.ndarray:
    """WebP's alpha filters forward (1 horizontal, 2 vertical, 3 gradient):
    each level less its prediction, modulo 256, the first row predicted from
    the left (0 before it), the first column from above."""
    a = levels.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    else:
        pred[:] = 0
    return ((a - pred) & 0xFF).astype(np.uint8)


def webp_with_alpha(lossy: bytes, alpha: np.ndarray, method: int) -> bytes:
    """A VP8X WebP of a simple lossy file's ``VP8 `` chunk and a raw (not
    lossless-coded) ``ALPH`` chunk of ``alpha`` under filter ``method``."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    H, W = alpha.shape
    vp8 = lossy[12:]                                # the VP8 chunk of a simple file
    body = chunk(b"VP8X", struct.pack("<B3x", 0x10) + (W - 1).to_bytes(3, "little")
                 + (H - 1).to_bytes(3, "little"))
    body += chunk(b"ALPH", bytes([method << 2]) + alpha_filter(alpha, method).tobytes()) + vp8
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


class _BoolWriter:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def literal(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put(128, (value >> k) & 1)

    def signed(self, value: int, n: int) -> None:
        self.literal(abs(value), n)
        self.put(128, int(value < 0))

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_header_rewrite(still: bytes, ref_delta: int = 0, mode_delta: int = 0) -> bytes:
    """A simple lossy WebP file with its VP8 frame header written again: the
    segments' quantisers and filter levels as deltas from the frame's (where
    libwebp writes them absolute) and loop-filter deltas for the reference
    frame and the 4x4 mode (which libwebp's encoder never writes). The first
    partition's bits are read back through ``coma_tpu_torch.utils.vp8`` and
    re-encoded; the token partitions are kept as they are."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from coma_tpu_torch.utils import vp8

    payload = still[20:20 + struct.unpack_from("<I", still, 16)[0]]
    made = []

    class Recording(vp8.BoolDecoder):
        def __init__(self, *args):
            super().__init__(*args)
            self.bits = []
            made.append(self)

        def bit(self, prob):
            b = super().bit(prob)
            self.bits.append((prob, b))
            return b

    plain = vp8.BoolDecoder
    vp8.BoolDecoder = Recording
    try:
        vp8.decode(payload)
    finally:
        vp8.BoolDecoder = plain
    records = made[0].bits
    pos = 0

    def take(n: int) -> int:
        nonlocal pos
        v = 0
        for _ in range(n):
            v = v << 1 | records[pos][1]
            pos += 1
        return v

    def signed(n: int) -> int:
        v = take(n)
        return -v if take(1) else v

    head = take(2)
    seg = dict(use=take(1))
    if seg["use"]:
        seg["update_map"], seg["update_data"] = take(1), take(1)
        if seg["update_data"]:
            seg["absolute"] = take(1)
            seg["q"] = [signed(7) if take(1) else 0 for _ in range(4)]
            seg["f"] = [signed(6) if take(1) else 0 for _ in range(4)]
        if seg["update_map"]:
            seg["probs"] = [take(8) if take(1) else None for _ in range(3)]
    simple, level, sharpness = take(1), take(6), take(3)
    if take(1) and take(1):
        for _ in range(8):
            if take(1):
                signed(6)
    parts = take(2)
    base = take(7)
    dq = [signed(4) if take(1) else None for _ in range(5)]
    w = _BoolWriter()
    w.literal(head, 2)
    w.literal(seg["use"], 1)
    if seg["use"]:
        w.literal(seg["update_map"], 1)
        w.literal(seg["update_data"], 1)
        if seg["update_data"]:
            relative = seg["absolute"] == 1
            w.literal(0 if relative else seg["absolute"], 1)
            for values, ref, n in ((seg["q"], base, 7), (seg["f"], level, 6)):
                for v in values:
                    d = v - ref if relative else v
                    w.literal(int(d != 0), 1)
                    if d:
                        w.signed(d, n)
        if seg["update_map"]:
            for p in seg["probs"]:
                w.literal(int(p is not None), 1)
                if p is not None:
                    w.literal(p, 8)
    w.literal(simple, 1)
    w.literal(level, 6)
    w.literal(sharpness, 3)
    w.literal(1, 1)                                  # loop-filter deltas on, updated
    w.literal(1, 1)
    for deltas in ([ref_delta, 0, 0, 0], [mode_delta, 0, 0, 0]):
        for d in deltas:
            w.literal(int(d != 0), 1)
            if d:
                w.signed(d, 6)
    w.literal(parts, 2)
    w.literal(base, 7)
    for d in dq:
        w.literal(int(d is not None), 1)
        if d is not None:
            w.signed(d, 4)
    for prob, bit in records[pos:]:                  # probabilities and macroblock modes
        w.put(prob, bit)
    first = w.flush()
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    old_size = tag >> 5
    tag = (tag & 0x1F) | len(first) << 5
    frame = bytes([tag & 0xFF, tag >> 8 & 0xFF, tag >> 16]) + payload[3:10] + first + \
        payload[10 + old_size:]
    body = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def bc7_mode6(rgba: np.ndarray) -> bytes:
    """A simple BC7 encoder (mode 6 for every block: one subset, 7-bit RGBA
    endpoints with a p-bit each, 4-bit indices by projection onto the
    endpoints' line), for the textures Pillow cannot write as BC7. (H, W, 4)
    uint8, H and W multiples of 4 -> the blocks."""
    H, W, _ = rgba.shape
    blocks = rgba.reshape(H // 4, 4, W // 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    px = blocks.astype(np.int64)
    lo, hi = px.min(1) >> 1, np.minimum((px.max(1) + 1) >> 1, 127)
    e0, e1 = lo << 1, hi << 1 | 1                   # p-bits 0 and 1
    d = e1 - e0
    span = np.maximum((d * d).sum(1), 1)
    t = ((px - e0[:, None]) * d[:, None]).sum(2)
    idx = np.clip((t * 15 + span[:, None] // 2) // span[:, None], 0, 15)
    swap = idx[:, 0] >= 8                           # the anchor index's top bit must be 0
    idx = np.where(swap[:, None], 15 - idx, idx)
    q0, q1 = np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)
    p0, p1 = np.where(swap, 1, 0), np.where(swap, 0, 1)
    fields = [(np.full(len(px), 1 << 6), 7)]
    for c in range(4):
        fields += [(q0[:, c], 7), (q1[:, c], 7)]
    fields += [(p0, 1), (p1, 1), (idx[:, 0], 3)] + [(idx[:, k], 4) for k in range(1, 16)]
    lo_word = np.zeros(len(px), np.uint64)
    hi_word = np.zeros(len(px), np.uint64)
    bit = 0
    for value, n in fields:
        v = value.astype(np.uint64)
        for b in range(n):                          # bit by bit across the two words
            word_bit = (v >> np.uint64(b)) & np.uint64(1)
            if bit < 64:
                lo_word |= word_bit << np.uint64(bit)
            else:
                hi_word |= word_bit << np.uint64(bit - 64)
            bit += 1
    assert bit == 128
    return np.stack([lo_word, hi_word], 1).astype("<u8").tobytes()


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


def sgi_rle_row(samples: np.ndarray) -> bytes:
    """SGI run-length packets of one channel's row (uint8, or uint16 written
    big-endian with 16-bit packet headers): runs of 3 or more equal samples,
    literals of at most 127, and the terminating 0."""
    wide = samples.dtype.itemsize == 2
    word = (lambda v: struct.pack(">H", v)) if wide else (lambda v: bytes([v]))
    vals, out, i = samples.tolist(), bytearray(), 0
    while i < len(vals):
        j = i
        while j < len(vals) and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            out += word(j - i) + word(vals[i])
            i = j
            continue
        j = i + 1
        while j < len(vals) and j - i < 127 and not vals[j:j + 3] == [vals[j]] * 3:
            j += 1
        out += word(0x80 | (j - i)) + b"".join(word(v) for v in vals[i:j])
        i = j
    return bytes(out + word(0))


def sgi_file(planes: np.ndarray, rle: bool = False, dimension: int = 0) -> bytes:
    """An SGI file of (Z, H, W) uint8 or uint16 samples (top row first; SGI
    stores rows bottom-up), verbatim or run-length coded with the offset
    and length tables (rows with equal data share it)."""
    z, h, w = planes.shape
    bpc = planes.dtype.itemsize
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll4s80sl", 474, int(rle), bpc, dimension, w, h, z, 0,
                       (1 << 8 * bpc) - 1, b"", b"seeded fixture", 0).ljust(512, b"\0")
    rows = planes[:, ::-1].astype(">u2" if bpc == 2 else np.uint8)
    if not rle:
        return head + rows.tobytes()
    body, seen, starts, lengths = bytearray(), {}, [], []
    base = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            packed = sgi_rle_row(planes[c, h - 1 - y])
            if packed not in seen:
                seen[packed] = base + len(body)
                body += packed
            starts.append(seen[packed])
            lengths.append(len(packed))
    return head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths) + body


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX run-length of (H, row bytes) scanlines: runs of up to 63, a byte
    of 0xC0 or more always as a run."""
    out = bytearray()
    for line in rows.tolist():
        i = 0
        while i < len(line):
            j = i
            while j < len(line) and j - i < 63 and line[j] == line[i]:
                j += 1
            if j - i > 1 or line[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), line[i]])
            else:
                out.append(line[i])
            i = j
    return bytes(out)


def pcx_file(rows: np.ndarray, width: int, height: int, bits: int, planes: int,
             version: int = 5, stride: int = 0, palette16: bytes = b"",
             palette256: bytes = b"", origin: tuple = (0, 0)) -> bytes:
    """A PCX file of (H, planes * stride) scanlines, the inclusive box at
    ``origin``, the header's stride ``stride`` (0: the rows' own), an
    optional 16-colour header palette and 0x0C-marked 256-colour one."""
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + width - 1,
                       y0 + height - 1, 72, 72)
    head += palette16.ljust(48, b"\0")[:48] + bytes([0, planes])
    head += struct.pack("<HH", stride or rows.shape[1] // planes, 1)
    body = pcx_rle(rows)
    tail = b"\x0c" + palette256 if palette256 else b""
    return head.ljust(128, b"\0") + body + tail


def dcx_file(pages: list) -> bytes:
    """An Intel DCX file of PCX pages."""
    offsets, at = [], 4 + 4 * (len(pages) + 1)
    for page in pages:
        offsets.append(at)
        at += len(page)
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(pages)


def sun_rle(stream: bytes) -> bytes:
    """Sun raster run-length of a byte stream: runs of 3 to 256 as 0x80 n-1
    v, a lone 0x80 as 0x80 0x00, other bytes as themselves."""
    out, i = bytearray(), 0
    while i < len(stream):
        j = i
        while j < len(stream) and j - i < 256 and stream[j] == stream[i]:
            j += 1
        if j - i >= 3 or stream[i] == 0x80 and j - i > 1:
            out += bytes([0x80, j - i - 1, stream[i]])
        elif stream[i] == 0x80:
            out += b"\x80\x00"
            j = i + 1
        else:
            out.append(stream[i])
            j = i + 1
        i = j
    return bytes(out)


def sun_file(rows: np.ndarray, width: int, depth: int, kind: int = 1,
             colour_map: bytes = b"") -> bytes:
    """A Sun raster file of (H, ceil(width * depth / 8)) rows: raw (rows
    padded to 16 bits) or, for ``kind`` 2, the unpadded stream run-length
    coded, as PIL reads it."""
    height = rows.shape[0]
    if kind == 2:
        body = sun_rle(rows.tobytes())
    else:
        pad = (width * depth + 15) // 16 * 2 - rows.shape[1]
        body = np.pad(rows, ((0, 0), (0, pad))).tobytes()
    head = struct.pack(">8I", 0x59A66A95, width, height, depth, len(body), kind,
                       1 if colour_map else 0, len(colour_map))
    return head + colour_map + body


def msp_file(bits: np.ndarray, rle: bool = True) -> bytes:
    """A Microsoft Paint file of (H, W) bools (True white): version 2
    (``LinS``, per-row runs and literals) or 1 (``DanM``, raw)."""
    h, w = bits.shape
    rows = np.packbits(bits, axis=1)
    header = [0] * 16
    header[0], header[1] = (0x694C, 0x536E) if rle else (0x6144, 0x4D6E)
    header[2], header[3], header[4:8], header[8], header[9] = w, h, [1, 1, 1, 1], w, h
    checksum = 0
    for word in header:
        checksum ^= word
    header[12] = checksum
    head = struct.pack("<16H", *header)
    if not rle:
        return head + rows.tobytes()
    coded = []
    for line in rows.tolist():
        out, i = bytearray(), 0
        while i < len(line):
            j = i
            while j < len(line) and j - i < 255 and line[j] == line[i]:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, line[i]])
                i = j
                continue
            j = i + 1
            while j < len(line) and j - i < 255 and not line[j:j + 3] == [line[j]] * 3:
                j += 1
            out += bytes([j - i]) + bytes(line[i:j])
            i = j
        coded.append(bytes(out) if line != [255] * len(line) else b"")
    return head + struct.pack(f"<{h}H", *map(len, coded)) + b"".join(coded)


def spider_file(image: np.ndarray, big_endian: bool = True, stack: bool = False) -> bytes:
    """A SPIDER 2D image (float32), or a stack of one image, in either byte
    order: a header of 256 floats (a record of the image's width)."""
    h, w = image.shape
    order = ">" if big_endian else "<"
    words = max(256, w)
    def header(istack: int, number: int, maxim: int) -> bytes:
        t = np.zeros(words, np.float32)
        t[0], t[1], t[4], t[11] = 1, h, 1, w                   # nslice, nrow, iform, nsam
        labrec = words * 4 // (4 * w) if words * 4 % (4 * w) == 0 else words * 4 // (4 * w) + 1
        t[12], t[21], t[22] = labrec, labrec * 4 * w, 4 * w   # labrec, labbyt, lenbyt
        t[23], t[25], t[26] = istack, maxim, number
        return t.astype(order + "f4").tobytes().ljust(labrec * 4 * w, b"\0")
    pixels = image.astype(order + "f4").tobytes()
    if not stack:
        return header(0, 0, 0) + pixels
    return header(2, 0, 1) + header(0, 1, 0) + pixels


def icns_rle(plane: np.ndarray) -> bytes:
    """ICNS 24-bit run-length of one channel: runs of 3 to 130 as n + 125,
    literals of up to 128 as n - 1."""
    vals, out, i = plane.ravel().tolist(), bytearray(), 0
    while i < len(vals):
        j = i
        while j < len(vals) and j - i < 130 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, vals[i]])
            i = j
            continue
        j = i + 1
        while j < len(vals) and j - i < 128 and not vals[j:j + 3] == [vals[j]] * 3:
            j += 1
        out += bytes([j - i - 1]) + bytes(vals[i:j])
        i = j
    return bytes(out)


def icns_file(members: list) -> bytes:
    """An ICNS file of (type, data) blocks."""
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in members)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(rgb: np.ndarray, it32: bool = False) -> bytes:
    """A 24-bit ICNS member of (H, W, 3): each channel run-length coded in
    turn (``it32`` after four zero bytes)."""
    return (bytes(4) if it32 else b"") + b"".join(icns_rle(rgb[..., c]) for c in range(3))


def blp2_file(width: int, height: int, encoding: int, body: bytes, alpha_depth: int = 0,
              alpha_encoding: int = 0, palette: bytes = b"") -> bytes:
    """A BLP2 file (compression 1) whose first mip is ``body``, after a
    1024-byte BGRA palette."""
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha_depth, alpha_encoding, 0,
                                 width, height)
    offset = len(head) + 128 + 1024
    return (head + struct.pack("<16I", offset, *[0] * 15) + struct.pack("<16I", len(body),
                                                                         *[0] * 15)
            + palette.ljust(1024, b"\0")[:1024] + body)


def blp1_jpeg_file(jpeg: bytes, width: int, height: int, split: int, alpha_bits: int = 0,
                   gap: int = 0) -> bytes:
    """A BLP1 file (compression 0) whose JPEG is cut at ``split``: the shared
    header, then the first mip ``gap`` bytes later."""
    head = b"BLP1" + struct.pack("<iIIIii", 0, alpha_bits, width, height, 5, 0)
    shared = struct.pack("<I", split) + jpeg[:split]
    offset = len(head) + 128 + len(shared) + gap
    return (head + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(jpeg) - split, *[0] * 15) + shared + bytes(gap)
            + jpeg[split:])


def im_file(lines: list, body: bytes, lut: bytes = b"") -> bytes:
    """An IM file: header lines, padding to 511 bytes, 0x1A, an optional
    768-byte Lut, the pixels."""
    head = b"".join(line.encode("latin-1") + b"\r\n" for line in lines)
    return head + b"\0" * (511 - len(head)) + b"\x1a" + lut + body


# --- the formats Pillow opens through its smaller plugins (FITS, FLI/FLC,
# PhotoCD, XPM, FTEX, GBR, PIXAR, IMT, McIdas, XV thumbnails, IPTC/NAA) ---

def fits_card(text: str) -> bytes:
    return text.ljust(80).encode()


def fits_header(cards: list) -> bytes:
    """FITS header cards (``(keyword, value)`` or a whole card) and END,
    padded with spaces to 2880 bytes."""
    out = b"".join(fits_card(c if isinstance(c, str) else f"{c[0]:<8}= {c[1]:>20}")
                   for c in cards)
    return (out + fits_card("END")).ljust(-(-(len(out) + 80) // 2880) * 2880, b" ")


def fits_file(image: np.ndarray, bitpix: int, planes: int = 0, extension: bool = False) -> bytes:
    """A FITS file of ``image`` ((H, W), stored big-endian as the standard
    says, first row first) at ``bitpix`` (8, 16, 32, -32, -64); ``planes``
    makes it a cube of that many copies (NAXIS 3), ``extension`` puts the
    image in an IMAGE extension after an empty primary unit."""
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    h, w = image.shape
    cards = [("BITPIX", bitpix), ("NAXIS", 3 if planes else 2), ("NAXIS1", w), ("NAXIS2", h)]
    if planes:
        cards.append(("NAXIS3", planes))
    body = np.ascontiguousarray(np.repeat(image[None], max(planes, 1), 0).astype(dtype)).tobytes()
    body = body.ljust(-(-len(body) // 2880) * 2880, b"\0")
    if extension:
        return (fits_header([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", "T")])
                + fits_header([("XTENSION", "'IMAGE   '")] + cards) + body)
    return fits_header([("SIMPLE", "T")] + cards) + body


def fits_gzip_file(values: np.ndarray, zbitpix: int) -> bytes:
    """A FITS binary table of a GZIP_1-compressed image as Pillow's
    ``FitsGzipDecoder`` reads it: (H, W) ``values`` as 4-byte big-endian
    groups, the first row first, gzip-compressed after a one-row table."""
    h, w = values.shape
    stream = gzip.compress(values.astype(">i4").tobytes(), 9, mtime=0)
    cards = [("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8),
             ("NAXIS2", 1), ("PCOUNT", len(stream)), ("GCOUNT", 1), ("TFIELDS", 1),
             ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", zbitpix), ("ZNAXIS", 2),
             ("ZNAXIS1", w), ("ZNAXIS2", h)]
    body = (struct.pack(">ii", len(stream), 0) + stream).ljust(
        -(-(8 + len(stream)) // 2880) * 2880, b"\0")
    return (fits_header([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", "T")])
            + fits_header(cards) + body)


def fli_brun(idx: np.ndarray) -> bytes:
    """FLI BRUN (15) rows: a packet count byte, then runs (a count below 128
    and a byte) and literals (a negative count and its bytes)."""
    out = bytearray()
    for row in idx:
        packets, line, i = bytearray(), row.tobytes(), 0
        count = 0
        while i < len(line):
            j = i
            while j < len(line) and j - i < 127 and line[j] == line[i]:
                j += 1
            if j - i >= 3:
                packets += bytes([j - i, line[i]])
            else:
                j = i + 1
                while j < len(line) and j - i < 128 and line[j:j + 3] != line[j:j + 1] * 3:
                    j += 1
                packets += bytes([256 - (j - i)]) + line[i:j]
            count += 1
            i = j
        out += bytes([count & 255]) + packets
    return bytes(out)


def fli_lc(idx: np.ndarray, first: int = 0) -> bytes:
    """FLI LC (12) byte deltas over a zero image from row ``first``: per row
    a packet count, then (skip, count, bytes) literals and (skip, -count,
    byte) runs, zeros skipped."""
    rows = idx[first:]
    out = bytearray(struct.pack("<HH", first, len(rows)))
    for row in rows:
        packets, x, n = bytearray(), 0, 0
        while x < len(row):
            skip = 0
            while x < len(row) and row[x] == 0 and skip < 255:
                x, skip = x + 1, skip + 1
            if x >= len(row):
                break
            j = x
            while j < len(row) and j - x < 127 and row[j] == row[x]:
                j += 1
            if j - x >= 3:
                packets += bytes([skip, 256 - (j - x), row[x]])
            else:
                j = min(x + 1, len(row))
                while j < len(row) and j - x < 127 and row[j] != 0:
                    j += 1
                packets += bytes([skip, j - x]) + row[x:j].tobytes()
            n += 1
            x = j
        out += bytes([n]) + packets
    return bytes(out)


def fli_ss2(idx: np.ndarray, skip_first: int = 0) -> bytes:
    """FLC SS2 (7) word deltas over a zero image: per line a packet count
    word (after a line-skip word for the first line, and a last-byte word
    on an odd width), then (skip, count, words) literals and (skip,
    -count, word) runs."""
    h, w = idx.shape
    even = w - w % 2
    lines = bytearray()
    n = 0
    for y in range(skip_first, h):
        row = idx[y]
        words = bytearray()
        if y == skip_first and skip_first:
            words += struct.pack("<H", 65536 - skip_first)
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(row[-1]))
        packets, x, count = bytearray(), 0, 0
        while x < even:
            j = x
            while j + 2 <= even and j - x < 2 * 127 and row[j] == row[x] and \
                    row[j + 1] == row[x + 1]:
                j += 2
            if j - x >= 6:
                packets += bytes([0, 256 - (j - x) // 2, row[x], row[x + 1]])
            else:
                j = min(x + 2 * 127, even)
                packets += bytes([0, (j - x) // 2]) + row[x:j].tobytes()
            count += 1
            x = j
        lines += words + struct.pack("<H", count) + packets
        n += 1
    return struct.pack("<H", n) + bytes(lines)


def fli_color(palette: np.ndarray, kind: int = 4, skip: int = 0) -> bytes:
    """A COLOR256 (4) or COLOR (11, 6-bit values) chunk of one packet."""
    values = palette if kind == 4 else palette >> 2
    count = len(values)
    return struct.pack("<H", 1) + bytes([skip, count & 255]) + values.astype(np.uint8).tobytes()


def fli_file(subchunks: list, width: int, height: int, flc: bool = True, frames: int = 1,
             prefix: bytes = b"", more_frames: int = 0) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file whose first frame holds
    ``subchunks`` ((type, body) pairs), after an optional prefix chunk
    (0xF100 of ``prefix``), then ``more_frames`` empty frames."""
    def chunk(kind: int, body: bytes) -> bytes:
        body = body + (b"\0" if len(body) % 2 else b"")
        return struct.pack("<IH", 6 + len(body), kind) + body

    def frame(parts: list) -> bytes:
        body = b"".join(chunk(k, b) for k, b in parts)
        return struct.pack("<IHH", 16 + len(body), 0xF1FA, len(parts)) + bytes(8) + body

    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 0, 0xAF12 if flc else 0xAF11, frames, width, height,
                     8, 0, 5)
    pre = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix if prefix else b""
    out = bytes(head) + pre + frame(subchunks) + b"".join(frame([]) for _ in range(more_frames))
    return out[:0] + struct.pack("<I", len(out)) + out[4:]


def pcd_file(ycc: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file of (512, 768, 3) PhotoYCC samples: ``PCD_`` at 2048,
    the orientation at 3586, the base image at sector 96 in pairs of rows
    (Y, Y, C1 and C2 of the pair's 2 x 2 blocks, their top-left samples)."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    pairs = []
    for y in range(0, 512, 2):
        pairs.append(ycc[y, :, 0].tobytes() + ycc[y + 1, :, 0].tobytes()
                     + ycc[y, ::2, 1].tobytes() + ycc[y, ::2, 2].tobytes())
    return bytes(head) + b"".join(pairs)


def xpm_file(idx: np.ndarray, colours: list, bpp: int = 1, keys=None, pixels_line=False,
             rows=None) -> bytes:
    """An XPM of ``idx`` over ``colours`` (``#rrggbb`` strings, "None" or a
    name), keys of ``bpp`` characters; ``rows`` overrides the pixel lines."""
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.+@#$%&*="
    if keys is None:
        keys = ["".join(alphabet[(k // len(alphabet) ** i) % len(alphabet)] for i in range(bpp))
                for k in range(len(colours))]
    h, w = idx.shape
    lines = ["/* XPM */", "static char *seed[] = {", "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colours)} {bpp}",']
    lines += [f'"{k} c {c}",' for k, c in zip(keys, colours)]
    if pixels_line:
        lines.append("/* pixels */")
    if rows is None:
        rows = ["".join(keys[v] for v in row) for row in idx]
    lines += [f'"{r}",' for r in rows[:-1]] + [f'"{rows[-1]}"', "};"]
    return ("\n".join(lines) + "\n").encode()


def gbr_file(pixels: np.ndarray, version: int = 2, comment: bytes = b"seed") -> bytes:
    """A GIMP brush of (H, W) gray or (H, W, 4) RGBA pixels."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    body = comment + b"\0"
    if version == 1:
        return struct.pack(">5I", 20 + len(body), 1, w, h, depth) + body + pixels.tobytes()
    return (struct.pack(">5I", 28 + len(body), 2, w, h, depth) + b"GIMP"
            + struct.pack(">I", 10) + body + pixels.tobytes())


def pixar_file(rgb: np.ndarray) -> bytes:
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HHxxxxHH", head, 416, rgb.shape[0], rgb.shape[1], 14, 2)
    return bytes(head) + rgb.tobytes()


def imt_file(gray: np.ndarray, comment: bool = True) -> bytes:
    head = (b"* seeded\n" if comment else b"") + b"width %d\nheight %d\npixel n8\n" % (
        gray.shape[1], gray.shape[0])
    return head + b"\x0c" + gray.tobytes()


def mcidas_file(values: np.ndarray, nbytes: int, prefix: int = 0, bands: int = 1,
                offset: int = 256) -> bytes:
    """A McIdas area of (H, W) ``values`` at ``nbytes`` a value (big-endian),
    each row behind ``prefix`` bytes of its own, ``bands`` bands a row (the
    first the image)."""
    h, w = values.shape
    words = [0] * 64                    # PIL's w[k] is words[k - 1]
    words[1], words[8], words[9], words[10], words[13], words[14], words[33] = \
        4, h, w, nbytes, bands, prefix, offset
    dtype = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    rows = []
    for row in values.astype(dtype):
        rows.append(bytes(prefix) + row.tobytes() + bytes(row.nbytes * max(bands - 1, 0)))
    return struct.pack(">64i", *words).ljust(offset, b"\0") + b"".join(rows)


def xv_file(idx: np.ndarray) -> bytes:
    return (b"P7 332\n#XVVERSION:Version 2.28\n#IMGINFO:seeded\n#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (idx.shape[1], idx.shape[0]) + idx.tobytes())


def iptc_field(record: int, dataset: int, value: bytes) -> bytes:
    if len(value) < 0x8000:
        return b"\x1c" + bytes([record, dataset]) + struct.pack(">H", len(value)) + value
    return b"\x1c" + bytes([record, dataset]) + b"\x80\x04" + struct.pack(">I", len(value)) + value


def iptc_file(width: int, height: int, data: bytes, layers: int = 1, component: int = 0,
              compression: int = 1, band: int = 0, split: int = 0) -> bytes:
    """An IPTC/NAA file: (3, 60) layers and component, the size, the
    compression, (3, 65) ``band`` where given, then the data in (8, 10)
    fields (``split`` bytes each where given)."""
    fields = [iptc_field(2, 0, b"\x00\x04"), iptc_field(3, 60, bytes([layers, component])),
              iptc_field(3, 20, struct.pack(">H", width)),
              iptc_field(3, 30, struct.pack(">H", height)),
              iptc_field(3, 120, bytes([compression]))]
    if band:
        fields.append(iptc_field(3, 65, bytes([band])))
    step = split or len(data) or 1
    fields += [iptc_field(8, 10, data[k:k + step]) for k in range(0, len(data), step)]
    return b"".join(fields)


def ftex_file(width: int, height: int, fmt: int, body: bytes) -> bytes:
    """An FTEX of one format (0 DXT1, 1 raw RGB) and one mipmap."""
    return b"FTEX" + struct.pack("<7i", 0, width, height, 1, 1, fmt, 32) + \
        struct.pack("<i", len(body)) + body


def lzw_tiff(raw: bytes) -> bytes:
    """TIFF LZW as libtiff's encoder writes it: a clear code first, codes
    most significant bit first, the width growing when the next entry
    passes its largest code, a clear at 4094 entries, an end code."""
    bits, nbits = [], 9

    def put(code: int):
        bits.extend((code >> (nbits - 1 - k)) & 1 for k in range(nbits))

    put(256)
    table, free, w = {bytes([i]): i for i in range(256)}, 258, b""
    for c in raw:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        w = bytes([c])
        table[wc] = free
        free += 1
        if free == 4094:
            put(256)
            table, free, nbits = {bytes([i]): i for i in range(256)}, 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    if w:
        put(table[w])
        free += 1
        if free > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    bits.extend([0] * (-len(bits) % 8))
    return np.packbits(np.array(bits, np.uint8)).tobytes()


def subbyte_tiled_tiff(levels: np.ndarray, bits: int, tile: tuple, compression: int = 1,
                       photometric: int = 1, colormap=None, fill_order: int = 1) -> bytes:
    """A tiled TIFF of (H, W) ``levels`` at 1, 2 or 4 bits a pixel, each
    tile's rows packed most significant bits first and padded to a byte,
    uncompressed (1), LZW (5) or PackBits (32773); ``fill_order`` 2
    reverses every stored byte's bits."""
    h, w = levels.shape
    tw, th = tile
    row = (tw * bits + 7) // 8
    chunks = []
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            block = np.zeros((th, tw), np.uint8)
            part = levels[ty:ty + th, tx:tx + tw]
            block[:part.shape[0], :part.shape[1]] = part
            planes = np.unpackbits(block[..., None], axis=2)[..., 8 - bits:]
            packed = np.packbits(planes.reshape(th, -1), axis=1)[:, :row]
            raw = packed.tobytes()
            if fill_order == 2:
                raw = raw.translate(bytes(int(f"{b:08b}"[::-1], 2) for b in range(256)))
            if compression == 5:
                raw = lzw_tiff(raw)
            elif compression == 32773:
                raw = _packbits(raw, row)
            chunks.append(raw)
    return tiff_file(np.zeros((h, (w * bits + 7) // 8), np.uint8), (bits,), photometric,
                     compression=compression, tile=tile, colormap=colormap, width=w,
                     fill_order=fill_order, chunks=chunks)


# the formats Pillow 12.1.0 reads and the port refuses, naming the format
REFUSED_FORMATS = ("AVIF", "HTJ2K (JPEG 2000 Part 15)")
# the formats Pillow 12.1.0 opens on this host and then refuses to load (stubs
# without a loader, EPS without Ghostscript, MPEG's header only)
PILLOW_REFUSES = ("BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF/EMF")
# the formats the port refused before it read them as Pillow does
ONCE_REFUSED = ("FITS", "FLI/FLC", "FTEX", "GBR", "IMT", "IPTC/NAA", "McIdas", "PCD", "PIXAR",
                "XPM", "XV thumbnail")


def refused_format_files() -> dict:
    """Seeded files of every format Pillow 12.1.0 opens on this host that the
    port refused at first: {the format (a refusal's word for those of
    :data:`REFUSED_FORMATS`): (file extension, bytes)}, in the order of
    :data:`REFUSED_FORMATS`, :data:`PILLOW_REFUSES` and :data:`ONCE_REFUSED`.
    Pillow writes the AVIF (an ``avis`` sequence, which the port does not
    read) and EPS ones and the codestream whose COD marks its code-blocks
    HTJ2K; the rest are the smallest whole files Pillow's plugins open."""
    from PIL import Image

    def pil(image, fmt, **kw):
        buf = io.BytesIO()
        image.save(buf, fmt, **kw)
        return buf.getvalue()

    rgb = Image.fromarray(seeded_rgb((16, 16), 190))
    gray = np.asarray(rgb.convert("L"))
    htj2k = with_cblk_style(pil(rgb, "JPEG2000", no_jp2=True), 0x40)
    wmf = bytearray(b"\xd7\xcd\xc6\x9a\x00\x00") + struct.pack("<hhhhHIH", 0, 0, 160, 160, 1440,
                                                               0, 0)
    wmf += b"\x01\x00\x09\x00" + bytes(60)
    ycc = np.repeat(np.repeat(seeded_rgb((16, 24), 191), 32, 0), 32, 1)
    files = {
        "AVIF": ("avif", pil(rgb, "AVIF", save_all=True,
                             append_images=[rgb.transpose(Image.Transpose.FLIP_TOP_BOTTOM)])),
        "HTJ2K (JPEG 2000 Part 15)": ("j2k", htj2k),
        "BUFR": ("bufr", b"BUFR" + bytes(60)),
        "EPS": ("eps", pil(rgb, "EPS")),
        "GRIB": ("grib", b"GRIB\0\0\0\x01" + bytes(60)),
        "HDF5": ("h5", b"\x89HDF\r\n\x1a\n" + bytes(60)),
        "MPEG": ("mpg", b"\0\0\1\xb3\x01\x00\x10" + bytes(40)),
        "WMF/EMF": ("wmf", bytes(wmf)),
        "FITS": ("fits", fits_file(gray, 8)),
        "FLI/FLC": ("fli", fli_file([(16, gray.tobytes())], 16, 16, flc=False)),
        "FTEX": ("ftc", ftex_file(16, 16, 1, np.asarray(rgb).tobytes())),
        "GBR": ("gbr", gbr_file(gray)),
        "IMT": ("imt", imt_file(gray, comment=False)),
        "IPTC/NAA": ("iptc", iptc_file(16, 16, gray.tobytes())),
        "McIdas": ("area", mcidas_file(gray, 1)),
        "PCD": ("pcd", pcd_file(ycc)),
        "PIXAR": ("pxr", pixar_file(np.asarray(rgb))),
        "XPM": ("xpm", b'/* XPM */\nstatic char *seed[] = {\n"4 2 2 1",\n"a c #FF0000",\n'
                       b'"b c #00FF00",\n"abab",\n"baba"\n};\n'),
        "XV thumbnail": ("xv", xv_file(gray)),
    }
    assert tuple(files) == REFUSED_FORMATS + PILLOW_REFUSES + ONCE_REFUSED
    return files


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
    out.update(new_formats())
    out.update(small_formats())
    out.update(tiff_codec_formats())
    out.update(jpeg2000_formats())
    out.update(lab_and_pnm_formats())
    out.update(rare_formats())
    out.update(avif_formats())
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
                                     tga_rle_1bit(gray.convert("1"))),
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


def new_formats() -> dict:
    """WebP (lossy, lossy with alpha, lossless, animated, settings only the
    libwebp API reaches), DDS (Pillow's DXT1/3/5 and BC5, seeded blocks of
    BC4/BC5S/BC6H/BC7, bit masks, luminance, palette), PSD (every mode PIL
    reads, raw and PackBits) and TIFF (JPEG strips, separate planes, fill
    order 2, BigTIFF), the chair's textures in them, and the 2048 x 1536
    atlas in six of them; the two DDS atlases stored gzip-compressed (the
    ``.gz`` name; the manifest hashes the file inside)."""
    from PIL import Image

    def pil(image, fmt, **kw):
        buf = io.BytesIO()
        (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(40)
    rgb = seeded_rgb((37, 53), 41)
    alpha = np.clip(rng.normal(200, 60, (37, 53, 1)), 0, 255).astype(np.uint8)
    alpha[:10] = 255
    rgba = np.concatenate([rgb, alpha], -1)
    tex = seeded_rgb((64, 64), 42, noise=12)
    tex_a = np.concatenate([tex, np.full((64, 64, 1), 255, np.uint8)], -1)
    tex_a[40:, 20:44, 3] = 90
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1))
    out = {
        "webp_lossy_q75.webp": ("WebP lossy (VP8) q75", pil(rgb, "WEBP", quality=75)),
        "webp_lossy_q20_m6.webp": ("WebP lossy q20 method 6", pil(rgb, "WEBP", quality=20,
                                                                 method=6)),
        "webp_lossy_alpha.webp": ("WebP lossy with ALPH (lossless-coded, filtered)",
                                  pil(rgba, "WEBP", quality=70)),
        "webp_lossy_alpha_raw.webp": ("WebP lossy with raw ALPH, gradient filter",
                                      libwebp_encode(rgba, quality=60, alpha_compression=0,
                                                     alpha_filtering=2)),
        "webp_simple_filter.webp": ("WebP lossy, simple loop filter, sharpness 4",
                                    libwebp_encode(seeded_rgb((40, 72), 43, noise=30),
                                                   filter_type=0, filter_sharpness=4)),
        "webp_partitions.webp": ("WebP lossy, 4 token partitions, sharpness 6, skip probability",
                                 libwebp_encode(seeded_rgb((70, 48), 44, noise=25), quality=20,
                                                method=1, partitions=2, filter_sharpness=6)),
        "webp_lf_deltas.webp": ("WebP lossy, relative segment values, loop-filter deltas",
                                vp8_header_rewrite(libwebp_encode(seeded_rgb((40, 56), 46,
                                                                             noise=25)), 7, -5)),
        "webp_lossless.webp": ("WebP lossless (VP8L)", pil(rgb, "WEBP", lossless=True)),
        "webp_lossless_alpha.webp": ("WebP lossless with alpha", pil(rgba, "WEBP", lossless=True,
                                                                     method=6)),
        "webp_lossless_palette.webp": ("WebP lossless, colour indexing of 5 colours",
                                       pil(Image.fromarray(rgb).quantize(5).convert("RGB"),
                                           "WEBP", lossless=True)),
        "webp_metadata.webp": ("WebP VP8X with ICCP and EXIF chunks",
                               pil(rgb, "WEBP", quality=80, icc_profile=b"\0" * 128,
                                   exif=b"Exif\0\0" + bytes(20))),
        "webp_animated_offset.webp": ("WebP animation, frame 0 inside the canvas at (6, 4)",
                                      webp_animation((64, 48), [
                                          (6, 4, pil(rgba[:30, :40], "WEBP", quality=80)),
                                          (0, 0, pil(rgb[:12, :20], "WEBP", lossless=True))])),
        "refused_webp_truncated.webp": ("WebP cut short (refused)",
                                        pil(rgb, "WEBP", quality=75)[:-40]),
        "dds_dxt1.dds": ("DDS DXT1 (BC1)", pil(rgba, "DDS", pixel_format="DXT1")),
        "dds_dxt3.dds": ("DDS DXT3 (BC2)", pil(rgba, "DDS", pixel_format="DXT3")),
        "dds_dxt5.dds": ("DDS DXT5 (BC3)", pil(rgba, "DDS", pixel_format="DXT5")),
        "dds_bc5_dx10.dds": ("DDS DX10 BC5", pil(rgb, "DDS", pixel_format="BC5")),
        "dds_bc1_blocks.dds": ("DDS DXT1 seeded blocks (three-colour mode)",
                               dds_file(21, 13, bc_blocks(21, 13, 8, 45), fourcc=b"DXT1")),
        "dds_ati1.dds": ("DDS ATI1 (BC4) seeded blocks", dds_file(21, 13, bc_blocks(21, 13, 8, 46),
                                                                  fourcc=b"ATI1")),
        "dds_bc5s.dds": ("DDS BC5S seeded blocks", dds_file(21, 13, bc_blocks(21, 13, 16, 47),
                                                            fourcc=b"BC5S")),
        "dds_bc6h_uf16.dds": ("DDS BC6H UF16 seeded blocks, every mode",
                              dds_file(128, 8, bc_blocks(128, 8, 16, 48), fourcc=b"DX10",
                                       dxgi=95)),
        "dds_bc6h_sf16.dds": ("DDS BC6H SF16 seeded blocks, every mode",
                              dds_file(128, 8, bc_blocks(128, 8, 16, 49), fourcc=b"DX10",
                                       dxgi=96)),
        "dds_bc7_blocks.dds": ("DDS BC7 seeded blocks, a row of each mode (and of none)",
                               dds_file(32, 35, b"".join(
                                   bc_blocks(32, 4, 16, 50 + m,
                                             first=(min(m + 1, 8), (1 << m) & 0xFF))
                                   for m in range(9)), fourcc=b"DX10", dxgi=98)),
        "dds_bc7_srgb_mipmaps.dds": ("DDS BC7 sRGB, encoded, with mip levels after it",
                                     dds_file(64, 64, bc7_mode6(tex_a) + bytes(1024),
                                              fourcc=b"DX10", dxgi=99, mipmaps=2)),
        "dds_rgb565.dds": ("DDS bit masks 5-6-5", dds_file(
            21, 13, bc_blocks(21, 16, 8, 51)[:21 * 13 * 2], pfflags=0x40, bitcount=16,
            masks=(0xF800, 0x7E0, 0x1F, 0))),
        "dds_rgba_masks.dds": ("DDS bit masks 32-bit with alpha", pil(rgba, "DDS")),
        "dds_l8.dds": ("DDS luminance", pil(rgb[..., 0], "DDS")),
        "dds_la.dds": ("DDS luminance with alpha", pil(Image.fromarray(rgba[..., [0, 3]], "LA"),
                                                       "DDS")),
        "dds_p8.dds": ("DDS 8-bit palette", dds_file(
            21, 13, bc_blocks(16, 16, 64, 52)[:1024] + bc_blocks(21, 13, 16, 53)[:21 * 13],
            pfflags=0x20, bitcount=8)),
        "dds_rgba8_dx10.dds": ("DDS DX10 R8G8B8A8", dds_file(21, 13, rgba[:13, :21].tobytes(),
                                                             fourcc=b"DX10", dxgi=28)),
        "refused_dds_bc4s.dds": ("DDS BC4S (refused)", dds_file(8, 8, bytes(32), fourcc=b"BC4S")),
        "refused_dds_truncated.dds": ("DDS DXT5 cut short (refused)",
                                      pil(rgba, "DDS", pixel_format="DXT5")[:-64]),
        "psd_rgb_rle.psd": ("PSD RGB, PackBits, a layer", psd_file(planes, 3, rle=True)),
        "psd_rgba_raw.psd": ("PSD RGBA, raw", psd_file(np.concatenate([planes, alpha.transpose(
            2, 0, 1)]), 3)),
        "psd_gray_rle.psd": ("PSD gray", psd_file(planes[:1], 1, rle=True)),
        "psd_multichannel.psd": ("PSD multichannel (L)", psd_file(planes, 7, rle=True)),
        "psd_duotone.psd": ("PSD duotone (L)", psd_file(planes[:1], 8, color_data=b"duotone!")),
        "psd_indexed.psd": ("PSD indexed (P)", psd_file(
            (planes[:1] // 32).astype(np.uint8), 2, rle=True,
            color_data=rng.integers(0, 256, 768).astype(np.uint8).tobytes())),
        "psd_cmyk_rle.psd": ("PSD CMYK, PackBits", psd_file(np.concatenate(
            [planes, alpha.transpose(2, 0, 1)]), 4, rle=True)),
        "psd_bitmap.psd": ("PSD bitmap (1)", psd_file(np.packbits(planes[:1] > 100, axis=2), 0,
                                                      bits=1, rle=True)),
        "refused_psd_16bit.psd": ("PSD 16-bit (refused)", psd_file(planes, 3, bits=16)),
        "refused_psd_truncated.psd": ("PSD cut short (refused)", psd_file(planes, 3)[:-50]),
        "tiff_jpeg_rgb.tif": ("TIFF JPEG, RGB", pil(rgb, "TIFF", compression="jpeg")),
        "tiff_jpeg_ycbcr_strips.tif": ("TIFF JPEG, YCbCr, strips of 8 rows",
                                       pil(Image.fromarray(rgb).convert("YCbCr"), "TIFF",
                                           compression="jpeg", tiffinfo={278: 8})),
        "tiff_jpeg_gray.tif": ("TIFF JPEG, gray", pil(rgb[..., 0], "TIFF", compression="jpeg")),
        "tiff_planar_deflate.tif": ("TIFF RGB, separate planes, Deflate, predictor 2",
                                    tiff_file(rgb, (8, 8, 8), 2, planar=True, compression=8,
                                              predictor=2, rows_per_strip=9)),
        "tiff_fill2_packbits.tif": ("TIFF RGB, fill order 2, PackBits",
                                    tiff_file(rgb, (8, 8, 8), 2, fill_order=2,
                                              compression=32773, rows_per_strip=10)),
        "tiff_bigtiff.tif": ("TIFF BigTIFF, RGBA, tiles", tiff_file(rgba, (8, 8, 8, 8), 2,
                                                                    extra=(2,), tile=(16, 16),
                                                                    bigtiff=True)),
        "chair_lossy_alpha.webp": ("chair texture, WebP lossy with alpha",
                                   pil(tex_a, "WEBP", quality=80)),
        "chair_lossless.webp": ("chair texture, WebP lossless", pil(tex[::-1], "WEBP",
                                                                    lossless=True)),
        "chair_bc7.dds": ("chair texture, DDS BC7", dds_file(64, 64, bc7_mode6(tex_a[:, ::-1]),
                                                             fourcc=b"DX10", dxgi=98)),
        "chair_dxt1.dds": ("chair texture, DDS DXT1", pil(tex_a[::-1, ::-1], "DDS",
                                                          pixel_format="DXT1")),
        "chair_rle.psd": ("chair texture, PSD PackBits", psd_file(np.ascontiguousarray(
            tex.transpose(2, 1, 0)), 3, rle=True)),
    }
    writer = LibjpegWriter()
    try:
        out["chair_ycbcr_420.tif"] = ("chair texture, TIFF JPEG YCbCr 4:2:0, strips of 24 rows",
                                      jpeg_tiff(writer, np.ascontiguousarray(tex.transpose(
                                          1, 0, 2)[::-1]), 24))
        out["tiff_jpeg_ycbcr_420.tif"] = ("TIFF JPEG, YCbCr 4:2:0, strips of 16 rows (libjpeg)",
                                          jpeg_tiff(writer, rgb, 16))
    finally:
        writer.close()
    atlas = texture_atlas(9)
    atlas_a = np.concatenate([atlas, np.full(atlas.shape[:2] + (1,), 255, np.uint8)], -1)
    out["atlas_lossy_2048x1536.webp"] = ("2048 x 1536 atlas, WebP lossy q90",
                                         pil(atlas, "WEBP", quality=90))
    out["atlas_lossless_2048x1536.webp"] = ("2048 x 1536 atlas, WebP lossless",
                                            pil(atlas, "WEBP", lossless=True))
    out["atlas_bc7_2048x1536.dds"] = ("2048 x 1536 atlas, DDS BC7", dds_file(
        2048, 1536, bc7_mode6(atlas_a), fourcc=b"DX10", dxgi=98))
    out["atlas_dxt1_2048x1536.dds"] = ("2048 x 1536 atlas, DDS DXT1",
                                       pil(atlas, "DDS", pixel_format="DXT1"))
    out["atlas_rle_2048x1536.psd"] = ("2048 x 1536 atlas, PSD PackBits", psd_file(
        np.ascontiguousarray(atlas.transpose(2, 0, 1)), 3, rle=True, layer=False))
    out["atlas_ycbcr_jpeg_2048x1536.tif"] = ("2048 x 1536 atlas, TIFF JPEG YCbCr, strips of 64",
                                             tiff_pad_byte(pil(Image.fromarray(atlas).convert(
                                                 "YCbCr"), "TIFF", compression="jpeg", quality=75,
                                                 tiffinfo={278: 64}), 0x92))
    return out


# ---------------------------------------------------------------- TIFF codecs

_MH_CODES = None


def _mh_codes():
    """T.4's modified Huffman code words: ({run: white code}, {run: black
    code}), make-up runs 64-2560 included."""
    global _MH_CODES
    if _MH_CODES is None:
        from coma_tpu_torch.utils import tiff_codecs as tc
        tables = []
        for term, makeup in ((tc._WHITE_TERM, tc._WHITE_MAKEUP), (tc._BLACK_TERM, tc._BLACK_MAKEUP)):
            codes = dict(enumerate(term))
            codes.update({64 * (k + 1): c for k, c in enumerate(makeup)})
            codes.update({1792 + 64 * k: c for k, c in enumerate(tc._COMMON_MAKEUP)})
            tables.append(codes)
        _MH_CODES = tuple(tables)
    return _MH_CODES


def mh_row(row: np.ndarray) -> str:
    """One row of bits (1 black) as modified Huffman code words: runs from
    white, each a make-up code (if 64 or more) and a terminating code."""
    codes = _mh_codes()
    out, x, colour, width = [], 0, 0, len(row)
    while x < width or colour == 1:
        end = x
        while end < width and row[end] == colour:
            end += 1
        run = end - x
        while run >= 2560:
            out.append(codes[colour][2560])
            run -= 2560
        if run >= 64:
            out.append(codes[colour][run // 64 * 64])
        out.append(codes[colour][run % 64])
        x, colour = end, 1 - colour
        if x >= width:
            break
    return "".join(out)


def ccitt_rle(bits: np.ndarray, word: bool = False) -> bytes:
    """CCITT modified Huffman (compression 2) of (H, W) bits, each row padded
    to a byte, or (RLEW, 32771) to a 16-bit word of the strip."""
    stream = ""
    for row in bits:
        code = mh_row(row)
        stream += code + "0" * (-len(stream + code) % (16 if word else 8))
    return int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""


def g3_file(bits: np.ndarray, fill_bits: bool = True) -> bytes:
    """T.4 1-D data of (H, W) bits: an EOL before each row, its zeros padded
    so that the EOL ends a byte (T4Options fill bits)."""
    stream = ""
    for row in bits:
        if fill_bits:
            stream += "0" * ((-len(stream) - 12) % 8)
        stream += "000000000001" + mh_row(row)
    stream += "0" * (-len(stream) % 8)
    return int(stream, 2).to_bytes(len(stream) // 8, "big")


def thunder_rows(levels: np.ndarray) -> bytes:
    """ThunderScan (32809) codes of (H, W) 4-bit levels: runs of the last
    level, 2-bit and 3-bit deltas where they reach, raw codes otherwise."""
    out = bytearray()
    for row in levels.tolist():
        last, x = 0, 0
        while x < len(row):
            run = 0
            while x + run < len(row) and row[x + run] == last and run < 63:
                run += 1
            if run >= 2:
                out.append(run)
                x += run
                continue
            d = row[x] - last
            if d in (-1, 0, 1) and x + 1 < len(row) and row[x + 1] - row[x] in (-1, 0, 1) \
                    and d != 0:
                two = {0: 0, 1: 1, -1: 3}
                e = row[x + 1] - row[x]
                out.append(0x40 | two[d] << 4 | two[e] << 2 | 2)       # 2: skip
                last, x = row[x + 1], x + 2
            elif -3 <= d <= 3 and d != 0:
                out.append(0x80 | (d & 7) << 3 | 4)                    # 4: skip
                last, x = row[x], x + 1
            else:
                out.append(0xC0 | row[x])
                last, x = row[x], x + 1
    return bytes(out)


def libzstd_compress(raw: bytes, level: int = 9, checksum: bool = False) -> bytes:
    """A Zstandard frame of ``raw`` by the libzstd bundled with Pillow
    (``pillow.libs``), with its content checksum if ``checksum``."""
    import ctypes
    import glob

    import PIL
    from PIL import Image  # noqa: F401  (loads the bundled libraries)

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                             "pillow.libs", "libzstd-*.so*"))[0])
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    cctx = lib.ZSTD_createCCtx()
    lib.ZSTD_CCtx_setParameter(cctx, 100, level)           # ZSTD_c_compressionLevel
    lib.ZSTD_CCtx_setParameter(cctx, 201, int(checksum))   # ZSTD_c_checksumFlag
    cap = lib.ZSTD_compressBound(len(raw))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress2(cctx, out, cap, raw, len(raw))
    lib.ZSTD_freeCCtx(cctx)
    return out.raw[:n]


def codec_tiff(pixels: np.ndarray, compression: int, tile=None, rows_per_strip: int = 0,
               predictor: int = 1, checksum: bool = False) -> bytes:
    """An 8-bit gray or RGB TIFF with LZMA (34925: Python's xz) or Zstandard
    (50000: libzstd) strips or tiles."""
    import lzma

    px = pixels if pixels.ndim == 3 else pixels[..., None]
    H, W, C = px.shape

    def encode(block: np.ndarray) -> bytes:
        b = block.copy()
        if predictor == 2:
            b[:, 1:] = (b[:, 1:].astype(np.int16) - block[:, :-1]).astype(np.uint8)
        raw = b.tobytes()
        return lzma.compress(raw, lzma.FORMAT_XZ) if compression == 34925 else \
            libzstd_compress(raw, checksum=checksum)

    chunks = []
    if tile:
        tw, th = tile
        for ty in range(0, H, th):
            for tx in range(0, W, tw):
                block = np.zeros((th, tw, C), np.uint8)
                part = px[ty:ty + th, tx:tx + tw]
                block[:part.shape[0], :part.shape[1]] = part
                chunks.append(encode(block))
    else:
        rps = rows_per_strip or H
        chunks = [encode(px[y:y + rps]) for y in range(0, H, rps)]
    return tiff_file(pixels, (8,) * C, 2 if C == 3 else 1, compression=compression, tile=tile,
                     rows_per_strip=rows_per_strip, predictor=predictor, chunks=chunks)


def _jpeg_tables(jpg: bytes):
    """A baseline JPEG's quantisation tables (64 bytes each, zigzag), its
    Huffman tables ((class, id) -> counts + values) and the scan's data
    between its restart markers."""
    qt, ht, scan = {}, {}, None
    for marker, start, end in jpeg_segments(jpg):
        body = jpg[start + 4:end] if marker != 0xDA else None
        if marker == 0xDB:
            pos = 0
            while pos < len(body):
                qt[body[pos] & 15] = body[pos + 1:pos + 65]
                pos += 65
        elif marker == 0xC4:
            pos = 0
            while pos < len(body):
                n = sum(body[pos + 1:pos + 17])
                ht[(body[pos] >> 4, body[pos] & 15)] = body[pos + 1:pos + 17 + n]
                pos += 17 + n
        elif marker == 0xDA:
            head = start + 2 + int.from_bytes(jpg[start + 2:start + 4], "big")
            scan = jpg[head:end]
    intervals, pos, last = [], 0, 0
    while pos < len(scan) - 1:
        if scan[pos] == 0xFF and 0xD0 <= scan[pos + 1] <= 0xD7:
            intervals.append(scan[last:pos])
            last = pos = pos + 2
        else:
            pos += 1
    intervals.append(scan[last:])
    return qt, ht, intervals


def ojpeg_tiff(jpg: bytes, width: int, height: int, sampling: tuple, layout: str = "jif",
               rows_per_strip: int = 0, photometric: int = 6, tags=None) -> bytes:
    """An old-style JPEG TIFF (compression 6) of the baseline JFIF ``jpg``.
    ``layout`` "jif": JPEGInterchangeFormat points at the whole stream and
    the strip at its scan data; "tags": the tables in JPEGQTables,
    JPEGDCTables and JPEGACTables (Y the first of each, Cb and Cr the
    second) and each strip one restart interval of the scan (``jpg`` coded
    with one interval a strip)."""
    spp = 1 if photometric != 6 else 3
    entries = {262: (3, [photometric]), 530: (3, list(sampling)), **(tags or {})}
    if layout == "jif":
        scan = next(s for m, s, e in jpeg_segments(jpg) if m == 0xDA)
        head = scan + 2 + int.from_bytes(jpg[scan + 2:scan + 4], "big")
        at = 8                          # the JIF the only chunk, after the 8-byte header
        entries.update({513: (4, [at]), 514: (4, [len(jpg)])})
        data = bytearray(tiff_file(np.zeros((height, width * spp), np.uint8), (8,) * spp,
                                   photometric, compression=6, width=width,
                                   rows_per_strip=rows_per_strip or height, chunks=[jpg],
                                   tags=entries))
        # the strip: the scan data inside the JIF
        ifd = int.from_bytes(data[4:8], "little")
        for k in range(int.from_bytes(data[ifd:ifd + 2], "little")):
            e = ifd + 2 + 12 * k
            tag = int.from_bytes(data[e:e + 2], "little")
            if tag == 273:
                data[e + 8:e + 12] = (at + head).to_bytes(4, "little")
            elif tag == 279:
                data[e + 8:e + 12] = (len(jpg) - head).to_bytes(4, "little")
        return bytes(data)
    qt, ht, intervals = _jpeg_tables(jpg)
    blobs = [qt[0], qt.get(1, qt[0]), ht[(0, 0)], ht.get((0, 1), ht[(0, 0)]), ht[(1, 0)],
             ht.get((1, 1), ht[(1, 0)])]
    # the tables after the strips: placed once the file's size is known
    entries.update({512: (3, [1]), 519: (4, [0] * spp), 520: (4, [0] * spp),
                    521: (4, [0] * spp)})
    start = len(tiff_file(np.zeros((height, width * spp), np.uint8), (8,) * spp, photometric,
                          compression=6, width=width, rows_per_strip=rows_per_strip or height,
                          chunks=intervals, tags=entries))
    offsets, at = [], start
    for b in blobs:
        offsets.append(at)
        at += len(b)
    q = [offsets[0]] + [offsets[1]] * (spp - 1)
    dc = [offsets[2]] + [offsets[3]] * (spp - 1)
    ac = [offsets[4]] + [offsets[5]] * (spp - 1)
    entries.update({519: (4, q), 520: (4, dc), 521: (4, ac)})
    body = tiff_file(np.zeros((height, width * spp), np.uint8), (8,) * spp, photometric,
                     compression=6, width=width, rows_per_strip=rows_per_strip or height,
                     chunks=intervals, tags=entries)
    assert len(body) == start, "the table offsets moved"
    return body + b"".join(blobs)


def tiff_codec_formats() -> dict:
    """TIFFs of the compressions libtiff decodes beside LZW, PackBits,
    Deflate and JPEG: CCITT RLE and RLEW, Group 3 (1-D with fill bits, 2-D),
    Group 4 (fill order 2, min-is-white), ThunderScan, LZMA and Zstandard
    (strips, tiles, predictor 2, a content checksum) and old-style JPEG
    (a JPEGInterchangeFormat stream, tables in tags); the chair's six
    textures in six of them; the 2048 x 1536 atlas as Zstandard and,
    thresholded, as Group 4. Group 4 files of more than one row keep a row a
    strip: where a damaged strip ends early libtiff leaves the rest of
    Pillow's strip buffer unwritten, uninitialised memory for the first
    strip of a small file, which no reader can match."""
    from PIL import Image

    def pil(image, **kw):
        buf = io.BytesIO()
        (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, "TIFF",
                                                                                    **kw)
        return buf.getvalue()

    def jfif(image, **kw):
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, "JPEG", **kw)
        return buf.getvalue()

    rgb = seeded_rgb((37, 53), 90, noise=8) // 8 * 8
    bits = rgb[..., 1] > 120
    levels = (rgb[..., 0] // 16).astype(np.uint8)
    tex = seeded_rgb((32, 32), 91, noise=4) // 16 * 16
    tex_bits = tex[..., 0] > 110
    out = {
        "ccitt_rle.tif": ("TIFF CCITT RLE (compression 2)",
                          pil(bits, compression="tiff_ccitt")),
        "ccitt_rlew.tif": ("TIFF CCITT RLEW (32771), rows word-aligned",
                           tiff_file(np.packbits(bits, axis=1), (1,), 0, compression=32771,
                                     width=53, chunks=[ccitt_rle(bits, word=True)])),
        "ccitt_g3_1d_fill.tif": ("TIFF CCITT Group 3 1-D, EOLs after fill bits",
                                 tiff_file(np.packbits(bits, axis=1), (1,), 0, compression=3,
                                           width=53, chunks=[g3_file(bits)],
                                           tags={292: (4, [4])})),
        "ccitt_g3_2d.tif": ("TIFF CCITT Group 3 2-D, strips of 8",
                            pil(bits, compression="group3", tiffinfo={292: 1, 278: 8})),
        "ccitt_g4.tif": ("TIFF CCITT Group 4", pil(bits, compression="group4",
                                                   tiffinfo={278: 1})),
        "ccitt_g4_fill2_miniswhite.tif": ("TIFF CCITT Group 4, fill order 2, min-is-white",
                                          pil(bits, compression="group4",
                                              tiffinfo={266: 2, 262: 0, 278: 1})),
        "thunderscan.tif": ("TIFF ThunderScan 4-bit, strips of 16",
                            tiff_file(np.zeros((37, 27), np.uint8), (4,), 1, compression=32809,
                                      width=53, rows_per_strip=16,
                                      chunks=[thunder_rows(levels[y:y + 16])
                                              for y in range(0, 37, 16)])),
        "lzma_rgb.tif": ("TIFF LZMA, RGB, strips of 16",
                         pil(rgb, compression="lzma", tiffinfo={278: 16})),
        "lzma_tiles_predictor.tif": ("TIFF LZMA, tiles, predictor 2",
                                     codec_tiff(rgb, 34925, tile=(16, 16), predictor=2)),
        "zstd_rgb.tif": ("TIFF Zstandard, RGB", pil(rgb, compression="zstd")),
        "zstd_gray_predictor.tif": ("TIFF Zstandard, gray, predictor 2, strips of 10",
                                    codec_tiff(rgb[..., 0], 50000, rows_per_strip=10,
                                               predictor=2)),
        "zstd_tiles_checksum.tif": ("TIFF Zstandard, tiles, content checksum",
                                    codec_tiff(rgb, 50000, tile=(16, 16), checksum=True)),
        "ojpeg_jif_420.tif": ("TIFF old-style JPEG, JPEGInterchangeFormat, YCbCr 4:2:0",
                              ojpeg_tiff(jfif(rgb, quality=90, subsampling=2), 53, 37, (2, 2))),
        "ojpeg_tags_422.tif": ("TIFF old-style JPEG, tables in tags, YCbCr 4:2:2, strips of 8",
                               ojpeg_tiff(jfif(rgb, quality=85, subsampling=1,
                                               restart_marker_rows=1), 53, 37, (2, 1), "tags",
                                          rows_per_strip=8)),
        "ojpeg_gray.tif": ("TIFF old-style JPEG, gray",
                           ojpeg_tiff(jfif(rgb[..., 1], quality=80), 53, 37, (1, 1),
                                      photometric=1)),
        "chair_g4_fill2.tif": ("chair texture, TIFF CCITT Group 4, fill order 2",
                               pil(tex_bits, compression="group4", tiffinfo={266: 2, 278: 1})),
        "chair_g3_2d.tif": ("chair texture, TIFF CCITT Group 3 2-D",
                            pil(tex_bits[::-1], compression="group3", tiffinfo={292: 1})),
        "chair_lzma.tif": ("chair texture, TIFF LZMA", pil(tex[:, ::-1], compression="lzma")),
        "chair_zstd.tif": ("chair texture, TIFF Zstandard", pil(tex[::-1], compression="zstd")),
        "chair_ojpeg.tif": ("chair texture, TIFF old-style JPEG 4:2:0",
                            ojpeg_tiff(jfif(tex, quality=90, subsampling=2), 32, 32, (2, 2))),
        "chair_thunderscan.tif": ("chair texture, TIFF ThunderScan",
                                  tiff_file(np.zeros((32, 16), np.uint8), (4,), 1,
                                            compression=32809, width=32,
                                            chunks=[thunder_rows(tex[..., 2] // 16)])),
    }
    atlas = texture_atlas(9)
    out["atlas_zstd_2048x1536.tif"] = ("2048 x 1536 atlas, TIFF Zstandard",
                                       pil(atlas, compression="zstd"))
    gray = np.asarray(Image.fromarray(atlas).convert("L"))
    out["atlas_g4_2048x1536.tif"] = ("2048 x 1536 atlas thresholded, TIFF CCITT Group 4",
                                     pil(gray >= 128, compression="group4"))
    return out


# --- JPEG 2000, Lab and Pillow's PNM magics ----------------------------------

def _openjp2():
    """ctypes bindings of the libopenjp2 bundled with Pillow (``pillow.libs``):
    its encoder's parameter, image and component structs (OpenJPEG 2.5's
    layouts) and the functions :func:`openjpeg_encode` calls."""
    import ctypes
    import glob

    import PIL
    from PIL import Image  # noqa: F401  (loads the bundled libraries)

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                             "pillow.libs", "libopenjp2-*.so*"))[0])
    u32, i32, vp = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p

    class Poc(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1",
                                       "layno0", "precno0", "precno1")] + [
            ("prg1", i32), ("prg", i32), ("progorder", ctypes.c_char * 5), ("tile", u32),
            ("rest", ctypes.c_int32 * 24)]

    class Params(ctypes.Structure):
        _fields_ = [(n, i32) for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
                                       "cp_disto_alloc", "cp_fixed_alloc",
                                       "cp_fixed_quality")] + [
            ("cp_matrice", vp), ("cp_comment", vp), ("csty", i32), ("prog_order", i32),
            ("POC", Poc * 32), ("numpocs", u32), ("tcp_numlayers", i32),
            ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100)] + [
            (n, i32) for n in ("numresolution", "cblockw_init", "cblockh_init", "mode",
                               "irreversible", "roi_compno", "roi_shift", "res_spec")] + [
            ("prcw_init", i32 * 33), ("prch_init", i32 * 33), ("infile", ctypes.c_char * 4096),
            ("outfile", ctypes.c_char * 4096), ("index_on", i32),
            ("index", ctypes.c_char * 4096)] + [
            (n, i32) for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx",
                               "subsampling_dy", "decod_format", "cod_format")] + [
            ("jpwl", i32 * 118), ("cp_cinema", i32), ("max_comp_size", i32), ("cp_rsiz", i32),
            ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
            ("jpip_on", i32), ("mct_data", vp), ("max_cs_size", i32), ("rsiz", ctypes.c_uint16)]

    class CmptParm(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    class Comp(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                       "resno_decoded", "factor")] + [
            ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]

    class Img(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
            ("color_space", i32), ("comps", ctypes.POINTER(Comp)), ("icc", vp), ("icclen", u32)]

    img_p = ctypes.POINTER(Img)
    for fn, res, args in (
            ("opj_set_default_encoder_parameters", None, [ctypes.POINTER(Params)]),
            ("opj_image_create", img_p, [u32, ctypes.POINTER(CmptParm), i32]),
            ("opj_create_compress", vp, [i32]),
            ("opj_setup_encoder", i32, [vp, ctypes.POINTER(Params), img_p]),
            ("opj_stream_create_default_file_stream", vp, [ctypes.c_char_p, i32]),
            ("opj_start_compress", i32, [vp, img_p, vp]), ("opj_encode", i32, [vp, vp]),
            ("opj_end_compress", i32, [vp, vp]), ("opj_stream_destroy", None, [vp]),
            ("opj_destroy_codec", None, [vp]), ("opj_image_destroy", None, [img_p])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib, Params, CmptParm


def openjpeg_encode(planes, sub=None, jp2: bool = False, color_space: int = 1, offset=(0, 0),
                    prec: int = 8, sgnd: bool = False, rates=(0,), pocs=(), precincts=(),
                    tile=None, mct: int = 0, **params) -> bytes:
    """A codestream (or, with ``jp2``, a JP2 file) of ``planes`` (2-D integer
    arrays, component by component, each already at its subsampled size) by
    Pillow's libopenjp2, with what Pillow's encoder does not pass: code-block
    styles (``mode``), POC changes (``pocs``: resno0, compno0, layno1, resno1,
    compno1, progression), component subsampling (``sub``: (dx, dy) each),
    ROI (``roi_compno``, ``roi_shift``), SOP/EPH (``csty`` 2 and 4), any
    precision, signed samples. ``color_space`` is OpenJPEG's (1 sRGB, 2 gray,
    3 sYCC, 5 CMYK), written into a JP2's colr box."""
    import ctypes

    lib, Params, CmptParm = _openjp2()
    n = len(planes)
    sub = sub or [(1, 1)] * n
    parms = (CmptParm * n)()
    for i, (plane, (dx, dy)) in enumerate(zip(planes, sub)):
        parms[i].dx, parms[i].dy = dx, dy
        parms[i].h, parms[i].w = plane.shape
        parms[i].x0, parms[i].y0 = -(-offset[0] // dx), -(-offset[1] // dy)
        parms[i].prec, parms[i].bpp, parms[i].sgnd = prec, prec, int(sgnd)
    img = lib.opj_image_create(n, parms, color_space)
    img.contents.x0, img.contents.y0 = offset
    img.contents.x1 = offset[0] + (planes[0].shape[1] - 1) * sub[0][0] + 1
    img.contents.y1 = offset[1] + (planes[0].shape[0] - 1) * sub[0][1] + 1
    for i, plane in enumerate(planes):
        a = np.ascontiguousarray(plane, np.int32)
        ctypes.memmove(img.contents.comps[i].data, a.ctypes.data, a.nbytes)
    p = Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers, p.cp_disto_alloc = len(rates), 1
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    p.numpocs = len(pocs)
    for i, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        q = p.POC[i]
        q.resno0, q.compno0, q.layno1, q.resno1, q.compno1, q.prg1, q.tile = r0, c0, l1, r1, c1, \
            prg, 1
    if precincts:
        p.res_spec = len(precincts)
        p.csty |= 1
        for i, (w, h) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = w, h
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
    p.tcp_mct = bytes([mct])
    for k, v in params.items():
        setattr(p, k, getattr(p, k) | v if k == "csty" else v)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    ok = lib.opj_setup_encoder(codec, ctypes.byref(p), img)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out").encode()
        stream = lib.opj_stream_create_default_file_stream(path, 0)
        ok = ok and lib.opj_start_compress(codec, img, stream) and lib.opj_encode(
            codec, stream) and lib.opj_end_compress(codec, stream)
        lib.opj_stream_destroy(stream)
        with open(path, "rb") as fh:
            data = fh.read()
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(img)
    if not ok:
        raise RuntimeError("libopenjp2 refused to encode")
    return data


def packet_spans(cs: bytes) -> tuple:
    """A codestream of one tile-part per tile, cut where ``utils/j2k.py``'s
    tier-2 finds its packets: (main header, [(tile index, tile-part header
    markers, [(packet header, packet body)])])."""
    sys.path.insert(0, REPO)
    from coma_tpu_torch.utils import j2k

    hdr, pos = j2k.read_header(cs)
    parts, order = j2k.tile_parts(cs, hdr, pos)
    tiles = []
    for index in order:
        entry = parts[index]
        tcp = hdr.tcp.copy()
        for marker, start, end in entry["segments"]:
            j2k._read_marker(marker, j2k._Reader(cs, start, end), len(hdr.comps), tcp, {})
        p, q = index % hdr.tiles_across, index // hdr.tiles_across
        tx0, ty0 = max(hdr.tx0 + p * hdr.tdx, hdr.x0), max(hdr.ty0 + q * hdr.tdy, hdr.y0)
        tx1 = min(hdr.tx0 + (p + 1) * hdr.tdx, hdr.x1)
        ty1 = min(hdr.ty0 + (q + 1) * hdr.tdy, hdr.y1)
        tilecs = [j2k._init_tilec(c, t, tx0, ty0, tx1, ty1) for c, t in zip(hdr.comps, tcp.tccps)]
        data = bytes(entry["data"])
        at, packets = 0, []
        for key in j2k._packets(hdr, tcp, tilecs, tx0, ty0, tx1, ty1):
            header_end, end = j2k._read_packet(data, at, len(data), None, tcp, tilecs, key)
            packets.append((data[at:header_end], data[header_end:end]))
            at = end
        markers = b"".join(cs[s - 4:e] for _, s, e in entry["segments"])
        tiles.append((index, markers, packets))
    return cs[:pos], tiles


def _j2k_segment(marker: int, body: bytes) -> bytes:
    """A JPEG 2000 marker segment: the two-byte ``marker`` code, Lmar, the
    body. (A name of its own: JPEG's ``_segment`` takes the code's second
    byte, and a second definition of one name would replace the first for
    every writer of the module.)"""
    return struct.pack(">HH", marker, len(body) + 2) + body


def repack_headers(cs: bytes, where: str) -> bytes:
    """The codestream with its packet headers moved out of the tile data:
    into the main header's PPM markers (``where`` "ppm") or each tile's PPT
    markers ("ppt"), markers of at most ``chunk`` bytes each."""
    main, tiles = packet_spans(cs)
    out = bytearray(main)
    if where == "ppm":
        stream = b"".join(struct.pack(">I", sum(len(h) for h, _ in packets))
                          + b"".join(h for h, _ in packets) for _, _, packets in tiles)
        for z, k in enumerate(range(0, len(stream), 4000)):
            out += _j2k_segment(0xFF60, bytes([z]) + stream[k:k + 4000])
    for index, markers, packets in tiles:
        headers = b"".join(h for h, _ in packets)
        if where == "ppt":
            markers += b"".join(_j2k_segment(0xFF61, bytes([z]) + headers[k:k + 3000])
                                for z, k in enumerate(range(0, len(headers), 3000)))
        body = b"".join(b for _, b in packets)
        sot_len = 12 + len(markers) + 2 + len(body)
        out += struct.pack(">HHHIBB", 0xFF90, 10, index, sot_len, 0, 1) + markers + b"\xff\x93" \
            + body
    return bytes(out + b"\xff\xd9")


def with_cblk_style(cs: bytes, bits: int) -> bytes:
    """The codestream with ``bits`` set in its main COD's code-block style
    byte (0x40 marks HTJ2K code-blocks)."""
    at = cs.index(b"\xff\x52")
    out = bytearray(cs)
    out[at + 4 + 5 + 3] |= bits          # Scod, SGcod (4), then NL, xcb, ycb, cblksty
    return bytes(out)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(cs: bytes, height: int, width: int, nc: int, bpc: int, enumcs: int = 16,
             palette=None) -> bytes:
    """A JP2 file around a codestream: signature, file type, a jp2h of ihdr,
    colr (enumerated ``enumcs``) and, with ``palette`` ((N, C) uint8), pclr
    and cmap mapping component 0 through its C columns."""
    head = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc - 1, 7, 0, 0))
    head += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        columns = pal.shape[1]
        head += _box(b"pclr", struct.pack(">HB", len(pal), columns) + bytes([7] * columns)
                     + pal.tobytes())
        head += _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(columns)))
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + _box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + _box(b"jp2h", head) + _box(b"jp2c", cs))


def jpeg2000_formats() -> dict:
    """JPEG 2000 files, 64 x 64 or smaller: Pillow's encoder (reversible and
    irreversible, the five progressions, tiles with offsets, precincts,
    code-block sizes, quality layers by rate and by dB, no MCT, signed, PLT,
    L/LA/RGBA/I;16), libopenjp2's through ctypes (the code-block styles, POC,
    4:2:0 sYCC, ROI, SOP/EPH, 12-bit signed, CMYK), Pillow's packets
    repacked into PPM and PPT, a JP2 palette, ICNS JPEG 2000 members; the
    chair's textures as a lossless JP2 and a lossy tiled J2K; the 2048 x 1536
    atlas as a lossless JP2 (5/3, RCT, 6 resolutions, LRCP) and a lossy J2K
    (9/7, ICT, 64 x 64 blocks, 512² tiles, precincts, 3 layers, RPCL)."""
    from PIL import Image

    def pil(image, **kw):
        buf = io.BytesIO()
        (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(
            buf, "JPEG2000", **kw)
        return buf.getvalue()

    rgb = seeded_rgb((37, 53), 200, noise=12)
    small = seeded_rgb((24, 31), 201, noise=12)
    planes = [rgb[..., c].astype(np.int32) for c in range(3)]
    rng = np.random.default_rng(202)
    tex = seeded_rgb((32, 32), 203, noise=4) // 16 * 16
    out = {
        "j2k_rgb_lossless.jp2": ("JPEG 2000 JP2 RGB, 5/3, RCT", pil(rgb)),
        "j2k_rgb_irreversible.jp2": ("JPEG 2000 JP2 RGB, 9/7, ICT", pil(rgb, irreversible=True)),
        "j2k_gray.j2k": ("JPEG 2000 codestream gray (no_jp2)", pil(rgb[..., 1], no_jp2=True)),
        "j2k_la.jp2": ("JPEG 2000 LA", pil(Image.fromarray(small[..., :2], "LA"))),
        "j2k_rgba_irreversible.jp2": ("JPEG 2000 RGBA, 9/7", pil(
            np.concatenate([small, small[..., :1] // 2 + 100], -1), irreversible=True)),
        "j2k_i16.jp2": ("JPEG 2000 I;16", pil(Image.frombytes(
            "I;16", (31, 24), (small[..., 0].astype("<u2") * 251).tobytes()))),
        "j2k_signed.j2k": ("JPEG 2000 signed", pil(small[..., 2], no_jp2=True, signed=True)),
        "j2k_no_mct.jp2": ("JPEG 2000 no MCT", pil(small, mct=0)),
        "j2k_plt_1res.j2k": ("JPEG 2000 PLT, one resolution", pil(small, no_jp2=True, plt=True,
                                                                  num_resolutions=1)),
        "j2k_tiles_offsets.j2k": ("JPEG 2000 tiles 16 x 12, tile and image offsets", pil(
            rgb, no_jp2=True, tile_size=(16, 12), tile_offset=(3, 5), offset=(7, 9),
            num_resolutions=3)),
        "j2k_cblk8_prec16.jp2": ("JPEG 2000 code-blocks 8 x 8, precincts 16 x 16", pil(
            rgb, codeblock_size=(8, 8), precinct_size=(16, 16), num_resolutions=3)),
        "j2k_layers_rates.j2k": ("JPEG 2000 quality layers by rate, 9/7", pil(
            rgb, no_jp2=True, irreversible=True, quality_mode="rates",
            quality_layers=[40, 15, 5])),
        "j2k_layers_db.jp2": ("JPEG 2000 quality layers by dB", pil(
            rgb, quality_mode="dB", quality_layers=[28, 36, 44])),
    }
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"j2k_{prog.lower()}.j2k"] = (f"JPEG 2000 progression {prog}, precincts, layers", pil(
            rgb, no_jp2=True, progression=prog, precinct_size=(16, 16), num_resolutions=3,
            quality_mode="rates", quality_layers=[30, 10, 3]))
    for mode, tag in ((1, "bypass"), (2, "reset"), (4, "termall"), (8, "vsc"), (16, "pterm"),
                      (32, "segsym"), (63, "all_styles")):
        out[f"j2k_style_{tag}.j2k"] = (f"JPEG 2000 code-block style {tag} (libopenjp2)",
                                       openjpeg_encode(planes, mode=mode, mct=1,
                                                       irreversible=int(mode == 63),
                                                       rates=(30, 10, 1)))
    for tag, pocs in (("rpcl_pcrl", [(0, 0, 2, 2, 3, 2), (0, 0, 3, 4, 3, 3)]),
                      ("rlcp_cprl", [(0, 0, 3, 4, 2, 1), (0, 2, 3, 4, 3, 4)]),
                      # packets no POC covers: libopenjp2 writes a stream it cannot read
                      ("refused_uncovered", [(0, 0, 2, 2, 3, 2), (0, 0, 3, 4, 2, 3),
                                             (1, 2, 3, 4, 3, 4)])):
        name = f"refused_j2k_poc_{tag[8:]}.j2k" if tag.startswith("refused") else \
            f"j2k_poc_{tag}.j2k"
        out[name] = (f"JPEG 2000 POC {tag.replace('_', ', ')} (libopenjp2)", openjpeg_encode(
            planes, rates=(20, 5, 1), numresolution=4, precincts=[(16, 16)] * 4, mct=1,
            pocs=pocs))
    sub = [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]]
    out["j2k_sycc420_rpcl.j2k"] = ("JPEG 2000 4:2:0 subsampled, RPCL (libopenjp2)",
                                   openjpeg_encode(sub, sub=[(1, 1), (2, 2), (2, 2)],
                                                   prog_order=2, numresolution=3,
                                                   precincts=[(16, 16)] * 3, rates=(10, 1),
                                                   color_space=3))
    out["j2k_sycc420_pcrl.jp2"] = ("JPEG 2000 JP2 sYCC 4:2:0, PCRL (libopenjp2)",
                                   openjpeg_encode(sub, sub=[(1, 1), (2, 2), (2, 2)],
                                                   prog_order=3, numresolution=3,
                                                   precincts=[(16, 16)] * 3, jp2=True,
                                                   color_space=3))
    out["j2k_roi.j2k"] = ("JPEG 2000 ROI maxshift (libopenjp2)", openjpeg_encode(
        planes, roi_compno=1, roi_shift=4, irreversible=1, mct=1, rates=(20, 1)))
    out["j2k_sop_eph.j2k"] = ("JPEG 2000 SOP and EPH markers (libopenjp2)", openjpeg_encode(
        planes, csty=6, mct=1, rates=(20, 5, 1)))
    out["j2k_signed12.j2k"] = ("JPEG 2000 12-bit signed gray (libopenjp2)", openjpeg_encode(
        [rng.integers(-2048, 2048, (20, 30))], prec=12, sgnd=True, numresolution=3))
    out["j2k_cmyk.jp2"] = ("JPEG 2000 JP2 CMYK (libopenjp2)", openjpeg_encode(
        [small[..., c].astype(np.int32) for c in (0, 1, 2, 0)], jp2=True, color_space=5,
        numresolution=3))
    layered = pil(rgb, no_jp2=True, progression="RLCP", precinct_size=(16, 16),
                  num_resolutions=3, quality_mode="rates", quality_layers=[30, 10, 3],
                  tile_size=(32, 32))
    out["j2k_ppm.j2k"] = ("JPEG 2000 packet headers in PPM", repack_headers(layered, "ppm"))
    out["j2k_ppt.j2k"] = ("JPEG 2000 packet headers in PPT", repack_headers(layered, "ppt"))
    idx = (small[..., 0] // 32).astype(np.uint8)
    pal = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    pal[5] = pal[2]                                # Pillow's palette drops the repeat
    out["j2k_palette.jp2"] = ("JPEG 2000 JP2 palette (pclr)", jp2_file(
        pil(idx, no_jp2=True), 24, 31, 1, 8, palette=pal))
    out["icns_jp2_member.icns"] = ("ICNS ic07 JPEG 2000 member", icns_file([
        (b"ic07", pil(seeded_rgb((64, 64), 204, noise=6), irreversible=True,
                      quality_mode="rates", quality_layers=[20]))]))
    out["icns_j2k_gray_member.icns"] = ("ICNS ic11 JPEG 2000 codestream member, gray",
                                        icns_file([(b"ic11", pil(small[:16, :16, 1],
                                                                 no_jp2=True))]))
    out["refused_j2k_truncated.j2k"] = ("JPEG 2000 cut short (refused)",
                                        pil(rgb, no_jp2=True)[:-400])
    out["chair_lossless.jp2"] = ("chair texture, JPEG 2000 lossless JP2", pil(tex[:, ::-1]))
    out["chair_lossy_tiles.j2k"] = ("chair texture, JPEG 2000 lossy tiled J2K", pil(
        tex[::-1], no_jp2=True, irreversible=True, tile_size=(16, 16), num_resolutions=3,
        quality_mode="rates", quality_layers=[8, 4]))
    atlas = texture_atlas(9)
    out["atlas_lossless_2048x1536.jp2"] = ("2048 x 1536 atlas, JPEG 2000 lossless JP2", pil(
        atlas, num_resolutions=6, progression="LRCP"))
    out["atlas_lossy_2048x1536.j2k"] = ("2048 x 1536 atlas, JPEG 2000 lossy J2K", pil(
        atlas, no_jp2=True, irreversible=True, codeblock_size=(64, 64), tile_size=(512, 512),
        precinct_size=(128, 128), quality_mode="rates", quality_layers=[600, 300, 150],
        progression="RPCL"))
    return out


def lab_and_pnm_formats() -> dict:
    """Lab images (PSD and CIELab TIFFs, both byte orders, raw, LZW,
    Deflate, PackBits) and Pillow's PNM magics (PFM both byte orders with
    NaN, infinities and out-of-range values; PyP, PyRGBA, PyCMYK, P0CMYK);
    the chair's textures as a Lab PSD, a CIELab TIFF and a PFM."""
    from PIL import Image

    def pil_tiff(lab, **kw):
        buf = io.BytesIO()
        Image.frombytes("LAB", lab.shape[1::-1], lab.tobytes()).save(buf, "TIFF", **kw)
        return buf.getvalue()

    rng = np.random.default_rng(210)
    lab = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    tex = seeded_rgb((32, 32), 211, noise=4) // 16 * 16
    pfm = (seeded_rgb((11, 13), 212)[..., 0].astype(np.float32) - 20) * 1.3
    pfm[0, :4] = [np.nan, np.inf, -np.inf, 1e9]
    out = {
        "lab_raw.psd": ("PSD Lab, raw", psd_file(np.ascontiguousarray(lab.transpose(2, 0, 1)),
                                                 9)),
        "lab_rle.psd": ("PSD Lab, PackBits", psd_file(np.ascontiguousarray(
            lab.transpose(2, 0, 1)), 9, rle=True)),
        "cielab_raw.tif": ("TIFF CIELab, raw", pil_tiff(lab)),
        "cielab_lzw.tif": ("TIFF CIELab, LZW", pil_tiff(lab, compression="tiff_lzw")),
        "cielab_deflate_be.tif": ("TIFF CIELab, big-endian, Deflate",
                                  tiff_file(lab, (8, 8, 8), 8, compression=8, big_endian=True)),
        "cielab_packbits_be.tif": ("TIFF CIELab, big-endian, PackBits, strips of 5",
                                   tiff_file(lab, (8, 8, 8), 8, compression=32773,
                                             big_endian=True, rows_per_strip=5)),
        "pfm_le.pfm": ("PFM (Pf), little-endian, NaN and infinities",
                       b"Pf\n13 11\n-1.0\n" + pfm[::-1].astype("<f4").tobytes()),
        "pfm_be.pfm": ("PFM (Pf), big-endian", b"Pf\n13 11\n2.5\n" + pfm[::-1].astype(
            ">f4").tobytes()),
        "pnm_pyp.ppm": ("PNM PyP", b"PyP\n13 11\n255\n" + lab[:11, :13, 0].tobytes()),
        "pnm_pyrgba.ppm": ("PNM PyRGBA, maxval 1000", b"PyRGBA 13 11 1000\n" + (
            lab[:11, :13, :].repeat(2, -1)[..., :4].astype(">u2") * 3).tobytes()),
        "pnm_pycmyk.ppm": ("PNM PyCMYK", b"PyCMYK\n13 11\n255\n" + lab[:11, :13].repeat(
            2, -1)[..., :4].tobytes()),
        "pnm_p0cmyk.ppm": ("PNM P0CMYK, maxval 31", b"P0CMYK\n13 11\n31\n" + (lab[:11, :13].repeat(
            2, -1)[..., :4] // 8).tobytes()),
        "refused_pfm_zero_scale.pfm": ("PFM with a scale of 0 (refused)",
                                       b"Pf\n2 2\n0.0\n" + bytes(16)),
        "chair_lab.psd": ("chair texture, PSD Lab", psd_file(np.ascontiguousarray(
            tex.transpose(2, 0, 1)), 9, rle=True)),
        "chair_cielab.tif": ("chair texture, TIFF CIELab", pil_tiff(tex[::-1],
                                                                    compression="tiff_lzw")),
        "chair.pfm": ("chair texture, PFM", b"Pf\n32 32\n-1.0\n" + tex[..., 1].astype(
            "<f4").tobytes()),
    }
    return out


def small_formats() -> dict:
    """SGI (RLE and verbatim 16-bit), PCX (and 4 bit planes), DCX, ICO (PNG
    and BMP members), CUR, QOI, XBM, IM (YCC, a Lut), ICNS (run-length
    members), BLP (BLP1 palette and JPEG, BLP2 DXT5), Sun raster (RLE,
    palette), MSP version 2, SPIDER and a bare DIB, small and posterised to
    stay small; the chair's textures in six of them; the 2048 x 1536 atlas
    as QOI and SGI RLE (stored gzip-compressed)."""
    from PIL import Image

    def pil(image, fmt, **kw):
        buf = io.BytesIO()
        (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(60)
    rgb = seeded_rgb((12, 20), 61, noise=6) // 32 * 32
    rgba = np.concatenate([rgb, np.where(rng.random((12, 20, 1)) < 0.8, 255, 40).astype(
        np.uint8)], -1)
    tex = seeded_rgb((24, 24), 62, noise=2) // 32 * 32
    tex_a = np.concatenate([tex, np.full((24, 24, 1), 255, np.uint8)], -1)
    idx4 = (rgb[..., 0] // 16).astype(np.uint8)
    p4 = np.concatenate([np.packbits((idx4 >> k) & 1, axis=1) for k in range(4)], 1)
    palette = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
    page = pil(rgb, "PCX")
    icon = Image.fromarray(tex_a[:16, :16])
    cur = pil(icon, "ICO", bitmap_format="bmp", sizes=[(16, 16)])
    jpg = pil(rgb, "JPEG", quality=80)
    out = {
        "sgi_rgb_rle.sgi": ("SGI RLE, RGB", sgi_file(rgb.transpose(2, 0, 1), rle=True)),
        "sgi_l16_raw.sgi": ("SGI verbatim, 2 bytes a channel, gray",
                            sgi_file(rgb[None, ..., 1].astype(np.uint16) * 255)),
        "pcx_rgb.pcx": ("PCX RGB", page),
        "pcx_p4_planes.pcx": ("PCX 4 bit planes (P)", pcx_file(p4, 20, 12, 1, 4,
                                                              palette16=palette[:48])),
        "dcx_two_pages.dcx": ("DCX, two PCX pages", dcx_file([page, pil(rgb[..., 2], "PCX")])),
        "ico_png.ico": ("ICO, PNG members", pil(rgba, "ICO", sizes=[(16, 16), (12, 12)])),
        "ico_bmp_p.ico": ("ICO, BMP member with AND mask", pil(
            Image.fromarray(rgb[:, :12]).convert("P", palette=Image.Palette.ADAPTIVE, colors=12),
            "ICO", bitmap_format="bmp", sizes=[(12, 12)])),
        "cur_bgra.cur": ("CUR, 32-bit BGRA", cur[:2] + b"\2" + cur[3:]),
        "qoi_rgba.qoi": ("QOI RGBA", pil(rgba, "QOI")),
        "xbm_hotspot.xbm": ("XBM with hot spot", pil(rgb[..., 0] > 100, "XBM").replace(
            b"#define im_height 12\n", b"#define im_height 12\n#define im_x_hot 2\n"
                                       b"#define im_y_hot 5\n")),
        "im_ycc.im": ("IM YCC (YCbCr)", pil(Image.fromarray(rgb).convert("YCbCr"), "IM")),
        "im_p_lut.im": ("IM Lut (P)", pil(Image.fromarray(rgb).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=7), "IM")),
        "icns_is32.icns": ("ICNS is32 RLE with s8mk mask", icns_file([
            (b"is32", icns_rgb(tex[:16, :16])),
            (b"s8mk", (tex[:16, :16, 1] // 2 + 100).tobytes())])),
        "blp1_palette.blp": ("BLP1 palette", pil(Image.fromarray(rgba).quantize(9), "BLP",
                                                 blp_version="BLP1")),
        "blp1_jpeg.blp": ("BLP1 JPEG", blp1_jpeg_file(jpg, 20, 12, 180, alpha_bits=8)),
        "blp2_dxt5.blp": ("BLP2 DXT5", blp2_file(20, 12, 2, bc_blocks(20, 12, 16, 63), 8, 7)),
        "sun_rle.ras": ("Sun raster RLE, 24-bit", sun_file(rgb[..., ::-1].reshape(12, -1), 20,
                                                           24, 2)),
        "sun_p8.ras": ("Sun raster 8-bit with colour map", sun_file(
            idx4, 20, 8, 1, colour_map=palette[:48])),
        "msp_v2.msp": ("MSP version 2 (RLE)", msp_file(rgb[..., 1] > 90)),
        "spider_be.spi": ("SPIDER big-endian float", spider_file(
            (rgb[:8, :10, 2].astype(np.float32) - 30) * 1.7)),
        "dib_rgb.dib": ("bare DIB (BMP without its file header)", pil(rgb, "DIB")),
        "refused_sgi_overrun.sgi": ("SGI RLE run past its row (refused)", _sgi_overrun(rgb)),
        "refused_blp2_raw_bgra.blp": ("BLP2 raw BGRA (refused)", blp2_file(
            4, 4, 3, rgba[:4, :4].tobytes(), 8)),
        "chair_rle.sgi": ("chair texture, SGI RLE", sgi_file(tex.transpose(2, 0, 1), rle=True)),
        "chair.pcx": ("chair texture, PCX", pil(tex[::-1], "PCX")),
        "chair.qoi": ("chair texture, QOI", pil(tex_a[:, ::-1], "QOI")),
        "chair.ico": ("chair texture, ICO", pil(tex.transpose(1, 0, 2), "ICO", sizes=[(24, 24)])),
        "chair_dxt5.blp": ("chair texture, BLP2 DXT5", blp2_file(24, 24, 2, _dxt5(tex_a), 8, 7)),
        "chair_rle.ras": ("chair texture, Sun raster RLE",
                          sun_file(tex[::-1, ::-1, ::-1].reshape(24, -1), 24, 24, 2)),
    }
    atlas = texture_atlas(9)
    out["atlas_2048x1536.qoi"] = ("2048 x 1536 atlas, QOI", pil(atlas, "QOI"))
    out["atlas_rle_2048x1536.sgi"] = ("2048 x 1536 atlas, SGI RLE",
                                      sgi_file(atlas.transpose(2, 0, 1), rle=True))
    return out


def rare_formats() -> dict:
    """FITS (every storage PIL reads, a GZIP_1 table), FLI and FLC (each
    chunk kind, a prefix chunk Pillow refuses), a PhotoCD base image, XPM
    (two-character keys with a transparent key, over 256 colours, a named
    colour refused), FTEX (DXT1 and raw), GIMP brushes, PIXAR, IM Tools,
    McIdas areas, an XV thumbnail, IPTC/NAA (raw, banded, JPEG) and tiled
    TIFFs at 1, 2 and 4 bits; the chair's textures in eleven of them; the
    2048 x 1536 atlas as an FLC (stored gzip-compressed) and a gzip FITS."""
    from PIL import Image

    rng = np.random.default_rng(80)
    rgb = seeded_rgb((12, 20), 81, noise=6) // 32 * 32
    gray = rgb[..., 1]
    idx = (gray // 16).astype(np.uint8)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    tex = seeded_rgb((24, 24), 82, noise=2) // 32 * 32
    tex_p = Image.fromarray(tex).quantize(16)
    tex_idx = np.asarray(tex_p)
    tex_pal = np.asarray(tex_p.getpalette()[:48], np.uint8).reshape(16, 3)
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "JPEG", quality=85)
    gray_jpeg = buf.getvalue()
    ycc = np.zeros((512, 768, 3), np.uint8)
    yy, xx = np.mgrid[:512, :768]
    ycc[..., 0] = (40 + 150 * xx / 768 + 30 * np.sin(yy / 40)) // 8 * 8
    ycc[..., 1] = (156 + 40 * np.cos(xx / 90)) // 8 * 8
    ycc[..., 2] = (137 + 50 * np.sin(yy / 70)) // 8 * 8
    colours = [f"#{r:02X}{g:02X}{b:02X}" for r, g, b in palette[:6]] + ["None"]
    many = [f"#{v:06x}" for v in rng.integers(0, 1 << 24, 300)]
    levels = {b: (gray >> (8 - b)).astype(np.uint8) for b in (1, 2, 4)}
    out = {
        "fits_f32.fits": ("FITS BITPIX -32 (PIL's little-endian read)",
                          fits_file(gray.astype(np.float32) * 1.7 - 30, -32)),
        "fits_i16_cube.fits": ("FITS BITPIX 16, NAXIS 3, in an IMAGE extension",
                               fits_file(gray.astype(np.int64) * 97 - 500, 16, planes=2,
                                         extension=True)),
        "fits_gzip_l.fits": ("FITS GZIP_1 binary table, BITPIX 8", fits_gzip_file(gray, 8)),
        "fli_brun_color.fli": ("FLI BRUN with a COLOR (6-bit) palette", fli_file(
            [(11, fli_color(palette[:64], 11)), (15, fli_brun(idx))], 20, 12, flc=False)),
        "flc_lc_ss2.flc": ("FLC LC and SS2 over COLOR256, a stamp", fli_file(
            [(4, fli_color(palette)), (18, bytes(8)), (12, fli_lc(idx, 2)),
             (7, fli_ss2(idx[:, ::-1], 3))], 20, 12)),
        "flc_black_copy.flc": ("FLC BLACK and COPY", fli_file(
            [(16, idx[::-1].tobytes()), (13, bytes(4)), (16, idx.tobytes())], 20, 12)),
        "refused_flc_prefix.flc": ("FLC with a prefix chunk (refused)", fli_file(
            [(15, fli_brun(idx))], 20, 12, prefix=b"seed")),
        "pcd_base.pcd": ("Kodak PhotoCD base image, rotated 270", pcd_file(ycc, 3)),
        "xpm_two_char.xpm": ("XPM two-character keys, None", xpm_file(
            idx % 6, colours, 2)),
        "xpm_rgb_300.xpm": ("XPM of 300 colours (RGB)", xpm_file(
            rng.integers(0, 300, (12, 20)), many, 2, pixels_line=True)),
        "refused_xpm_named.xpm": ("XPM named colour (refused)", xpm_file(
            idx % 3, colours[:2] + ["red"], 1)),
        "ftex_dxt1.ftc": ("FTEX DXT1", ftex_file(20, 12, 0, bc_blocks(20, 12, 8, 83))),
        "ftex_rgb.ftu": ("FTEX uncompressed", ftex_file(20, 12, 1, rgb.tobytes())),
        "gbr_v1.gbr": ("GIMP brush version 1, gray", gbr_file(gray, 1)),
        "gbr_v2_rgba.gbr": ("GIMP brush version 2, RGBA", gbr_file(np.concatenate(
            [rgb, rgb[..., :1] // 2 + 100], -1), 2)),
        "pixar.pxr": ("PIXAR RGB", pixar_file(rgb)),
        "imt.imt": ("IM Tools", imt_file(gray)),
        "mcidas_i16.area": ("McIdas area, 2 bytes, row prefix", mcidas_file(
            gray.astype(np.int64) * 131, 2, prefix=4)),
        "mcidas_i32.area": ("McIdas area, 4 bytes, two bands", mcidas_file(
            gray.astype(np.int64) * 40000 - 10 ** 6, 4, bands=2)),
        "xv_thumb.xv": ("XV thumbnail (P 3-3-2)", xv_file(
            ((rgb[..., 0] >> 5) << 5 | (rgb[..., 1] >> 5) << 2 | rgb[..., 2] >> 6).astype(
                np.uint8))),
        "iptc_raw_l.iptc": ("IPTC/NAA raw L in two fields", iptc_file(
            20, 12, gray.tobytes(), split=100)),
        "iptc_rgb_band.iptc": ("IPTC/NAA RGB, band 2", iptc_file(
            20, 12, gray.tobytes(), 3, 1, band=2)),
        "iptc_jpeg.iptc": ("IPTC/NAA JPEG", iptc_file(20, 12, gray_jpeg, compression=5)),
        "tiff_tiled_1bit_packbits.tif": ("TIFF tiled 1-bit, PackBits", subbyte_tiled_tiff(
            levels[1], 1, (16, 8), 32773, 0)),
        "tiff_tiled_p2_lzw.tif": ("TIFF tiled 2-bit palette, LZW", subbyte_tiled_tiff(
            levels[2], 2, (16, 16), 5, 3, colormap=palette[:4])),
        "tiff_tiled_l4_raw_fill2.tif": ("TIFF tiled 4-bit gray, raw, fill order 2",
                                        subbyte_tiled_tiff(levels[4], 4, (16, 8), 1, 1,
                                                           fill_order=2)),
        "chair.xpm": ("chair texture, XPM", xpm_file(tex_idx, [
            f"#{r:02x}{g:02x}{b:02x}" for r, g, b in tex_pal], 1)),
        "chair_dxt1.ftc": ("chair texture, FTEX DXT1", ftex_file(24, 24, 0, _dxt1(tex))),
        "chair_rgba.gbr": ("chair texture, GIMP brush RGBA", gbr_file(np.concatenate(
            [tex[::-1], np.full((24, 24, 1), 255, np.uint8)], -1))),
        "chair.pxr": ("chair texture, PIXAR", pixar_file(tex[:, ::-1])),
        "chair.flc": ("chair texture, FLC BRUN", fli_file(
            [(4, fli_color(tex_pal)), (15, fli_brun(tex_idx.T))], 24, 24)),
        "chair_i16.area": ("chair texture, McIdas 2 bytes", mcidas_file(
            tex[..., 0].astype(np.int64), 2)),
        "chair.fits": ("chair texture, FITS", fits_file(tex[..., 1], 8)),
        "chair.xv": ("chair texture, XV thumbnail", xv_file(
            ((tex[..., 0] >> 5) << 5 | (tex[..., 1] >> 5) << 2 | tex[..., 2] >> 6).astype(
                np.uint8))),
        "chair.iptc": ("chair texture, IPTC/NAA", iptc_file(24, 24, tex[..., 2].tobytes())),
        "chair_tiled_1bit.tif": ("chair texture, TIFF tiled 1-bit, LZW", subbyte_tiled_tiff(
            (tex[..., 1] > 100).astype(np.uint8), 1, (16, 16), 5, 1)),
    }
    atlas = texture_atlas(9)
    gray_atlas = np.asarray(Image.fromarray(atlas).convert("L"))
    out["atlas_2048x1536.flc"] = ("2048 x 1536 atlas, FLC BRUN", fli_file(
        [(4, fli_color(np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1))),
         (15, fli_brun(gray_atlas))], 2048, 1536))
    out["atlas_gzip_2048x1536.fits"] = ("2048 x 1536 atlas, FITS GZIP_1",
                                        fits_gzip_file(gray_atlas, 8))
    return out


def avif_file(image: np.ndarray, **kw) -> bytes:
    """Pillow's AVIF writer (libavif 1.3.0 over aom 3.12.1) on ``image``."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "AVIF", **kw)
    return buf.getvalue()


def avif_nclx(data: bytes, matrix: int, full: int) -> bytes:
    """``data`` with its ``colr`` ``nclx`` box's matrix_coefficients and
    full_range_flag set (the AV1 planes unchanged: libavif takes the box's
    values over the sequence header's)."""
    at = data.index(b"colrnclx") + 8
    out = bytearray(data)
    out[at + 4:at + 6] = matrix.to_bytes(2, "big")
    out[at + 6] = (out[at + 6] & 0x7F) | (0x80 if full else 0)
    return bytes(out)


def avif_alpha_limited(data: bytes) -> bytes:
    """``data`` with its alpha item's AV1 sequence header set to limited
    range: the ``color_range`` bit of its reduced, monochrome
    ``color_config`` cleared (aom through libavif writes full-range alpha
    only; libavif maps a limited-range alpha plane to full range). The
    alpha item is found as the one monochrome sequence header, so the
    colour item must not be 4:0:0."""
    out = bytearray(data)

    def mono_range_bit(pos: int):
        """The color_range bit's offset of the sequence header whose
        payload starts at byte ``pos``, or None where it is not a reduced
        monochrome one (a colour item's, or tile data that looked like one)."""
        def bits(n: int) -> int:
            nonlocal pos
            value = 0
            for _ in range(n):
                value = value << 1 | (out[pos >> 3] >> (7 - (pos & 7))) & 1
                pos += 1
            return value

        pos *= 8
        profile, _, reduced, _ = bits(3), bits(1), bits(1), bits(5)
        if profile or not reduced:
            return None
        width_bits, height_bits = bits(4) + 1, bits(4) + 1
        bits(width_bits + height_bits + 6)      # max sizes, six tool flags
        if bits(1) or not bits(1):              # high_bitdepth, mono_chrome
            return None
        if bits(1):                             # color_description_present_flag
            bits(24)
        return pos

    # each item's temporal delimiter OBU, then its sequence header OBU
    starts = [k + 4 for k in range(data.index(b"mdat"), len(data) - 5)
              if data[k:k + 3] == b"\x12\x00\x0a" and data[k + 3] < 0x80]
    found = [bit for bit in map(mono_range_bit, starts) if bit is not None]
    assert len(found) == 1, found
    bit = found[0]
    assert out[bit >> 3] >> (7 - (bit & 7)) & 1    # full range
    out[bit >> 3] &= ~(0x80 >> (bit & 7)) & 0xFF
    return bytes(out)


# the creation and modification time (seconds since 1904) of the committed
# avis-derived fixture's mvhd, tkhd and mdhd boxes
AVIS_TIME = 3875178990


def avis_times(data: bytes, seconds: int = AVIS_TIME) -> bytes:
    """``data`` (an avis file from libavif) with the creation and
    modification times of its mvhd, tkhd and mdhd boxes set to ``seconds``:
    libavif writes the time of the call there."""
    out = bytearray(data)
    for box in (b"mvhd", b"tkhd", b"mdhd"):
        at = out.index(box) + 4
        if out[at] == 1:            # version 1: 64-bit times
            out[at + 4:at + 20] = struct.pack(">QQ", seconds, seconds)
        else:
            out[at + 4:at + 12] = struct.pack(">II", seconds, seconds)
    return bytes(out)


# the aom tool switches of Pillow's ``advanced`` option, one fixture each
AVIF_TOOL_SWITCHES = ("enable-cfl-intra", "enable-filter-intra", "enable-intra-edge-filter",
                      "enable-smooth-intra", "enable-paeth-intra", "enable-angle-delta")


def avif_formats() -> dict:
    """Lossless AVIFs (``quality=100``: coded-lossless AV1 frames) of seeded
    smooth-plus-noise images, which aom codes without screen content tools:
    4:4:4, 4:2:2, 4:2:0 and 4:0:0 at full and limited range and odd sizes,
    RGBA with a lossless alpha item (premultiplied, and of limited range),
    two tile columns, two by two tiles, 128
    x 128 superblocks, an Exif orientation (irot), one file per aom
    tool switched off, speeds 0 and 10, no CDF update, tiles of explicit
    spacing, a full (not reduced) sequence header, the BT.709, BT.2020 and identity
    matrices (the ``nclx`` box rewritten), the chair's two AVIF textures and
    the 2048 x 1536 atlas at 4:2:0 (with seeded noise of sigma 2, 1.48 MB)."""
    from PIL import Image

    out = {}
    sizes = {"444": (37, 53), "422": (29, 43), "420": (35, 47), "400": (31, 45)}
    for k, (tag, shape) in enumerate(sizes.items()):
        sub = f"{tag[0]}:{tag[1]}:{tag[2]}"
        for rng_, tail in (("full", ""), ("limited", "_limited")):
            out[f"avif_{tag}{tail}_{shape[1]}x{shape[0]}.avif"] = (
                f"AVIF lossless {sub}, {rng_} range, odd size",
                avif_file(seeded_rgb(shape, 400 + k, noise=8), quality=100, subsampling=sub,
                          range=rng_))
    rng = np.random.default_rng(410)
    rgb = seeded_rgb((41, 59), 411, noise=8)
    alpha = np.clip(rgb[..., 1].astype(int) + rng.integers(-30, 30, rgb.shape[:2]), 0,
                    255).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    out["avif_rgba_444.avif"] = ("AVIF lossless RGBA 4:4:4, a lossless alpha item",
                                 avif_file(rgba, quality=100, subsampling="4:4:4"))
    out["avif_rgba_420.avif"] = ("AVIF lossless RGBA 4:2:0, a lossless alpha item",
                                 avif_file(rgba, quality=100, subsampling="4:2:0"))
    out["avif_rgba_400_limited.avif"] = ("AVIF lossless RGBA 4:0:0, limited range (libyuv's "
                                         "I400 row)", avif_file(rgba, quality=100,
                                                               subsampling="4:0:0",
                                                               range="limited"))
    out["avif_rgba_premultiplied.avif"] = (
        "AVIF lossless RGBA 4:2:0, premultiplied alpha (a prem reference; libyuv's "
        "ARGBUnattenuate)", avif_file(rgba, quality=100, alpha_premultiplied=True))
    out["avif_rgba_limited_alpha.avif"] = (
        "AVIF lossless RGBA 4:4:4, a limited-range alpha item (its sequence header's "
        "color_range cleared)", avif_alpha_limited(avif_file(rgba, quality=100,
                                                             subsampling="4:4:4")))
    big = seeded_rgb((150, 270), 412, noise=8)
    out["avif_tile_cols.avif"] = ("AVIF lossless, two tile columns",
                                  avif_file(big, quality=100, tile_cols=1))
    out["avif_tiles_2x2.avif"] = ("AVIF lossless, two by two tiles",
                                  avif_file(big, quality=100, subsampling="4:4:4", tile_rows=1,
                                            tile_cols=1))
    out["avif_sb128.avif"] = ("AVIF lossless, 128 x 128 superblocks (aom's sb-size 128)",
                              avif_file(seeded_rgb((133, 201), 413, noise=8), quality=100,
                                        advanced={"sb-size": "128"}))
    exif = Image.Exif()
    exif[0x0112] = 6
    out["avif_exif_orientation6.avif"] = ("AVIF lossless, Exif orientation 6 (an irot property)",
                                          avif_file(seeded_rgb((27, 39), 414, noise=8),
                                                    quality=100, exif=exif.tobytes()))
    for k, switch in enumerate(AVIF_TOOL_SWITCHES):
        out[f"avif_no_{switch[7:].replace('-', '_')}.avif"] = (
            f"AVIF lossless, aom {switch}=0", avif_file(seeded_rgb((40, 56), 420 + k, noise=8),
                                                        quality=100, advanced={switch: "0"}))
    for speed in (0, 10):
        out[f"avif_speed{speed}.avif"] = (f"AVIF lossless, aom speed {speed}", avif_file(
            seeded_rgb((70, 90), 430 + speed, noise=8), quality=100, speed=speed))
    out["avif_no_cdf_update.avif"] = ("AVIF lossless, disable_cdf_update (aom cdf-update-mode=0)",
                                      avif_file(seeded_rgb((36, 52), 435, noise=8), quality=100,
                                                advanced={"cdf-update-mode": "0"}))
    out["avif_explicit_tiles.avif"] = ("AVIF lossless, two tiles of explicit (non-uniform) "
                                       "spacing (aom tile-width, tile-height)", avif_file(
                                           seeded_rgb((64, 96), 436, noise=8), quality=100,
                                           advanced={"tile-width": "1", "tile-height": "1"}))
    frames = [Image.fromarray(seeded_rgb((34, 50), 437 + k, noise=8)) for k in range(2)]
    seq = io.BytesIO()
    frames[0].save(seq, "AVIF", quality=100, save_all=True, append_images=frames[1:])
    seq = avis_times(seq.getvalue())
    at = seq.index(b"ftypavis") + 4
    out["avif_full_sequence_header.avif"] = (
        "AVIF lossless, a full sequence header (an avis file's still item, its major brand "
        "rewritten to avif)", seq[:at] + b"avif" + seq[at + 4:])
    base444 = avif_file(seeded_rgb((33, 49), 440, noise=8), quality=100, subsampling="4:4:4")
    base420 = avif_file(seeded_rgb((33, 49), 441, noise=8), quality=100)
    out["avif_identity_444.avif"] = ("AVIF lossless, identity matrix (GBR)",
                                     avif_nclx(base444, 0, 1))
    for matrix, tag in ((1, "bt709"), (9, "bt2020")):
        out[f"avif_{tag}_420.avif"] = (f"AVIF lossless, {tag} matrix, full range",
                                       avif_nclx(base420, matrix, 1))
        out[f"avif_{tag}_limited_420.avif"] = (f"AVIF lossless, {tag} matrix, limited range",
                                               avif_nclx(base420, matrix, 0))
    tex = seeded_rgb((48, 48), 450, noise=8)
    out["chair_lossless_420.avif"] = ("chair texture, AVIF lossless 4:2:0",
                                      avif_file(tex, quality=100))
    tex_alpha = np.concatenate([tex, np.clip(
        230 - tex[..., 2:] // 4 + rng.integers(-12, 12, (48, 48, 1)), 0, 255).astype(np.uint8)],
        -1)
    out["chair_rgba.avif"] = ("chair texture, AVIF lossless RGBA", avif_file(
        tex_alpha, quality=100, subsampling="4:4:4"))
    noisy = texture_atlas(9) + np.random.default_rng(451).normal(0, 2, (1536, 2048, 3))
    out["atlas_lossless_2048x1536.avif"] = ("2048 x 1536 atlas, AVIF lossless 4:2:0", avif_file(
        np.clip(noisy, 0, 255).astype(np.uint8), quality=100))
    out.update(avif_lossy_formats())
    out.update(avif_restored_formats())
    out.update(avif_screen_formats())
    out.update(avif_qm_grain_formats())
    return out


def seeded_bars(shape: tuple, seed: int, count: int, thick: tuple, length: tuple) -> np.ndarray:
    """(H, W, 3) uint8: ``count`` seeded bars, upright or lying, of a
    thickness and length drawn from the two [low, high) ranges, in flat
    colours on grey, with noise of sigma 3; long thin bars draw aom to 1:4
    partitions."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.full((h, w, 3), 128.0)
    for _ in range(count):
        y, x = rng.integers(0, h), rng.integers(0, w)
        t, n = rng.integers(*thick), rng.integers(*length)
        if rng.random() < 0.5:
            img[y:y + n, x:x + t] = rng.integers(0, 255, 3)
        else:
            img[y:y + t, x:x + n] = rng.integers(0, 255, 3)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def avif_lossy_formats() -> dict:
    """Lossy AVIFs as Pillow writes them (aom at speeds 5 to 10, no CDEF, loop
    restoration or quantizer matrices): qualities 99, 90, 75 (Pillow's
    default) and 30, which reach the four coefficient q contexts; speeds 5
    (transforms of 64 points), 7 and 10; 4:4:4, 4:2:2, 4:2:0 and 4:0:0 at odd
    sizes; RGBA with a lossy alpha item; two by two tiles; 128 x 128
    superblocks; delta q (aom's deltaq-mode=3); the reduced transform set;
    a loop filter sharpness; transforms of 4:1 shape (speed 4 with loop
    restoration off: aom tries 1:4 partitions only below speed 5); the
    chair's lossy texture and the 2048 x 1536 atlas at Pillow's defaults."""
    out = {}
    for k, quality in enumerate((99, 90, 75, 30)):
        out[f"avif_lossy_q{quality}_96x72.avif"] = (
            f"AVIF lossy, quality {quality}", avif_file(seeded_rgb((72, 96), 470, noise=8),
                                                        quality=quality))
    out["avif_lossy_speed5_224x160.avif"] = (
        "AVIF lossy, aom speed 5, quality 30 (64-point transforms)",
        avif_file(seeded_rgb((160, 224), 480, noise=0.5), quality=30, speed=5))
    for speed in (7, 10):
        out[f"avif_lossy_speed{speed}.avif"] = (f"AVIF lossy, aom speed {speed}", avif_file(
            seeded_rgb((72, 96), 471, noise=8), speed=speed))
    sizes = {"444": (37, 53), "422": (29, 43), "420": (35, 47), "400": (31, 45)}
    for k, (tag, shape) in enumerate(sizes.items()):
        sub = f"{tag[0]}:{tag[1]}:{tag[2]}"
        out[f"avif_lossy_{tag}_{shape[1]}x{shape[0]}.avif"] = (
            f"AVIF lossy {sub}, odd size", avif_file(seeded_rgb(shape, 490 + k, noise=8),
                                                     subsampling=sub))
    rng = np.random.default_rng(495)
    rgb = seeded_rgb((41, 59), 496, noise=8)
    alpha = np.clip(rgb[..., 1].astype(int) + rng.integers(-30, 30, rgb.shape[:2]), 0,
                    255).astype(np.uint8)
    out["avif_lossy_rgba.avif"] = ("AVIF lossy RGBA, a lossy alpha item",
                                   avif_file(np.concatenate([rgb, alpha[..., None]], -1)))
    out["avif_lossy_tiles_2x2.avif"] = ("AVIF lossy, two by two tiles", avif_file(
        seeded_rgb((150, 270), 475, noise=8), tile_rows=1, tile_cols=1))
    out["avif_lossy_sb128.avif"] = ("AVIF lossy, 128 x 128 superblocks (aom's sb-size 128)",
                                    avif_file(seeded_rgb((133, 201), 474, noise=8),
                                              advanced={"sb-size": "128"}))
    out["avif_lossy_deltaq.avif"] = ("AVIF lossy, delta q (aom's deltaq-mode=3)", avif_file(
        seeded_rgb((128, 160), 473, noise=8), advanced={"deltaq-mode": "3"}))
    out["avif_lossy_reduced_tx_set.avif"] = (
        "AVIF lossy, the reduced transform set (aom's reduced-tx-type-set=1)",
        avif_file(seeded_rgb((72, 96), 476, noise=8), advanced={"reduced-tx-type-set": "1"}))
    out["avif_lossy_sharpness.avif"] = (
        "AVIF lossy, quality 40, loop filter sharpness 4 (aom's sharpness=4)",
        avif_file(seeded_rgb((72, 96), 477, noise=8), quality=40, advanced={"sharpness": "4"}))
    out["avif_lossy_tx4to1_224x160.avif"] = (
        "AVIF lossy, quality 30, aom speed 4 without loop restoration: 4 x 16, 16 x 4, 8 x 32 "
        "and 32 x 8 transforms, deblocked", avif_file(
            seeded_bars((160, 224), 9, 20, (14, 20), (60, 80)), quality=30, speed=4,
            advanced={"enable-restoration": "0"}))
    out["chair_lossy.avif"] = ("chair texture, AVIF lossy at Pillow's defaults",
                               avif_file(seeded_rgb((48, 48), 452, noise=8)))
    noisy = texture_atlas(9) + np.random.default_rng(451).normal(0, 2, (1536, 2048, 3))
    out["atlas_lossy_2048x1536.avif"] = ("2048 x 1536 atlas, AVIF lossy at Pillow's defaults",
                                         avif_file(np.clip(noisy, 0, 255).astype(np.uint8)))
    return out


def seeded_patchwork(size: int, seed: int, noise: float) -> np.ndarray:
    """(size, size, 3) uint8: :func:`seeded_bars` and :func:`seeded_rgb` in
    alternate squares of 80 pixels, which draws aom at speeds 0 to 2 to
    many CDEF strengths, switchable restoration and 1:4 splits of 64 x 64
    blocks."""
    bars = seeded_bars((size, size), 60 + seed, 80 * size * size // 102400, (2, 50), (10, 250))
    smooth = seeded_rgb((size, size), 70 + seed, noise=noise)
    yy, xx = np.mgrid[:size, :size]
    return np.where(((xx // 80 + yy // 80 + seed) % 2)[..., None] == 1, bars, smooth)


def avif_restored_formats() -> dict:
    """Lossy AVIFs whose AV1 frames Pillow's writer (aom 3.12.1) codes with
    CDEF (aom's enable-cdef=1) or loop restoration (speeds 0 to 4), or both:
    CDEF at cdef_bits 0, 1 and 2, in 4:4:4, 4:2:2, 4:2:0 and 4:0:0 at odd
    sizes, with 128 x 128 superblocks and with two by two tiles; Wiener
    restoration on every plane, self-guided on every plane, the two mixed
    per plane, at qualities 30 and 90, and with two by two tiles (units
    across tile edges); CDEF with restoration at speed 0; switchable
    restoration; CDEF at cdef_bits 3; TX_16X64 and TX_64X16 transforms;
    RGBA whose alpha item is restored; the chair's restored texture and the
    2048 x 1536 atlas at speed 4 with CDEF (also a TX_64X16 transform). Each
    file's purpose is asserted from the decoder's counters in the AVIF
    tests."""
    cdef = {"enable-cdef": "1"}
    out = {}
    sizes = {"444": ((37, 53), 6), "422": ((29, 43), 5), "420": ((35, 47), 8),
             "400": ((31, 45), 7)}
    for tag, (shape, seed) in sizes.items():
        sub = f"{tag[0]}:{tag[1]}:{tag[2]}"
        out[f"avif_restored_cdef_{tag}_{shape[1]}x{shape[0]}.avif"] = (
            f"AVIF lossy {sub}, odd size, CDEF", avif_file(seeded_rgb(shape, seed, noise=8),
                                                           subsampling=sub, advanced=cdef))
    out["avif_restored_cdef_bits1.avif"] = ("AVIF lossy, CDEF, cdef_bits 1", avif_file(
        seeded_rgb((96, 128), 3, noise=8), advanced=cdef))
    out["avif_restored_cdef_bits2_sgrproj.avif"] = (
        "AVIF lossy, quality 50, aom speed 1, CDEF at cdef_bits 2 and self-guided restoration "
        "on every plane", avif_file(seeded_bars((320, 320), 42, 60, (2, 40), (10, 200)),
                                    quality=50, speed=1, advanced=cdef))
    out["avif_restored_cdef_sb128.avif"] = (
        "AVIF lossy, quality 50, CDEF with 128 x 128 superblocks", avif_file(
            seeded_rgb((133, 201), 17, noise=8), quality=50, advanced=dict(cdef, **{"sb-size": "128"})))
    out["avif_restored_cdef_tiles_2x2.avif"] = (
        "AVIF lossy, quality 50, CDEF over two by two tiles", avif_file(
            seeded_rgb((150, 270), 475, noise=8), quality=50, tile_rows=1, tile_cols=1,
            advanced=cdef))
    out["avif_restored_wiener.avif"] = ("AVIF lossy, aom speed 4, Wiener restoration on every "
                                        "plane", avif_file(seeded_rgb((256, 320), 1, noise=2),
                                                           speed=4))
    out["avif_restored_sgrproj.avif"] = (
        "AVIF lossy, quality 60, aom speed 0, self-guided restoration on every plane",
        avif_file(seeded_bars((256, 320), 22, 40, (4, 30), (20, 120)), quality=60, speed=0))
    out["avif_restored_mixed_speed4.avif"] = (
        "AVIF lossy, quality 60, aom speed 4, restoration types mixed per plane (none, Wiener, "
        "self-guided)", avif_file(seeded_rgb((96, 128), 186, noise=30), quality=60, speed=4))
    out["avif_restored_mixed_speed0.avif"] = (
        "AVIF lossy, quality 60, aom speed 0, restoration types mixed per plane (self-guided, "
        "Wiener, Wiener)", avif_file(seeded_rgb((96, 128), 174, noise=30), quality=60, speed=0))
    out["avif_restored_q30.avif"] = ("AVIF lossy, quality 30, aom speed 4, loop restoration",
                                     avif_file(seeded_rgb((131, 145), 8, noise=8), quality=30,
                                               speed=4))
    out["avif_restored_q90.avif"] = ("AVIF lossy, quality 90, aom speed 4, loop restoration",
                                     avif_file(seeded_rgb((128, 160), 201, noise=2), quality=90,
                                               speed=4))
    out["avif_restored_tiles_2x2.avif"] = (
        "AVIF lossy, aom speed 4, loop restoration over two by two tiles (units across tile "
        "edges)", avif_file(seeded_rgb((256, 320), 1, noise=2), speed=4, tile_rows=1,
                            tile_cols=1))
    out["avif_restored_cdef_lr_270x150.avif"] = (
        "AVIF lossy, aom speed 0, CDEF with loop restoration", avif_file(
            seeded_rgb((150, 270), 476, noise=8), speed=0, advanced=cdef))
    out["avif_restored_switchable.avif"] = (
        "AVIF lossy, quality 40, aom speed 0, CDEF and switchable loop restoration", avif_file(
            seeded_patchwork(320, 0, 28), quality=40, speed=0, advanced=cdef))
    out["avif_restored_cdef_bits3.avif"] = (
        "AVIF lossy, quality 72, aom speed 2, CDEF at cdef_bits 3", avif_file(
            seeded_patchwork(320, 3, 10), quality=72, speed=2, advanced=cdef))
    out["avif_restored_tx16x64.avif"] = (
        "AVIF lossy, quality 27, aom speed 0, CDEF and restoration, 16 x 64 and 64 x 16 "
        "transforms", avif_file(seeded_patchwork(320, 5, 24), quality=27, speed=0,
                                advanced=cdef))
    rgb = seeded_rgb((96, 128), 496, noise=4)
    yy, xx = np.mgrid[:96, :128]
    wave = 128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    alpha = np.clip(wave + np.random.default_rng(495).normal(0, 4, wave.shape), 0, 255)
    out["avif_restored_rgba.avif"] = (
        "AVIF lossy RGBA, aom speed 4, a restored alpha item", avif_file(
            np.concatenate([rgb, alpha.astype(np.uint8)[..., None]], -1), speed=4))
    out["chair_restored.avif"] = ("chair texture, AVIF lossy, aom speed 0, CDEF with loop "
                                  "restoration", avif_file(seeded_rgb((48, 48), 452, noise=8),
                                                           speed=0, advanced=cdef))
    noisy = texture_atlas(9) + np.random.default_rng(451).normal(0, 2, (1536, 2048, 3))
    out["atlas_restored_2048x1536.avif"] = (
        "2048 x 1536 atlas, AVIF lossy, aom speed 4, CDEF with loop restoration",
        avif_file(np.clip(noisy, 0, 255).astype(np.uint8), speed=4, advanced=cdef))
    return out


def seeded_flat(shape: tuple, seed: int, colours: int = 4) -> np.ndarray:
    """(H, W, 3) uint8: ``colours`` flat colours in seeded rectangles over a
    ground of the first, as a CAD part's texture is painted; aom codes such
    an image with palette mode."""
    rng = np.random.default_rng(seed)
    h, w = shape
    palette = rng.integers(0, 256, (colours, 3))
    labels = np.zeros((h, w), np.int64)
    for k in range(3 * colours):
        y, x = rng.integers(0, h), rng.integers(0, w)
        labels[y:y + rng.integers(4, max(5, h // 2)), x:x + rng.integers(4, max(5, w // 2))] = \
            k % colours
    return palette[labels].astype(np.uint8)


def seeded_posterised(shape: tuple, seed: int, levels: int = 6, period: int = 64) -> np.ndarray:
    """(H, W, 3) uint8: a seeded oblique gradient between two colours that
    repeats every ``period`` samples, posterised to ``levels`` bands."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    a, b = rng.uniform(0.5, 1.5, 2)
    band = np.floor((a * xx + b * yy) % period / period * levels) / (levels - 1)
    lo, hi = rng.integers(0, 256, (2, 3))
    return (lo + (hi - lo) * band[..., None]).astype(np.uint8)


def seeded_glyphs(shape: tuple, seed: int, glyphs: int = 4, pitch: tuple = (10, 6),
                  ink: tuple = (30, 30, 30), paper: tuple = (235, 235, 235),
                  altered: float = 0.0) -> np.ndarray:
    """(H, W, 3) uint8: lines of text, like a label or a decal: ``glyphs``
    seeded 7 x 5 letters in ``ink`` on ``paper`` at a ``pitch`` of (line,
    letter), a letter left out at random. Repeated letters draw aom to intra
    block copy (where the frame holds a superblock five 64 x 64 superblocks
    back in raster order, INTRABC_DELAY_SB64, so at least 129 samples wide
    or tall) and to palette mode. With ``altered`` > 0 the ink darkens by 12
    a line, in three steps, and that share of the letters has one sample
    turned, so that copies leave residuals."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(0, 2, (glyphs, 7, 5)).astype(bool)
    img = np.empty(shape + (3,), np.uint8)
    img[:] = paper
    for y in range(1, shape[0] - 7, pitch[0]):
        shade = np.clip(np.array(ink) + 12 * ((y // pitch[0]) % 3 if altered else 0), 0, 255)
        for x in range(1, shape[1] - 5, pitch[1]):
            if rng.random() < 0.85:
                letter = letters[rng.integers(glyphs)].copy()
                if altered and rng.random() < altered:
                    letter[rng.integers(7), rng.integers(5)] ^= True
                img[y:y + 7, x:x + 5][letter] = shade
    return img


def seeded_patchwork_palette(shape: tuple, seed: int) -> np.ndarray:
    """(H, W, 3) uint8: 16 x 16 squares each in 2 to 8 colours of its own
    (seeded stripes and dots on a ground), so that aom's palettes reach every
    size in luma and chroma."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.empty((h, w, 3), np.uint8)
    for y in range(0, h, 16):
        for x in range(0, w, 16):
            n = 2 + (y // 16 * 3 + x // 16) % 7
            cols = rng.integers(0, 256, (n, 3))
            labels = rng.integers(0, n, (4, 4)).repeat(4, 0).repeat(4, 1)
            img[y:y + 16, x:x + 16] = cols[labels][:h - y, :w - x]
    return img


def avif_screen_formats() -> dict:
    """AVIFs whose AV1 frames Pillow's writer (aom 3.12.1) codes with the
    screen content tools, which aom turns on for flat content at any
    quality: palette mode (a flat 4-colour texture at Pillow's defaults, a
    posterised gradient at quality 90 in 4:4:4 and 4:2:2, the flat texture
    coded-lossless, a patchwork of 2- to 8-colour squares whose palettes
    reach every size in luma and chroma, a flat RGBA texture whose alpha
    item takes a palette, screen content without intra block copy) and intra
    block copy (lines of repeated letters at qualities 75 and 100 in 4:2:0,
    whose chroma copies from half-sample positions, and 4:4:4, with 128 x
    128 superblocks and with two tile columns; speeds 0 to 2 and 10); the
    chair's flat and decal textures and the 2048 x 1536 atlas of flat
    shapes and text. A frame that holds intra block copy is at least 129
    samples on a side (INTRABC_DELAY_SB64); the rest are at most 128. Each
    file's purpose is asserted from the decoder's counters in the AVIF
    tests."""
    out = {}
    flat = seeded_flat((96, 128), 11)
    out["avif_screen_flat_420.avif"] = ("AVIF screen content, a flat 4-colour texture at "
                                        "Pillow's defaults, palette", avif_file(flat))
    for sub in ("4:4:4", "4:2:2"):
        out[f"avif_screen_posterised_{sub.replace(':', '')}.avif"] = (
            f"AVIF screen content {sub}, a posterised gradient at quality 90, palette",
            avif_file(seeded_posterised((72, 96), 12), quality=90, subsampling=sub))
    out["avif_screen_flat_lossless.avif"] = (
        "AVIF screen content, the flat texture coded-lossless (quality 100), palette",
        avif_file(flat, quality=100))
    for sub, seed in (("4:2:0", 13), ("4:4:4", 25), ("4:2:2", 18)):
        tag = sub.replace(":", "")
        out[f"avif_screen_palette_sizes_{tag}.avif"] = (
            f"AVIF screen content {sub}, squares of 2 to 8 colours, every palette size",
            avif_file(seeded_patchwork_palette((128, 128), seed), quality=90, subsampling=sub))
    alpha = np.where(seeded_glyphs((96, 128), 14)[..., :1] < 128, 255, 96).astype(np.uint8)
    rgba = np.concatenate([flat, alpha], -1)
    out["avif_screen_flat_rgba.avif"] = ("AVIF screen content RGBA, a flat texture, a palette "
                                         "in the alpha item", avif_file(rgba))
    out["avif_screen_no_intrabc.avif"] = (
        "AVIF screen content, aom tune-content=screen with enable-intrabc=0",
        avif_file(seeded_glyphs((96, 192), 15), advanced={"tune-content": "screen",
                                                           "enable-intrabc": "0"}))
    text = seeded_glyphs((96, 192), 16)
    for q in (75, 100):
        for sub in ("4:2:0", "4:4:4"):
            tag = sub.replace(":", "")
            out[f"avif_screen_glyphs_q{q}_{tag}.avif"] = (
                f"AVIF screen content {sub}, lines of letters at quality {q}, intra block copy",
                avif_file(text, quality=q, subsampling=sub))
    out["avif_screen_glyphs_sb128.avif"] = (
        "AVIF screen content, lines of letters, intra block copy with 128 x 128 superblocks",
        avif_file(seeded_glyphs((200, 320), 17), advanced={"sb-size": "128"}))
    out["avif_screen_glyphs_residual.avif"] = (
        "AVIF screen content, letters in three inks, some altered, at quality 50, aom speed 1: "
        "residuals over intra block copy in var-tx blocks, a flipped ADST",
        avif_file(seeded_glyphs((128, 256), 1, altered=0.3), quality=50, speed=1))
    out["avif_screen_glyphs_tiles.avif"] = (
        "AVIF screen content, lines of letters, intra block copy over two tile columns",
        avif_file(seeded_glyphs((128, 512), 18), tile_cols=1))
    for speed in (0, 1, 2, 10):
        out[f"avif_screen_speed{speed}.avif"] = (
            f"AVIF screen content, lines of letters, aom speed {speed}",
            avif_file(seeded_glyphs((96, 192), 20 + speed), speed=speed))
    out["chair_flat.avif"] = ("chair texture, AVIF screen content, flat colours, palette",
                              avif_file(seeded_flat((48, 48), 453)))
    out["chair_decal.avif"] = ("chair texture, AVIF screen content, a decal of letters, intra "
                               "block copy", avif_file(seeded_glyphs((96, 256), 454)))
    atlas = texture_atlas(10)
    atlas[:768] = seeded_glyphs((768, 2048), 455, glyphs=26, ink=(20, 40, 90))
    out["atlas_screen_2048x1536.avif"] = (
        "2048 x 1536 atlas, AVIF screen content at Pillow's defaults, flat shapes and text",
        avif_file(atlas))
    return out


class _Bits:
    """The bits of an OBU payload, read and rewritten MSB first."""

    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def f(self, n: int) -> int:
        value = int(self.bits[self.pos:self.pos + n] or "0", 2)
        self.pos += n
        return value

    def delta_q(self) -> str:
        """read_delta_q: its bits (delta_coded, and delta_q where coded)."""
        start = self.pos
        if self.f(1):
            self.f(7)
        return self.bits[start:self.pos]


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def avif_separate_uv_q(data: bytes, qm_v: int) -> bytes:
    """``data`` (a one-item AVIF of a colour frame of at most 64 x 64 that
    Pillow wrote with a reduced sequence header and quantizer matrices,
    without CDEF, loop restoration, segmentation, delta q or film grain)
    with the AV1 sequence header's separate_uv_delta_q set and the frame
    header's quantization_params rewritten to match: diff_uv_delta 1 with
    the V deltas equal to the U ones, and qm_v ``qm_v`` (aom 3.12.1 writes
    separate_uv_delta_q 0 whatever Pillow's options). The frame OBU grows
    by the bits inserted, realigned; the OBU size, the iloc extent and the
    mdat box grow with it."""
    at = data.index(b"mdat") + 4
    # temporal delimiter, sequence header, frame (each with its size)
    assert data[at:at + 2] == b"\x12\x00" and data[at + 2] == 0x0A, data[at:at + 3]
    seq_size, seq_at = data[at + 3], at + 4
    assert seq_size < 0x80
    seq = _Bits(data[seq_at:seq_at + seq_size])
    profile, _, reduced = seq.f(3), seq.f(1), seq.f(1)
    assert reduced and profile in (0, 1), (reduced, profile)
    seq.f(5)
    wbits, hbits = seq.f(4) + 1, seq.f(4) + 1
    width, height = seq.f(wbits) + 1, seq.f(hbits) + 1
    assert width <= 64 and height <= 64, (width, height)
    sb128, _, _, superres, cdef, restoration = (seq.f(1) for _ in range(6))
    assert not (superres or cdef) and not seq.f(1)              # 8 bits
    assert not (profile == 0 and seq.f(1))                        # mono_chrome
    if seq.f(1):                                                  # color_description_present
        seq.f(24)
    seq.f(1)                                                      # color_range
    if profile == 0:
        seq.f(2)                                                  # chroma_sample_position
    assert seq.bits[seq.pos] == "0"                               # separate_uv_delta_q
    seq.bits = seq.bits[:seq.pos] + "1" + seq.bits[seq.pos + 1:]
    seq.f(1)
    assert not seq.f(1)                                           # film_grain_params_present
    frame_at = seq_at + seq_size
    assert data[frame_at] == 0x32                                 # OBU_FRAME with a size
    size, n = 0, 0
    while True:
        byte = data[frame_at + 1 + n]
        size |= (byte & 0x7F) << (7 * n)
        n += 1
        if byte < 0x80:
            break
    payload_at = frame_at + 1 + n
    frame = _Bits(data[payload_at:payload_at + size])
    frame.f(1)                                                    # disable_cdf_update
    screen = frame.f(1)
    if screen:
        frame.f(1)                                                # force_integer_mv
    if frame.f(1):                                                # render_and_frame_size_different
        frame.f(32)
    if screen:
        assert not frame.f(1)                                     # allow_intrabc
    assert frame.f(1)                                             # uniform_tile_spacing_flag
    base_q_idx = frame.f(8)
    assert base_q_idx
    frame.delta_q()                                               # DeltaQYDc
    u_at = frame.pos
    frame.delta_q()
    frame.delta_q()
    u_bits = frame.bits[u_at:frame.pos]
    assert frame.f(1)                                             # using_qmatrix
    frame.f(8)                                                    # qm_y, qm_u
    qm_at = frame.pos
    assert not frame.f(1)                                         # segmentation_enabled
    assert not frame.f(1)                                         # delta_q_present
    levels = frame.f(12)
    if levels:
        frame.f(12)
    frame.f(3)                                                    # loop_filter_sharpness
    if frame.f(1) and frame.f(1):                                 # loop_filter_delta_update
        for _ in range(10):
            if frame.f(1):
                frame.f(7)
    if restoration:
        assert not frame.f(6)                                     # lr_type of each plane
    frame.f(2)                                                    # tx_mode_select, reduced_tx_set
    header_end = frame.pos
    tiles = frame.bits[(header_end + 7) // 8 * 8:]
    header = (frame.bits[:u_at] + "1" + u_bits + u_bits + frame.bits[u_at + len(u_bits):qm_at]
              + f"{qm_v:04b}" + frame.bits[qm_at:header_end])
    header += "0" * (-len(header) % 8)
    bits = header + tiles
    new = bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))
    new_seq = bytes(int(seq.bits[k:k + 8], 2) for k in range(0, len(seq.bits), 8))
    obus = data[at:seq_at] + new_seq + b"\x32" + _leb128(len(new)) + new
    grow = len(obus) - (payload_at + size - at)
    assert payload_at + size == len(data), "the colour item is the file's last bytes"
    out = bytearray(data[:at] + obus)
    mdat = out.index(b"mdat") - 4
    out[mdat:mdat + 4] = struct.pack(">I", struct.unpack(">I", out[mdat:mdat + 4])[0] + grow)
    # iloc version 0, offset_size 4, length_size 4, one item of one extent
    iloc = out.index(b"iloc") + 4
    assert out[iloc] == 0 and out[iloc + 4] == 0x44
    assert struct.unpack(">H", out[iloc + 6:iloc + 8])[0] == 1
    length_at = iloc + 8 + 2 + 2 + 2 + 4        # item_ID, data_reference_index, extent_count, offset
    (length,) = struct.unpack(">I", out[length_at:length_at + 4])
    assert length == len(data) - at
    out[length_at:length_at + 4] = struct.pack(">I", length + grow)
    return bytes(out)


# film-grain-table files (aom's grain_table.c format) of AR lags 0 and 1,
# which no film-grain-test vector has
def avif_grain_table(lag: int, seed: int) -> str:
    """A film grain table of one entry over all time: seed ``seed``, AR lag
    ``lag``, three Y scaling points and two per chroma plane, seeded AR
    coefficients."""
    rng = np.random.default_rng(seed)
    n = 2 * lag * (lag + 1)
    coeffs = lambda k: " ".join(str(int(v)) for v in rng.integers(-24, 25, k))
    return (f"filmgrn1\nE 0 9223372036854775807 1 {seed} 1\n"
            f"\tp {lag} 7 {lag} 10 0 1 150 90 280 120 100 240\n"
            "\tsY 3  0 20 128 60 255 40\n\tsCb 2 0 30 255 50\n\tsCr 2 0 25 255 45\n"
            f"\tcY {coeffs(n)}\n\tcCb {coeffs(n + 1)}\n\tcCr {coeffs(n + 1)}\n")


def avif_qm_grain_formats() -> dict:
    """Lossy AVIFs whose AV1 frames Pillow's writer (aom 3.12.1) codes with
    quantizer matrices (aom's tune=iq, its still-image tune, or
    enable-qm=1) or film grain (aom's film-grain-test vectors, a
    film-grain-table, or its denoiser's denoise-noise-level, which replaces
    the noise it removes with grain parameters), or both: tune=iq at
    Pillow's defaults in 4:2:0, 4:4:4 and RGBA; enable-qm=1 at speed 4 with
    CDEF and restoration and at speed 5 (64-point transforms); qm-min =
    qm-max pinned to each level 0 to 14; a colour item rewritten to
    separate_uv_delta_q with a qm_v of its own; screen content under a
    matrix (palette and intra block copy); a coded-lossless frame with
    enable-qm=1 (level 15); film-grain-test 1 to 16 at 4:2:0 (odd sizes
    among them), vectors at 4:4:4, 4:2:2 and 4:0:0, at limited range
    (clip_to_restricted_range), in an alpha item; tables of AR lags 0 and
    1; the denoiser on a seeded noisy patchwork; both tools in one file;
    the chair's two textures and the 2048 x 1536 atlas with both. Every
    file but the screen content one (intra block copy needs a frame over
    128 samples on a side) and the atlas is at most 128 on a side. Each
    file's purpose is asserted from the decoder's counters in the AVIF
    tests."""
    out = {}
    rgb = seeded_rgb((96, 128), 520, noise=8)
    out["avif_qm_iq_420.avif"] = ("AVIF quantizer matrices, aom tune=iq at Pillow's defaults "
                                  "4:2:0", avif_file(rgb, advanced={"tune": "iq"}))
    out["avif_qm_iq_444.avif"] = ("AVIF quantizer matrices 4:4:4, aom tune=iq",
                                  avif_file(rgb, subsampling="4:4:4", advanced={"tune": "iq"}))
    yy, xx = np.mgrid[:96, :128]
    alpha = np.clip(128 + 110 * np.sin(xx / 11.0) * np.cos(yy / 9.0), 0, 255).astype(np.uint8)
    out["avif_qm_iq_rgba.avif"] = ("AVIF quantizer matrices RGBA, aom tune=iq, a weighted alpha "
                                   "item", avif_file(np.concatenate([rgb, alpha[..., None]], -1),
                                                     advanced={"tune": "iq"}))
    out["avif_qm_speed4_cdef_lr.avif"] = (
        "AVIF quantizer matrices, enable-qm=1 at aom speed 4, CDEF and loop restoration, 4:1 "
        "transforms", avif_file(seeded_patchwork(128, 523, 20), speed=4,
                                advanced={"enable-qm": "1", "enable-cdef": "1"}))
    out["avif_qm_speed5_tx64.avif"] = (
        "AVIF quantizer matrices, enable-qm=1 at quality 30, aom speed 5, 64-point transforms",
        avif_file(seeded_rgb((128, 128), 522, noise=0.5), quality=30, speed=5,
                  advanced={"enable-qm": "1"}))
    for level in range(15):
        out[f"avif_qm_level{level}.avif"] = (
            f"AVIF quantizer matrices, qm-min = qm-max = {level}", avif_file(
                seeded_rgb((40, 56), 530 + level, noise=8), quality=60,
                advanced={"enable-qm": "1", "qm-min": str(level), "qm-max": str(level)}))
    out["avif_qm_separate_uv.avif"] = (
        "AVIF quantizer matrices, a colour item rewritten to separate_uv_delta_q with qm_v 3",
        avif_separate_uv_q(avif_file(seeded_rgb((48, 64), 545, noise=8), quality=60,
                                     advanced={"enable-qm": "1", "qm-min": "11",
                                               "qm-max": "11"}), 3))
    out["avif_qm_screen.avif"] = (
        "AVIF quantizer matrices over lines of letters, palette and intra block copy",
        avif_file(seeded_glyphs((96, 192), 546, altered=0.3), quality=60,
                  advanced={"enable-qm": "1"}))
    out["avif_qm_lossless.avif"] = ("AVIF quantizer matrices, coded-lossless with enable-qm=1 "
                                    "(level 15)", avif_file(seeded_rgb((40, 56), 547, noise=8),
                                                            quality=100,
                                                            advanced={"enable-qm": "1"}))
    sizes = ((40, 56), (33, 47), (48, 64), (37, 29))
    for vector in range(1, 17):
        shape = sizes[vector % 4]
        out[f"avif_grain_test{vector}_{shape[1]}x{shape[0]}.avif"] = (
            f"AVIF film grain 4:2:0, aom film-grain-test {vector}", avif_file(
                seeded_rgb(shape, 550 + vector, noise=8),
                advanced={"film-grain-test": str(vector)}))
    for sub, vectors in (("4:4:4", (1, 15)), ("4:2:2", (4, 10)), ("4:0:0", (2, 13))):
        for vector in vectors:
            tag = sub.replace(":", "")
            out[f"avif_grain_{tag}_test{vector}.avif"] = (
                f"AVIF film grain {sub}, aom film-grain-test {vector}", avif_file(
                    seeded_rgb((35, 45), 570 + vector, noise=8), subsampling=sub,
                    advanced={"film-grain-test": str(vector)}))
    out["avif_grain_limited_test3.avif"] = (
        "AVIF film grain at limited range, aom film-grain-test 3: clip_to_restricted_range",
        avif_file(seeded_rgb((40, 56), 590, noise=8), range="limited",
                  advanced={"film-grain-test": "3"}))
    rgba = np.concatenate([seeded_rgb((48, 64), 591, noise=8), alpha[:48, :64, None]], -1)
    out["avif_grain_rgba.avif"] = ("AVIF film grain RGBA, aom film-grain-test 7, grain in the "
                                   "alpha item", avif_file(rgba,
                                                           advanced={"film-grain-test": "7"}))
    with tempfile.TemporaryDirectory() as tmp:
        for lag in (0, 1):
            table = os.path.join(tmp, f"lag{lag}.tbl")
            with open(table, "w") as fh:
                fh.write(avif_grain_table(lag, 600 + lag))
            out[f"avif_grain_table_lag{lag}.avif"] = (
                f"AVIF film grain from an aom film-grain-table, ar_coeff_lag {lag}", avif_file(
                    seeded_rgb((40, 56), 600 + lag, noise=8),
                    advanced={"film-grain-table": table}))
    out["avif_grain_denoised.avif"] = (
        "AVIF film grain, aom denoise-noise-level=25 at Pillow's default quality on a noisy "
        "patchwork, a denoised photograph", avif_file(
            seeded_patchwork(128, 7, 20), advanced={"denoise-noise-level": "25"}))
    out["avif_qm_grain_both.avif"] = (
        "AVIF quantizer matrices and film grain, aom tune=iq with denoise-noise-level=25",
        avif_file(seeded_patchwork(128, 8, 20), advanced={"tune": "iq",
                                                          "denoise-noise-level": "25"}))
    tex = seeded_rgb((48, 48), 452, noise=8)
    out["chair_iq.avif"] = ("chair texture, AVIF quantizer matrices, aom tune=iq",
                            avif_file(tex, advanced={"tune": "iq"}))
    out["chair_grain.avif"] = ("chair texture, AVIF film grain, denoise-noise-level=25",
                               avif_file(seeded_rgb((64, 64), 452, noise=8),
                                         advanced={"denoise-noise-level": "25"}))
    noisy = texture_atlas(11) + np.random.default_rng(612).normal(0, 4, (1536, 2048, 3))
    out["atlas_iq_grain_2048x1536.avif"] = (
        "2048 x 1536 atlas, AVIF quantizer matrices and film grain, aom tune=iq with "
        "denoise-noise-level=25", avif_file(np.clip(noisy, 0, 255).astype(np.uint8),
                                            advanced={"tune": "iq", "denoise-noise-level": "25"}))
    return out


def avif_refused_files() -> dict:
    """{refusal word: AVIF bytes} of the files Pillow reads and the port
    refuses by name, one per word Pillow's writer (aom 3.12.1) can make: an
    avis sequence. Superres (aom takes no option of Pillow's for it),
    delta lf (aom's deltalf-mode is not an option of Pillow's), segment loop
    filter levels (aom writes no segmentation here), high bit depth (Pillow
    writes 8 bits), an inter first frame and a grid (libavif's writer makes
    one only through its own API) are not written."""
    from PIL import Image

    rgb = seeded_rgb((30, 44), 460, noise=8)
    seq = io.BytesIO()
    Image.fromarray(rgb).save(seq, "AVIF", quality=100, save_all=True,
                              append_images=[Image.fromarray(rgb[::-1])])
    return {"avis image sequence": seq.getvalue()}


def _dxt1(rgb: np.ndarray) -> bytes:
    """Each 4 x 4 block as DXT1 between its darkest and brightest pixel
    (four-colour mode), every pixel the nearest of the four."""
    h, w, _ = rgb.shape
    out = bytearray()
    for by in range(0, h, 4):
        for bx in range(0, w, 4):
            block = rgb[by:by + 4, bx:bx + 4].reshape(-1, 3).astype(np.int32)
            luma = block.sum(1)
            hi, lo = block[luma.argmax()], block[luma.argmin()]
            c0 = (hi[0] >> 3) << 11 | (hi[1] >> 2) << 5 | hi[2] >> 3
            c1 = (lo[0] >> 3) << 11 | (lo[1] >> 2) << 5 | lo[2] >> 3
            if c0 <= c1:
                c0, c1 = max(c0, c1 + 1) if c1 < 0xFFFF else c0, min(c1, c0 - 1) if c0 else c1
            points = np.array([hi, lo, (2 * hi + lo) // 3, (hi + 2 * lo) // 3])
            nearest = ((block[:, None] - points[None]) ** 2).sum(-1).argmin(1)
            bits = sum(int(v) << (2 * k) for k, v in enumerate(nearest))
            out += struct.pack("<HHI", c0, c1, bits)
    return bytes(out)


def _sgi_overrun(rgb: np.ndarray) -> bytes:
    """An SGI RLE file whose first row's first packet runs past the row."""
    data = bytearray(sgi_file(rgb[None, ..., 0], rle=True))
    data[512 + 8 * rgb.shape[0]] = 0x7F
    return bytes(data)


def _dxt5(rgba: np.ndarray) -> bytes:
    """DXT5 blocks of (H, W, 4), H and W multiples of 4: each block's
    colours the endpoints of its darkest and lightest pixel, alpha its min
    and max, indices to the nearest."""
    h, w = rgba.shape[:2]
    out = bytearray()
    for by in range(0, h, 4):
        for bx in range(0, w, 4):
            blk = rgba[by:by + 4, bx:bx + 4].reshape(16, 4).astype(np.int32)
            luma = blk[:, :3].sum(1)
            hi, lo = blk[luma.argmax(), :3], blk[luma.argmin(), :3]
            c = [int(v[0]) >> 3 << 11 | int(v[1]) >> 2 << 5 | int(v[2]) >> 3 for v in (hi, lo)]
            ends = np.array([[(x >> 11) << 3, (x >> 5 & 63) << 2, (x & 31) << 3] for x in c])
            if c[0] <= c[1]:
                c, ends = [c[0], c[0]], ends[[0, 0]]
            pal = np.stack([ends[0], ends[1], (2 * ends[0] + ends[1]) // 3,
                            (2 * ends[1] + ends[0]) // 3])
            colour = np.abs(blk[:, None, :3] - pal[None]).sum(-1).argmin(1)
            a0, a1 = int(blk[:, 3].max()), int(blk[:, 3].min())
            alpha = np.zeros(16, np.int64) if a0 == a1 else np.where(blk[:, 3] >= (a0 + a1) / 2,
                                                                     0, 1)
            abits = sum(int(v) << (3 * k) for k, v in enumerate(alpha))
            cbits = sum(int(v) << (2 * k) for k, v in enumerate(colour))
            out += bytes([a0, a1]) + abits.to_bytes(6, "little") + struct.pack("<HHI", c[0],
                                                                                 c[1], cbits)
    return bytes(out)


GZIPPED = ("pcd_base.pcd", "atlas_2048x1536.flc", "atlas_gzip_2048x1536.fits",
           "atlas_bc7_2048x1536.dds", "atlas_dxt1_2048x1536.dds", "atlas_2048x1536.qoi",
           "atlas_rle_2048x1536.sgi")


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

# ---------------------------------------------------------------------------
# Damaged files: what Pillow recovers from or refuses (tests/data/images/damaged)
# ---------------------------------------------------------------------------

DAMAGED = os.path.join(OUT, "damaged")
DAMAGED_GZIPPED = ("atlas_damaged_restart_2048x1536.jpg",)


def jpeg_segments(data: bytes) -> list:
    """(marker, start, end) of each segment of a JPEG file; a scan runs to
    the next marker other than RSTn."""
    out, pos = [], 2
    while pos < len(data) - 1:
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append((marker, pos, pos + 2))
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


def scan_span(data: bytes, k: int = 0) -> tuple:
    """(start, end) of the entropy-coded data of scan ``k``."""
    _, at, end = [s for s in jpeg_segments(data) if s[0] == 0xDA][k]
    return at + 2 + int.from_bytes(data[at + 2:at + 4], "big"), end


def restart_markers(data: bytes) -> list:
    """Offsets of the RSTn markers in the first scan."""
    start, end = scan_span(data)
    return [i for i in range(start, end - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def spliced(data: bytes, at: int, remove: int = 0, insert: bytes = b"") -> bytes:
    return data[:at] + insert + data[at + remove:]


def patched_byte(data: bytes, at: int, value: int) -> bytes:
    return spliced(data, at, 1, bytes([value]))


def without_segments(data: bytes, marker: int) -> bytes:
    out = bytearray(data[:2])
    for m, a, b in jpeg_segments(data):
        if m != marker:
            out += data[a:b]
    return bytes(out)


def segment_start(data: bytes, marker: int, k: int = 0) -> int:
    return [a for m, a, _ in jpeg_segments(data) if m == marker][k]


def riff_resized(data: bytes) -> bytes:
    """A simple WebP with its RIFF and first chunk sizes set to what is left."""
    out = bytearray(data)
    out[4:8] = (len(out) - 8).to_bytes(4, "little")
    out[16:20] = (len(out) - 20).to_bytes(4, "little")
    return bytes(out)


def damaged_fixtures() -> dict:
    """{file name: (kind, bytes)}: small files damaged on purpose, one or
    more for each rule of libjpeg-turbo's recovery from corrupt data,
    Pillow's refusals of damaged and truncated files, libtiff's and
    libwebp's, each made from a committed fixture or a seeded image; then
    seeded single-byte changes of scans; and a 2048 x 1536 atlas JPEG with
    restart markers and three damaged intervals."""
    from PIL import Image

    def fixture(name: str) -> bytes:
        with open(os.path.join(OUT, name), "rb") as fh:
            return fh.read()

    def jpeg(image, **kw):
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, "JPEG", **kw)
        return buf.getvalue()

    base = fixture("baseline_420_q75.jpg")          # Pillow's standard tables
    s0, s1 = scan_span(base)
    mid = (s0 + s1) // 2
    restart = jpeg(seeded_rgb((64, 96), 31), quality=80, restart_marker_blocks=2)
    rst = restart_markers(restart)
    prog = fixture("progressive_420.jpg")
    p0, p1 = scan_span(prog, -1)
    out = {
        "jpeg_bad_huffman_code.jpg": ("a run of 1 bits no code starts (symbol 0 after 17 bits)",
                                      spliced(base, mid, 0, b"\xff\x00" * 4)),
        "jpeg_marker_mid_scan.jpg": ("an RST3 inside a scan without restarts: zeros, the rest "
                                     "of the scan not decoded", spliced(base, mid, 0, b"\xff\xd3")),
        "jpeg_eoi_mid_scan.jpg": ("an EOI over two bytes of the scan", spliced(base, mid, 2,
                                                                               b"\xff\xd9")),
        "jpeg_ff_ff_00.jpg": ("FF FF 00 in a scan: one FF data byte to libjpeg, a marker to its "
                              "fast path", spliced(base, mid, 0, b"\xff\xff\x00")),
        "jpeg_resync_far.jpg": ("an RSTn four ahead of the expected one (resync action 1)",
                                patched_byte(restart, rst[3] + 1, 0xD0 + (3 + 4) % 8)),
        "jpeg_resync_earlier.jpg": ("the previous RSTn again (resync action 2: scan ahead)",
                                    patched_byte(restart, rst[3] + 1, 0xD0 + (3 - 1) % 8)),
        "jpeg_resync_next.jpg": ("the RSTn after the expected one (resync action 3: an empty "
                                 "interval)", patched_byte(restart, rst[3] + 1, 0xD0 + 4 % 8)),
        "jpeg_restart_missing.jpg": ("an RSTn left out", spliced(restart, rst[4], 2)),
        "jpeg_restart_duplicated.jpg": ("an RSTn written twice", spliced(
            restart, rst[4], 0, restart[rst[4]:rst[4] + 2])),
        "jpeg_restart_garbage.jpg": ("stray bytes before an RSTn (discarded by next_marker)",
                                     spliced(restart, rst[5], 0, b"\x12\x34\xff\x00\x56")),
        "jpeg_restart_bad_code.jpg": ("a bad code in one restart interval", spliced(
            restart, (rst[1] + rst[2]) // 2, 0, b"\xff\x00" * 3)),
        "jpeg_no_dht.jpg": ("a baseline file without DHT: libjpeg's standard tables",
                            without_segments(base, 0xC4)),
        "jpeg_not_sequential.jpg": ("a sequential scan with Se 20 (only a warning)",
                                    patched_byte(base, s0 - 2, 20)),
        "jpeg_bogus_progression.jpg": ("a progressive file without its first DC scan (an "
                                       "inconsistent progression, only a warning)",
                                       drop_scans(prog, lambda h: not (h[0] == 3 and
                                                                       h[1 + 2 * h[0]] == 0
                                                                       and h[3 + 2 * h[0]] >> 4
                                                                       == 0))),
        "jpeg_progressive_marker.jpg": ("an RST inside the last scan of a progressive file "
                                        "(smoothing below it with the earlier bits)",
                                        spliced(prog, (p0 + p1) // 2, 0, b"\xff\xd5")),
        "jpeg_arith_bad_code.jpg": ("arithmetic-coded data that overflows (ct = -1)",
                                    patched_byte(fixture("arith_420.jpg"), 712, 169)),
        "jpeg_arith_restart_damaged.jpg": ("a damaged interval of an arithmetic file with "
                                           "restarts", patched_byte(fixture(
                                               "arith_dac_restart.jpg"), 700, 0x5A)),
        "jpeg_lossless_damaged.jpg": ("a marker inside a lossless scan with restarts: rows "
                                      "predicted afresh as zeros", spliced(
                                          fixture("lossless_rgb_p7_restart.jpg"), 700, 0,
                                          b"\xff\xd9")),
        "jpeg_extraneous_bytes.jpg": ("bytes before a marker (skipped with a warning)",
                                      spliced(base, segment_start(base, 0xC0), 0,
                                              b"\x00\x11\x22")),
        "jpeg_dnl_after_scan.jpg": ("a DNL segment after the scan (skipped)", spliced(
            base, len(base) - 2, 0, b"\xff\xdc\x00\x04\x00\x30")),
        "jpeg_no_eoi_trailing_bytes.jpg": ("a single-scan file without its EOI, 24 bytes after "
                                           "its data (Pillow stops at the last line)",
                                           base[:-2] + bytes(range(1, 25))),
        "jpeg_tables_first.jpg": ("an abbreviated stream of tables before the image",
                                  base[:segment_start(base, 0xC0)] + b"\xff\xd9" + base),
        "jpeg_idct_overflow.jpg": ("quantisation values of 255 (the SIMD IDCT's 16-bit "
                                   "products)", spliced(base, segment_start(base, 0xDB) + 5, 64,
                                                        b"\xff" * 64)),
        "jpeg_16bit_dqt.jpg": ("a DQT with precision nibble 2 (16-bit values)", spliced(
            base, segment_start(base, 0xDB), 69,
            b"\xff\xdb\x00\x83\x20" + b"\x00\x10" * 64)),
        "refused_jpeg_unknown_marker.jpg": ("a JPG7 marker before the scan (libjpeg refuses "
                                            "it)", spliced(base, segment_start(base, 0xDA), 0,
                                                           b"\xff\xf7\x00\x04\x00\x00")),
        "refused_jpeg_undefined_dqt.jpg": ("a component whose quantisation table is never "
                                           "defined", patched_byte(
                                               base, segment_start(base, 0xC0) + 12, 3)),
        "refused_jpeg_unknown_after_scan.jpg": ("an unknown marker after the scan", spliced(
            base, len(base) - 2, 0, b"\xff\x05")),
        "refused_jpeg_pillow_tem.jpg": ("a TEM marker (Pillow's parse: no marker found)",
                                        spliced(base, segment_start(base, 0xC0), 0, b"\xff\x01")),
        "refused_jpeg_short_jfif.jpg": ("a JFIF segment of 5 bytes (Pillow's parse fails)",
                                        spliced(base, 2, segment_start(base, 0xDB) - 2,
                                                b"\xff\xe0\x00\x07JFIF\x00")),
        "refused_jpeg_dht_length.jpg": ("a DHT segment of length 1", spliced(
            base, segment_start(base, 0xC4), 0, b"\xff\xc4\x00\x01")),
        "refused_jpeg_truncated.jpg": ("a baseline file cut inside its scan", base[:mid]),
        "refused_jpeg_sof_in_scan.jpg": ("an SOF marker inside the scan (a second frame "
                                         "header)", spliced(base, mid, 2, b"\xff\xc0")),
    }
    # GIF: Pillow refuses a frame whose LZW data ends before its pixels
    gif = fixture("gif_p.gif")
    out["refused_gif_truncated.gif"] = ("a GIF cut inside its LZW data", gif[:len(gif) * 2 // 3])
    out["gif_lzw_byte_changed.gif"] = ("one LZW byte changed", patched_byte(gif, len(gif) // 2,
                                                                             0x5C))
    # TIFF: Pillow's raw strips, libtiff's codecs
    raw = fixture("tiff_rgb_none.tif")
    out["refused_tiff_raw_truncated.tif"] = ("an uncompressed TIFF cut inside its strips",
                                             raw[:len(raw) // 2])
    lzw = fixture("tiff_rgb_lzw.tif")
    out["refused_tiff_lzw_truncated.tif"] = ("an LZW TIFF cut inside a strip (libtiff refuses "
                                             "it)", lzw[:len(lzw) // 2])
    deflate = bytearray(fixture("tiff_rgb_deflate.tif"))
    with Image.open(io.BytesIO(bytes(deflate))) as im:
        offsets, counts = im.tag_v2[273], im.tag_v2[279]
    check = offsets[0] + counts[0] - 4                  # the first strip's Adler-32
    deflate[check:check + 4] = bytes(b ^ 0x5A for b in deflate[check:check + 4])
    out["tiff_deflate_bad_check.tif"] = ("a Deflate strip whose Adler-32 is wrong (libtiff "
                                         "never reads it)", bytes(deflate))
    tj = fixture("tiff_jpeg_ycbcr_strips.tif")
    with Image.open(io.BytesIO(tj)) as im:
        offsets, counts = im.tag_v2[273], im.tag_v2[279]
    strip = offsets[1] + counts[1] // 2
    out["tiff_jpeg_strip_marker.tif"] = ("an unknown marker inside a JPEG strip (libtiff "
                                         "ignores what jpeg_finish_decompress raises)",
                                         spliced(tj, strip, 2, b"\xff\x51"))
    out["tiff_jpeg_strip_bad_code.tif"] = ("a bad code in a JPEG strip", spliced(
        tj, strip, 4, b"\xff\x00\xff\x00"))
    # WebP: libwebp's end of data, with the chunk's padding byte
    lossy = fixture("webp_lossy_q75.webp")
    out["refused_webp_lossy_short.webp"] = ("a lossy WebP short of its last partition's data "
                                            "(libwebp: premature end)", riff_resized(lossy[:-40]))
    lossless = fixture("webp_lossless.webp")
    out["webp_lossless_into_padding.webp"] = ("a lossless WebP with a byte inserted: its last "
                                              "bits in the chunk's padding byte",
                                              spliced(lossless, 1033, 0, b"\x57"))
    out["webp_lossy_token_changed.webp"] = ("a changed byte in a lossy WebP's tokens (16-bit "
                                            "coefficients, libwebp's SSE2 transform)",
                                            patched_byte(lossy, len(lossy) * 3 // 4, 0xC5))
    # BLP1: its mips are JPEG data decoded by libjpeg
    blp = bytearray(fixture("blp1_jpeg.blp"))
    blp[-30] ^= 0x5A
    out["blp1_jpeg_damaged.blp"] = ("a changed byte in a BLP1 mip's JPEG data", bytes(blp))
    # seeded single-byte changes of scans, kept whatever Pillow makes of them
    rng = np.random.default_rng(17)
    for name in ("baseline_444_q95.jpg", "progressive_gray.jpg", "arith_progressive.jpg",
                 "lossless_gray_p4_pt2.jpg", "optimized.jpg", "sampling_mixed.jpg", "cmyk.jpg",
                 "smoothed_420.jpg"):
        data = fixture(name)
        a, b = scan_span(data)
        for k in range(3):
            at = int(rng.integers(a, b))
            stem = name.rsplit(".", 1)[0]
            out[f"seeded_{stem}_{k}.jpg"] = (f"{name} with byte {at} changed (seed 17)",
                                            patched_byte(data, at, int(rng.integers(0, 256))))
    # a 2048 x 1536 atlas with restart markers and three damaged intervals
    atlas = jpeg(texture_atlas(9), quality=90, restart_marker_rows=4)
    marks = restart_markers(atlas)
    atlas = spliced(atlas, marks[17], 2)                                    # a missing RSTn
    atlas = spliced(atlas, marks[11] + 1, 1, bytes([0xD0 + (11 + 1) % 8]))  # resync: the next
    atlas = spliced(atlas, (marks[5] + marks[6]) // 2, 0, b"\xff\x00" * 4)  # a bad code
    out["atlas_damaged_restart_2048x1536.jpg"] = (
        "2048 x 1536 atlas, q90, restarts every 4 MCU rows, a bad code, a wrong RSTn and a "
        "missing RSTn", atlas)
    return out


def write_damaged() -> int:
    """Write ``damaged_fixtures()`` and their Pillow hashes under ``DAMAGED``."""
    import PIL
    from PIL import Image, features

    os.makedirs(DAMAGED, exist_ok=True)
    entries = []
    for name, (kind, data) in damaged_fixtures().items():
        stored = name + ".gz" if name in DAMAGED_GZIPPED else name
        blob = gzip.compress(data, 9, mtime=0) if name in DAMAGED_GZIPPED else data
        with open(os.path.join(DAMAGED, stored), "wb") as fh:
            fh.write(blob)
        entry = dict(file=name, kind=kind, bytes=len(blob))
        if name in DAMAGED_GZIPPED:
            entry.update(stored=stored, raw_bytes=len(data))
        try:
            with Image.open(io.BytesIO(data)) as im:
                im.load()
                own = np.asarray(im)
                arrays = {"None": own, "RGB": np.asarray(im.convert("RGB")),
                          "L": np.asarray(im.convert("L"))}
                entry.update(mode=im.mode, shape=list(own.shape), dtype=str(own.dtype),
                             sha256={m: array_sha(a) for m, a in arrays.items()})
        except Exception as err:                  # every refusal of Pillow's
            entry.update(raises=True, pillow_error=f"{type(err).__name__}: {err}")
        entries.append(entry)
    manifest = dict(pillow=PIL.__version__, libjpeg_turbo=features.version("libjpeg_turbo"),
                    libwebp=features.version("webp"), libtiff=features.version("libtiff"),
                    files=entries)
    with open(os.path.join(DAMAGED, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    print(f"wrote {len(entries)} damaged fixtures, {sum(e['bytes'] for e in entries)} bytes, "
          f"under {DAMAGED}")
    return 0


def write_fixture(name: str, kind: str, data: bytes) -> dict:
    """Write one fixture under ``OUT`` (gzipped where ``GZIPPED`` says) and
    return its manifest entry: Pillow's mode, shape, dtype and hashes, or
    its refusal."""
    from PIL import Image

    stored = name + ".gz" if name in GZIPPED else name
    blob = gzip.compress(data, 9, mtime=0) if name in GZIPPED else data
    with open(os.path.join(OUT, stored), "wb") as fh:
        fh.write(blob)
    entry = dict(file=name, kind=kind, bytes=len(blob))
    if name in GZIPPED:
        entry.update(stored=stored, raw_bytes=len(data))
    try:
        with Image.open(io.BytesIO(data) if name in GZIPPED else os.path.join(OUT, name)) as im:
            own = np.asarray(im)
            hashes = {"None": array_sha(own)}
            for m in ("RGB", "L"):
                try:
                    hashes[m] = array_sha(np.asarray(im.convert(m)))
                except ValueError:              # Pillow refuses "LAB" to "L": a null hash
                    hashes[m] = None
            entry.update(mode=im.mode, shape=list(own.shape), dtype=str(own.dtype),
                         sha256=hashes)
    except (OSError, SyntaxError, ValueError, NotImplementedError) as err:
        entry.update(raises=True, pillow_error=f"{type(err).__name__}: {err}")
    return entry


def libavif_version() -> str:
    """The manifest's ``libavif`` entry: the version of Pillow's libavif and
    of its dav1d (which decodes for Pillow), aom (which encodes) and libyuv,
    "1.3.0 (dav1d 1.5.1, aom 3.12.1, libyuv 1909)" here. libyuv's comes from
    the library itself (``avifLibYUVVersion``), the rest from Pillow."""
    import ctypes
    import glob

    import PIL
    from PIL import _avif, features

    versions = dict(part.split(" [")[0:1] + part.split(":")[1:2]
                    for part in _avif.codec_versions().split(", "))
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*"))[0])
    lib.avifLibYUVVersion.restype = ctypes.c_uint
    return (f"{features.version('avif')} (dav1d {versions['dav1d'].split('-')[0]}, aom "
            f"{versions['aom'].lstrip('v')}, libyuv {lib.avifLibYUVVersion()})")


def write_group(group: str) -> int:
    """``--only GROUP``: write the files of one ``*_formats`` function and
    put their entries into the existing ``manifest.json``."""
    make = globals().get(group)
    if not group.endswith("_formats") or not callable(make):
        groups = sorted(k for k, v in globals().items() if k.endswith("_formats") and callable(v))
        print(f"make_image_fixtures: no group {group!r}; the groups: {', '.join(groups)}",
              file=sys.stderr)
        return 2
    path = os.path.join(OUT, "manifest.json")
    with open(path) as fh:
        manifest = json.load(fh)
    at = {e["file"]: k for k, e in enumerate(manifest["files"])}
    written = make()
    for name, (kind, data) in written.items():
        entry = write_fixture(name, kind, data)
        if name in at:
            manifest["files"][at[name]] = entry
        else:
            manifest["files"].append(entry)
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    print(f"wrote {len(written)} fixtures of {group} under {OUT} and their manifest entries")
    return 0


def main() -> int:
    try:
        import PIL
        from PIL import features
    except ImportError:
        print("make_image_fixtures: needs Pillow", file=sys.stderr)
        return 2
    if "--damaged" in sys.argv[1:]:
        return write_damaged()
    if "--only" in sys.argv[1:]:
        return write_group(sys.argv[sys.argv.index("--only") + 1])
    os.makedirs(OUT, exist_ok=True)
    entries = [write_fixture(name, kind, data) for name, (kind, data) in fixtures().items()]
    manifest = dict(pillow=PIL.__version__, libjpeg_turbo=features.version("libjpeg_turbo"),
                    libwebp=features.version("webp"), openjpeg=features.version("jpg_2000"),
                    libtiff=features.version("libtiff"), files=entries,
                    step_video=step_video_entry(), libavif=libavif_version())
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    total = sum(e["bytes"] for e in entries)
    print(f"wrote {len(entries)} fixtures, {total} bytes, under {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
