#!/usr/bin/env python3
"""Write the image fixtures of ``tests/data/images/`` and their manifest.

    python3 tools/make_image_fixtures.py

Needs Pillow (the CPU test host has it; the card machine does not, which is
why the files and the manifest are committed). Every image is made from a
numpy seed and written by Pillow, except the interlaced PNGs, which Pillow
cannot write: :func:`adam7_png` writes those, and Pillow reads them back.
``manifest.json`` records, per file, its mode, its shape, and the SHA-256 of
``np.asarray(Image.open(f).convert(m)).tobytes()`` for m in RGB and L (or
``"raises": true`` where ``coma_tpu_torch.utils.image_io.read_image`` must
refuse the file), with the Pillow and libjpeg-turbo versions that decoded
them. The readers' tests and ``chip_smoke.py`` phase 16 hold the port's
decoder against these hashes.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "images")
BEHAVE_SIZE = (1536, 2048)       # BEHAVE's Kinect colour frames: 2048 x 1536


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
    out["cmyk.jpg"] = ("CMYK (refused)", jpeg(cmyk, quality=75))
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
    return out


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
        with Image.open(path) as im:
            entry = dict(file=name, kind=kind, mode=im.mode, bytes=len(data))
            if im.mode == "CMYK":
                entry.update(shape=[im.height, im.width, 4], raises=True)
            else:
                arrays = {m: np.asarray(im.convert(m)) for m in ("RGB", "L")}
                entry.update(shape=list(np.asarray(im).shape), sha256={
                    m: hashlib.sha256(a.tobytes()).hexdigest() for m, a in arrays.items()})
        entries.append(entry)
    manifest = dict(pillow=PIL.__version__, libjpeg_turbo=features.version("libjpeg_turbo"),
                    files=entries)
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    total = sum(e["bytes"] for e in entries)
    print(f"wrote {len(entries)} fixtures, {total} bytes, under {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
