"""AVIF files read as Pillow 12.1.0 reads them (libavif 1.3.0 over dav1d
1.5.1 and libyuv 1909), for frames that are coded-lossless or lossy as
Pillow writes them at any speed: the deblocking filter, CDEF (aom's
enable-cdef=1) and Wiener, self-guided and switchable loop restoration
(speeds 0 to 4) included, AV1's screen content tools, which aom turns on
for flat-coloured and lettered images at any quality (palette mode and
intra block copy), quantizer matrices (aom's still-image tune=iq, or
enable-qm) and film grain (aom's denoiser, its test vectors and grain
tables), which dav1d synthesises onto the colour and the alpha item.

:func:`decode_avif` takes the primary item (and its alpha item) from the
HEIF container (``utils/heif.py``), decodes each AV1 payload's first frame
with the port's AV1 decoder (``native/src/av1_decode.cpp``, host C++ bound
in ``native/codecs.py``) and converts the planes as libavif's
``avifImageYUVToRGB`` does with ``AVIF_CHROMA_UPSAMPLING_AUTOMATIC``:
libyuv's ``I4xxToARGBMatrixFilter`` in its 6-bit fixed point, with 4:2:0
chroma upsampled bilinearly (``ScaleRowUp2_Bilinear``, 9-3-3-1) and 4:2:2
linearly (``ScaleRowUp2_Linear``, 3-1), the edges as libyuv's ``Any``
wrappers take them; 4:0:0 through libyuv's ``I400ToARGBMatrix`` into RGBA
and libavif's own float path into RGB (libyuv has no 3-byte row). The matrix and
range come from the ``colr`` ``nclx`` property, else from the AV1 sequence
header: BT.601 (and unspecified, which libavif reads as BT.601), BT.709 and
BT.2020 NCL at full or limited range, and identity at full range (G, B, R
from Y, U, V, libavif's own copy). The mode is "RGBA" where an alpha item
is present, else "RGB". The alpha plane is copied as libavif copies it: a
limited-range one mapped to full range (``avifLimitedToFullY``), and where
the primary item's ``prem`` reference says the colour is premultiplied, the
colour divided by it as libyuv's SIMD ``ARGBUnattenuate`` rows divide.

Refused with ``utils.modes.FormatNotRead`` (format "AVIF", the detail
naming what is not read): AV1 delta lf, segment loop filter levels,
superres and high bit depth, a first shown frame that is not a key frame,
another matrix, an ``ispe`` other than the frame's size (libavif resizes
the frame to it), and what ``utils/heif.py`` refuses (``grid`` items and
``avis`` sequences among it). A damaged or truncated file raises a
``ValueError`` naming the file. No PIL here.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import heif
from coma_tpu_torch.utils.modes import Decoded, FormatNotRead

# av1_decode.cpp's refusal codes and the words that name them
REFUSALS = {-4: "AV1 superres", -6: "AV1 high bit depth", -7: "AV1 inter frame",
            -12: "AV1 delta lf", -14: "AV1 segment loop filter levels"}
TOO_LARGE = -8

# libyuv's YuvConstants, (YG, YB, UB, UG, VG, VR), by (matrix, full range)
LIBYUV_CONSTANTS = {
    ("BT.601", 1): (16320, 32, 113, 22, 46, 90),         # kYuvJPEGConstants
    ("BT.601", 0): (18997, -1160, 128, 25, 52, 102),     # kYuvI601Constants
    ("BT.709", 1): (16320, 32, 119, 12, 30, 101),        # kYuvF709Constants
    ("BT.709", 0): (18997, -1160, 128, 14, 34, 115),     # kYuvH709Constants
    ("BT.2020", 1): (16320, 32, 120, 11, 37, 94),        # kYuvV2020Constants
    ("BT.2020", 0): (19003, -1160, 128, 12, 42, 107),    # kYuv2020Constants
}
# matrix_coefficients -> libavif's choice of libyuv constants
MATRICES = {1: "BT.709", 2: "BT.601", 5: "BT.601", 6: "BT.601", 9: "BT.2020"}


def upsample_linear(rows: np.ndarray, width: int) -> np.ndarray:
    """``ScaleRowUp2_Linear_Any_C``: (..., ceil(width / 2)) -> (..., width)."""
    s = rows.astype(np.int32)
    out = np.empty(s.shape[:-1] + (width,), np.int32)
    out[..., 0] = s[..., 0]
    k = ((width - 1) & ~1) // 2
    a, b = s[..., :k], s[..., 1:k + 1]
    out[..., 1:1 + 2 * k:2] = (3 * a + b + 2) >> 2
    out[..., 2:2 + 2 * k:2] = (a + 3 * b + 2) >> 2
    out[..., width - 1] = s[..., (width - 1) // 2]
    return out


def upsample_bilinear(top: np.ndarray, bottom: np.ndarray, width: int) -> tuple:
    """``ScaleRowUp2_Bilinear_Any_C`` on pairs of chroma rows (P, cw): the
    two output rows of each pair, (P, width) each."""
    s, t = top.astype(np.int32), bottom.astype(np.int32)
    da = np.empty((s.shape[0], width), np.int32)
    db = np.empty_like(da)
    da[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
    db[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
    k = ((width - 1) & ~1) // 2
    s0, s1, t0, t1 = s[:, :k], s[:, 1:k + 1], t[:, :k], t[:, 1:k + 1]
    da[:, 1:1 + 2 * k:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
    da[:, 2:2 + 2 * k:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
    db[:, 1:1 + 2 * k:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
    db[:, 2:2 + 2 * k:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    j = (width - 1) // 2
    da[:, width - 1] = (3 * s[:, j] + t[:, j] + 2) >> 2
    db[:, width - 1] = (s[:, j] + 3 * t[:, j] + 2) >> 2
    return da, db


def upsample_chroma(plane: np.ndarray, width: int, height: int, sx: int, sy: int) -> np.ndarray:
    """A chroma plane at the luma's size, as ``I420ToARGBMatrixBilinear``
    and ``I422ToARGBMatrixLinear`` feed ``I444ToARGBRow``."""
    if not sx:
        return plane.astype(np.int32)
    if not sy:
        return upsample_linear(plane, width)
    out = np.empty((height, width), np.int32)
    out[0] = upsample_linear(plane[0], width)
    pairs = (height - 1) // 2
    if pairs:
        da, db = upsample_bilinear(plane[:pairs], plane[1:pairs + 1], width)
        out[1:1 + 2 * pairs:2] = da
        out[2:2 + 2 * pairs:2] = db
    if not height & 1:
        out[height - 1] = upsample_linear(plane[pairs], width)
    return out


def gray_to_rgb(y: np.ndarray, full: int) -> np.ndarray:
    """libavif's own 4:0:0 conversion (``avifImageYUV8ToRGB8Mono``), which it
    runs for 3-byte RGB (libyuv has no I400 row to it): Y as a float32 unorm,
    ``(Y - 16) / 219`` at limited range, clamped to [0, 1], times 255 plus
    0.5, truncated; R = G = B."""
    f = np.float32
    unorm = (y.astype(f) - f(0 if full else 16)) / f(255 if full else 219)
    gray = (f(0.5) + np.clip(unorm, f(0), f(1)) * f(255)).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=-1)


def gray_to_rgb_libyuv(y: np.ndarray, constants: tuple) -> np.ndarray:
    """libyuv's ``I400ToARGBMatrix`` (``YPixel``), which libavif runs for
    4:0:0 into RGBA: R = G = B."""
    yg, yb = constants[:2]
    gray = np.clip((((y.astype(np.int32) * (0x0101 * yg)) >> 16) + yb) >> 6, 0, 255)
    return np.repeat(gray.astype(np.uint8)[..., None], 3, axis=-1)


def yuv_to_rgb_plain(planes: list, sx: int, sy: int, matrix: str, full: int) -> np.ndarray:
    """libyuv's ``YuvPixel`` on 8-bit Y, U, V planes, in numpy: (H, W, 3)
    uint8 R, G, B. The plain twin of ``native/src/av1_decode.cpp``'s
    ``yuv_to_rgb``, which the reader runs."""
    yg, yb, ub, ug, vg, vr = LIBYUV_CONSTANTS[(matrix, full)]
    y = planes[0]
    h, w = y.shape
    y1 = ((y.astype(np.int32) * (0x0101 * yg)) >> 16) + yb      # 255 * 257 * 19003 < 2^31
    u = upsample_chroma(planes[1], w, h, sx, sy) - 128
    v = upsample_chroma(planes[2], w, h, sx, sy) - 128
    rgb = np.empty((h, w, 3), np.uint8)
    for c, value in enumerate((y1 + v * vr, y1 - u * ug - v * vg, y1 + u * ub)):
        rgb[..., c] = np.clip(value >> 6, 0, 255)
    return rgb


def alpha_to_full(alpha: np.ndarray) -> np.ndarray:
    """libavif's ``avifLimitedToFullY`` at 8 bits, which it runs on an alpha
    plane of limited range: ((A - 16) * 255 + 109) / 219, clamped."""
    a = alpha.astype(np.int32)
    return np.clip(((a - 16) * 255 + 109) // 219, 0, 255).astype(np.uint8)


# libyuv's fixed_invtbl8 (its low halves): 8.8 fixed-point 1 / A
UNATTENUATE = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] + [0x100], np.int32)


def unattenuate(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libyuv's ``ARGBUnattenuateRow`` as Pillow's build runs it on x86 (its
    SSSE3 and AVX2 rows), which libavif calls to take a premultiplied colour
    back: v = (C * 0x0101 * ia) >> 16 in 16 bits, packed to a byte with
    signed saturation, so min(v, 255), but 0 where v passes 32767 (a colour
    of 128 or more over an alpha of 1, which only lossy coding makes; the C
    row would clamp it to 255)."""
    ia = UNATTENUATE[alpha][..., None].astype(np.int64)
    v = (rgb.astype(np.int64) * 0x0101 * ia) >> 16
    return np.where(v > 32767, 0, np.minimum(v, 255)).astype(np.uint8)


def decode_av1(payload: bytes, name: str, what: str) -> tuple:
    """(the AV1 header's info with what the decoder reached
    (``codecs.AV1_STATS``), its planes, the tiles' padding checks) of an
    item's first frame; a refusal or a fault raises naming the file."""
    status, info = codecs.av1_probe(payload)
    if status == 0:
        status, planes, padding, stats = codecs.av1_decode(payload, info)
        info.update(stats)
    if status in REFUSALS:
        raise FormatNotRead(name, "AVIF", f" ({REFUSALS[status]}, in its {what} item)")
    if status == TOO_LARGE:
        raise ValueError(f"{name}: AVIF: the {what} item's frame is over libavif's size limit "
                         "(libavif refuses it too)")
    if status:
        raise ValueError(f"{name}: AVIF: the {what} item's AV1 data is damaged or truncated "
                         "(dav1d refuses it too)")
    return info, planes, padding


def decode_avif_planes(data: bytes, name: str) -> tuple:
    """(the parsed container, the colour item's (info, planes, padding), the
    alpha item's or None)."""
    image = heif.parse_avif(data, name)
    color = decode_av1(image.color, name, "colour")
    alpha = decode_av1(image.alpha, name, "alpha") if image.alpha is not None else None
    return image, color, alpha


def decode_avif(data: bytes, name: str) -> Decoded:
    """An AVIF file -> Pillow's array and mode ("RGB" or "RGBA")."""
    image, (info, planes, _), alpha = decode_avif_planes(data, name)
    h, w = planes[0].shape
    if (w, h) != (image.width, image.height):
        raise FormatNotRead(name, "AVIF", f" (an ispe of {image.width} x {image.height} over an "
                                          f"AV1 frame of {w} x {h}, which libavif resizes)")
    if image.nclx is not None:
        mc, full = image.nclx[2], image.nclx[3]
    else:
        mc, full = info["matrix_coefficients"], info["color_range"]
    mono = len(planes) == 1
    if mono and mc == 0:
        mc = 6                          # libavif: 4:0:0 with identity is read as BT.601
    if mono and alpha is None:
        rgb = gray_to_rgb(planes[0], full)
    elif mc == 0 and full and not (info["subsampling_x"] or info["subsampling_y"]):
        rgb = np.stack([planes[2], planes[0], planes[1]], axis=-1)
    elif mc in MATRICES and mono:
        rgb = gray_to_rgb_libyuv(planes[0], LIBYUV_CONSTANTS[(MATRICES[mc], full)])
    elif mc in MATRICES:
        rgb = codecs.yuv_to_rgb(planes, info["subsampling_x"], info["subsampling_y"],
                                LIBYUV_CONSTANTS[(MATRICES[mc], full)])
    else:
        raise FormatNotRead(name, "AVIF", f" (matrix coefficients {mc} at "
                                          f"{'full' if full else 'limited'} range)")
    if alpha is None:
        return Decoded(rgb, "RGB")
    a = alpha[1][0] if alpha[0]["color_range"] else alpha_to_full(alpha[1][0])
    if a.shape != (h, w):
        raise ValueError(f"{name}: AVIF: the alpha item is {a.shape[1]} x {a.shape[0]}, the "
                         f"image {w} x {h} (libavif refuses it too)")
    if image.premultiplied:
        rgb = unattenuate(rgb, a)
    return Decoded(np.concatenate([rgb, a[..., None]], axis=-1), "RGBA")
