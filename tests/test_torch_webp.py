"""The port's WebP reader (``utils/webp.py``, ``utils/vp8.py``,
``utils/vp8l.py`` and their native twin ``native/src/webp_decode.cpp``)
against Pillow 12.1.0 (libwebp 1.6.0), bit for bit, with no tolerance:

- files Pillow writes at test time: lossy at several sizes (1 x 1, sizes
  that are not multiples of 16), qualities and methods, lossy with alpha,
  lossless (predictor, cross-colour, subtract-green, colour indexing with
  bundling, colour cache, LZ77), with ICC and EXIF chunks;
- files libwebp writes through its advanced API (``tools/make_image_fixtures
  .libwebp_encode``) with settings Pillow does not pass: the simple loop
  filter, every sharpness, 2, 4 and 8 token partitions, 1-4 segments, the
  skip probability, raw and lossless-coded alpha under each filter; and
  frame headers its encoder never writes (``vp8_header_rewrite``: relative
  segment values, loop-filter deltas);
- raw ALPH chunks under each of the three unfilters, animations whose frame 0
  does not cover the canvas;
- modes None, RGB and L through ``read_image``, the plain and native paths
  equal, and the files Pillow refuses refused naming the file.

The committed WebP fixtures and the 2048 x 1536 atlas are held in
``tests/test_torch_image_io.py`` and here.
"""
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import webp
from coma_tpu_torch.utils.image_io import read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (array_sha, libwebp_encode, seeded_rgb,  # noqa: E402
                                 vp8_header_rewrite, webp_animation, webp_with_alpha)

MODES = (None, "RGB", "L")


def need_gpp():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native WebP decoder cannot be built")


def pil_bytes(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "WEBP", **kw)
    return buf.getvalue()


def check(tmp_path, data: bytes, name: str = "x.webp") -> None:
    """Every mode equal to Pillow's through ``read_image``, and the plain and
    native decoders equal; where Pillow refuses, a ``ValueError`` naming the
    file."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            im.load()
            want = {m: np.asarray(im if m is None else im.convert(m)) for m in MODES}
    except (OSError, SyntaxError, ValueError):
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(path))
        return
    for m in MODES:
        got = read_image(str(path), m)
        assert got.shape == want[m].shape and got.dtype == want[m].dtype
        np.testing.assert_array_equal(got, want[m])
    plain = webp.decode_webp(data, name, native=False)
    np.testing.assert_array_equal(plain.pixels, want[None])
    if codecs.webp_available():
        np.testing.assert_array_equal(webp.decode_webp(data, name, native=True).pixels,
                                      want[None])


def image(shape, seed, noise=20.0, alpha=False):
    rgb = seeded_rgb(shape, seed, noise=noise)
    if not alpha:
        return rgb
    rng = np.random.default_rng(seed)
    a = np.clip(rng.normal(180, 70, shape + (1,)), 0, 255).astype(np.uint8)
    a[: shape[0] // 3] = 255
    return np.concatenate([rgb, a], -1)


LOSSY = [((1, 1), 50, 4), ((17, 33), 75, 0), ((17, 33), 10, 6), ((16, 16), 90, 2),
         ((37, 53), 30, 4), ((64, 48), 95, 6), ((48, 130), 60, 1), ((33, 17), 100, 3),
         ((2, 70), 40, 5), ((70, 2), 80, 4)]


@pytest.mark.parametrize("shape,quality,method", LOSSY,
                         ids=[f"{s[0]}x{s[1]}-q{q}-m{m}" for s, q, m in LOSSY])
def test_pillow_lossy_equals_pillow(tmp_path, shape, quality, method):
    """VP8 key frames: segments, intra 16x16 and 4x4 modes, the normal loop
    filter, the fancy upsampler at odd sizes and the 1 x 1 edge cases."""
    check(tmp_path, pil_bytes(image(shape, sum(shape) + quality), quality=quality, method=method))


@pytest.mark.parametrize("shape,quality", [((17, 33), 70), ((40, 24), 90), ((1, 5), 50),
                                           ((66, 35), 30)])
def test_pillow_lossy_alpha_equals_pillow(tmp_path, shape, quality):
    """ALPH (lossless-coded, filtered) over a lossy picture, not
    premultiplied: "RGBA", and RGB drops the alpha."""
    check(tmp_path, pil_bytes(image(shape, 3 + quality, alpha=True), quality=quality))


LOSSLESS = [((17, 33), 0, False), ((37, 53), 3, True), ((64, 48), 6, False), ((1, 1), 4, True),
            ((9, 130), 5, False), ((70, 40), 1, True)]


@pytest.mark.parametrize("shape,method,alpha", LOSSLESS,
                         ids=[f"{s[0]}x{s[1]}-m{m}-{'rgba' if a else 'rgb'}"
                              for s, m, a in LOSSLESS])
def test_pillow_lossless_equals_pillow(tmp_path, shape, method, alpha):
    """VP8L: the transforms, meta-Huffman codes, colour cache, LZ77."""
    check(tmp_path, pil_bytes(image(shape, 40 + method, noise=8.0 * method, alpha=alpha),
                              lossless=True, method=method))


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 200])
def test_pillow_lossless_palette_equals_pillow(tmp_path, colours):
    """Colour indexing: 1, 2 and 4-bit pixel bundling, and 8-bit indices."""
    rgb = Image.fromarray(image((29, 43), colours)).quantize(colours).convert("RGB")
    check(tmp_path, pil_bytes(np.asarray(rgb), lossless=True))


LIBWEBP = [
    ("simple-filter", (45, 70), dict(filter_type=0)),
    ("simple-sharp3", (45, 70), dict(filter_type=0, filter_sharpness=3)),
    ("simple-sharp7", (33, 33), dict(filter_type=0, filter_sharpness=7, filter_strength=100)),
    ("normal-sharp1", (45, 70), dict(filter_sharpness=1, filter_strength=80)),
    ("normal-sharp5", (45, 70), dict(filter_sharpness=5, filter_strength=100)),
    ("partitions-2", (70, 40), dict(partitions=1, method=2)),
    ("partitions-4", (70, 40), dict(partitions=2, method=2)),
    ("partitions-8", (140, 24), dict(partitions=3, method=2, filter_sharpness=2)),
    ("one-segment", (45, 70), dict(segments=1)),
    ("two-segments-sns", (45, 70), dict(segments=2, sns_strength=100)),
    ("no-filter", (45, 70), dict(filter_strength=0)),
    ("q2-m0", (45, 70), dict(quality=2, method=0)),
    ("alpha-raw-none", (30, 50), dict(alpha_compression=0, alpha_filtering=0)),
    ("alpha-raw-best", (30, 50), dict(alpha_compression=0, alpha_filtering=2)),
    ("alpha-vp8l-fast", (30, 50), dict(alpha_compression=1, alpha_filtering=1, alpha_quality=70)),
]


@pytest.mark.parametrize("name,shape,config", LIBWEBP, ids=[c[0] for c in LIBWEBP])
def test_libwebp_settings_equal_pillow(tmp_path, name, shape, config):
    """Settings only libwebp's API reaches: the simple filter, sharpness,
    several token partitions, fewer segments, raw alpha."""
    check(tmp_path, libwebp_encode(image(shape, len(name), noise=30,
                                         alpha=name.startswith("alpha")), **config))


HEADERS = [("relative-segments", {}, 0, 0), ("ref-delta", {}, 6, 0),
           ("both-deltas", {}, -9, 14), ("simple-filter-deltas", dict(filter_type=0), 10, -4),
           ("one-segment-deltas", dict(segments=1), 3, 3),
           ("skip-deltas", dict(quality=10, method=1), -20, 30)]


@pytest.mark.parametrize("name,config,ref_delta,mode_delta", HEADERS, ids=[h[0] for h in HEADERS])
def test_rewritten_frame_headers_equal_pillow(tmp_path, name, config, ref_delta, mode_delta):
    """Frame headers libwebp's encoder never writes, its first partition
    re-encoded by the fixture tool: segment quantisers and filter levels as
    deltas from the frame's, and the reference and 4x4-mode loop-filter
    deltas (the first case decodes to the unchanged picture)."""
    still = libwebp_encode(image((45, 70), 7, noise=30), **config)
    data = vp8_header_rewrite(still, ref_delta, mode_delta)
    if not (ref_delta or mode_delta):
        with Image.open(io.BytesIO(still)) as a, Image.open(io.BytesIO(data)) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    check(tmp_path, data)


def test_skip_probability_equals_pillow(tmp_path):
    """A flat picture with one busy patch at method 1: macroblocks skipped
    through the skip probability."""
    flat = np.full((96, 112, 3), 90, np.uint8)
    flat[20:50, 30:70] = seeded_rgb((30, 40), 3, noise=40)
    data = libwebp_encode(flat, quality=20, method=1)
    _, _, _, frame = webp._parse(data)
    at, size = frame[2][1:]
    from coma_tpu_torch.utils import vp8
    assert vp8._parse_header(data[at:at + size]).use_skip
    check(tmp_path, data)


@pytest.mark.parametrize("method", [0, 1, 2, 3], ids=["none", "horizontal", "vertical",
                                                      "gradient"])
def test_raw_alpha_unfilters_equal_pillow(tmp_path, method):
    """A raw ALPH chunk under each filter: libwebp's first-row and
    first-column rules and the gradient's clip."""
    rng = np.random.default_rng(60 + method)
    alpha = np.clip(rng.normal(128, 90, (23, 31)), 0, 255).astype(np.uint8)
    check(tmp_path, webp_with_alpha(pil_bytes(image((23, 31), 61), quality=60), alpha, method))


ANIMATIONS = [
    ("lossy-offset", (64, 48), [(6, 4, "lossy-rgba", (30, 40))], True),
    ("lossless-corner", (50, 40), [(10, 14, "lossless", (12, 20))], True),
    ("two-frames", (40, 30), [(0, 0, "lossy", (30, 40)), (2, 2, "lossless", (10, 10))], True),
    ("no-alpha-flag", (64, 48), [(8, 6, "lossy", (20, 30))], False),
]


@pytest.mark.parametrize("name,canvas,frames,alpha", ANIMATIONS, ids=[a[0] for a in ANIMATIONS])
def test_animation_frame0_equals_pillow(tmp_path, name, canvas, frames, alpha):
    """Frame 0 on a transparent canvas at its offset, as WebPAnimDecoder
    draws it; "RGB" when the VP8X flag has no alpha."""
    stills = []
    for x, y, kind, shape in frames:
        px = image(shape, x + y, alpha=kind.endswith("rgba"))
        stills.append((x, y, pil_bytes(px, lossless=True) if kind == "lossless"
                       else pil_bytes(px, quality=80)))
    check(tmp_path, webp_animation(canvas, stills, alpha=alpha))


def test_metadata_chunks_are_skipped(tmp_path):
    """ICCP, EXIF and XMP chunks around the image: skipped (no ICC applied)."""
    check(tmp_path, pil_bytes(image((20, 30), 7), quality=80, icc_profile=b"\0" * 64,
                              exif=b"Exif\0\0" + bytes(30), xmp=b"<x:xmpmeta/>"))


def _refused_cases():
    lossy = pil_bytes(image((20, 30), 8), quality=70)
    lossless = pil_bytes(image((20, 30), 9), lossless=True)
    bad_version = bytearray(lossless)
    at = lossless.index(b"VP8L") + 8
    bad_version[at + 4] |= 0x20                     # VP8L version bits
    return {
        "truncated": lossy[:-30],
        "riff-too-long": lossy[:4] + (len(lossy) + 50).to_bytes(4, "little") + lossy[8:],
        "vp8l-version": bytes(bad_version),
        "not-a-key-frame": lossy[:20] + bytes([lossy[20] | 1]) + lossy[21:],
        "no-image": b"RIFF" + (22).to_bytes(4, "little") + b"WEBPVP8X" + (10).to_bytes(4, "little")
        + bytes(10),
    }


@pytest.mark.parametrize("name", list(_refused_cases()))
def test_refused_like_pillow(tmp_path, name):
    """Files libwebp refuses: refused naming the file."""
    check(tmp_path, _refused_cases()[name], f"refused-{name}.webp")


def test_native_and_plain_equal_on_every_webp_fixture():
    """Every small committed WebP fixture through both decoders."""
    need_gpp()
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entries = json.load(fh)["files"]
    seen = 0
    for e in entries:
        if not e["file"].endswith(".webp") or e.get("raises") or e["shape"][0] > 128:
            continue
        with open(os.path.join(FIXTURES, e["file"]), "rb") as fh:
            data = fh.read()
        plain = webp.decode_webp(data, e["file"], native=False)
        native = webp.decode_webp(data, e["file"], native=True)
        np.testing.assert_array_equal(plain.pixels, native.pixels)
        assert array_sha(native.pixels) == e["sha256"]["None"]
        seen += 1
    assert seen >= 10


@pytest.mark.parametrize("name", ["atlas_lossy_2048x1536.webp", "atlas_lossless_2048x1536.webp"])
def test_atlas_equals_pillow_hash(name):
    """The 2048 x 1536 atlas, lossy and lossless, through the native decoder
    (the plain one takes minutes at this size)."""
    need_gpp()
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entry = {e["file"]: e for e in json.load(fh)["files"]}[name]
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        data = fh.read()
    assert array_sha(webp.decode_webp(data, name, native=True).pixels) == entry["sha256"]["None"]
