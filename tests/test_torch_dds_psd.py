"""The port's DDS and PSD readers (``utils/dds.py`` with its native twin
``native/src/bcn_decode.cpp``, ``utils/psd.py`` with
``native/codecs.packbits_rows_decode``) against Pillow 12.1.0, bit for bit,
with no tolerance:

- DDS: Pillow-written DXT1/3/5, BC2/3/5 and uncompressed files; seeded
  random blocks of every FourCC and DXGI format Pillow reads (Pillow decodes
  any block bytes, so they reach BC1's three-colour mode, every BC7 mode and
  BC6H mode code, signed and unsigned); bit masks, luminance, palettes; the
  formats Pillow refuses refused;
- PSD: every colour mode Pillow reads, raw and PackBits, with image
  resources and a layer, files with more channels than the mode uses (PIL
  takes the PackBits counts of the channels it reads only), "LAB" (its own
  array, "RGB" through Little CMS's transform, "L" refused as PIL refuses
  it), and the files Pillow refuses;
- the plain and native paths equal, modes None, RGB and L through
  ``read_image``, and the 2048 x 1536 atlas as DDS BC7, DDS DXT1 and PSD.
"""
import gzip
import io
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import dds, lcms, psd
from coma_tpu_torch.utils.image_io import read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (array_sha, bc7_mode6, bc_blocks, dds_file,  # noqa: E402
                                 psd_file, seeded_rgb)

MODES = (None, "RGB", "L")
REFUSALS = (OSError, SyntaxError, ValueError, NotImplementedError)


def need_gpp():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native decoders cannot be built")


def pillow_arrays(path):
    with Image.open(path) as im:
        im.load()
        return {m: np.asarray(im if m is None else im.convert(m)) for m in MODES}


def check(tmp_path, data: bytes, name: str, reader) -> None:
    """Every mode equal to Pillow's through ``read_image`` (a refusal where
    Pillow refuses, naming the file), and the plain and native readers equal."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        want = pillow_arrays(path)
    except REFUSALS:
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(path))
        return
    for m in MODES:
        got = read_image(str(path), m)
        assert got.shape == want[m].shape and got.dtype == want[m].dtype, (m, got.shape)
        np.testing.assert_array_equal(got, want[m])
    np.testing.assert_array_equal(reader(data, name, native=False).pixels, want[None])
    if shutil.which("g++"):
        np.testing.assert_array_equal(reader(data, name, native=True).pixels, want[None])


W, H = 19, 13
FOURCC = [(b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16), (b"ATI1", 8), (b"BC4U", 8), (b"ATI2", 16),
          (b"BC5U", 16), (b"BC5S", 16), (b"BC4S", 8), (b"DXT2", 16)]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("fourcc,size", FOURCC, ids=[f.decode() for f, _ in FOURCC])
def test_fourcc_blocks_equal_pillow(tmp_path, fourcc, size, seed):
    """Seeded blocks under each FourCC (BC4S and DXT2 refused, as Pillow
    refuses them)."""
    check(tmp_path, dds_file(W, H, bc_blocks(W, H, size, seed), fourcc=fourcc), "x.dds",
          dds.decode_dds)


DXGI = [70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 94, 95, 96, 97, 98, 99, 28, 87]


@pytest.mark.parametrize("dxgi", DXGI)
def test_dx10_formats_equal_pillow(tmp_path, dxgi):
    """Every DXGI format near the ones Pillow reads: the typeless, unorm,
    snorm and sRGB forms it takes, the ones it refuses refused."""
    if dxgi in (28, 87):                            # uncompressed RGBA / BGRA
        body = bc_blocks(W, H * 4, 16, dxgi)[:W * H * 4]
    else:
        body = bc_blocks(W, H, 8 if dxgi in (70, 71, 72, 79, 80, 81) else 16, dxgi)
    check(tmp_path, dds_file(W, H, body, fourcc=b"DX10", dxgi=dxgi), "x.dds", dds.decode_dds)


@pytest.mark.parametrize("mode", range(9))
def test_bc7_modes_equal_pillow(tmp_path, mode):
    """Blocks of one BC7 mode each (8: no mode bit, opaque black)."""
    body = bc_blocks(W, H, 16, 70 + mode, first=(min(mode + 1, 8), (1 << mode) & 0xFF))
    check(tmp_path, dds_file(W, H, body, fourcc=b"DX10", dxgi=98), "x.dds", dds.decode_dds)


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
@pytest.mark.parametrize("code", range(0, 32, 1))
def test_bc6h_mode_codes_equal_pillow(tmp_path, code, signed):
    """Each 5-bit BC6H mode code (the 2-bit ones, the 14 modes and the
    reserved ones), unsigned and signed."""
    body = bc_blocks(W, H, 16, 100 + code + 32 * signed, first=(5, code))
    check(tmp_path, dds_file(W, H, body, fourcc=b"DX10", dxgi=96 if signed else 95), "x.dds",
          dds.decode_dds)


PILLOW_DDS = [("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"), ("BC2", "RGBA"),
              ("BC3", "RGBA"), ("BC5", "RGB"), (None, "RGB"), (None, "RGBA"), (None, "L"),
              (None, "LA")]


@pytest.mark.parametrize("fmt,mode", PILLOW_DDS, ids=[f"{f}-{m}" for f, m in PILLOW_DDS])
def test_pillow_written_dds_equal_pillow(tmp_path, fmt, mode):
    rgb = seeded_rgb((H, W), 3)
    im = Image.fromarray(np.dstack([rgb, rgb[..., :1]]) if mode == "RGBA" else rgb).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "DDS", **({"pixel_format": fmt} if fmt else {}))
    check(tmp_path, buf.getvalue(), "x.dds", dds.decode_dds)


def _mask_cases():
    words2 = bc_blocks(W, H, 32, 9)[:W * H * 2]
    words4 = bc_blocks(W, H * 2, 32, 10)[:W * H * 4]
    return {
        "rgb565": dds_file(W, H, words2, pfflags=0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "argb1555": dds_file(W, H, words2, pfflags=0x41, bitcount=16,
                             masks=(0x7C00, 0x3E0, 0x1F, 0x8000)),
        "argb4444": dds_file(W, H, words2, pfflags=0x41, bitcount=16,
                             masks=(0xF00, 0xF0, 0xF, 0xF000)),
        "xbgr32": dds_file(W, H, words4, pfflags=0x40, bitcount=32,
                           masks=(0xFF, 0xFF00, 0xFF0000, 0)),
        "rgb24": dds_file(W, H, words4[:W * H * 3], pfflags=0x40, bitcount=24,
                          masks=(0xFF0000, 0xFF00, 0xFF, 0)),
        "short_data": dds_file(W, H, words2[:100], pfflags=0x40, bitcount=16,
                               masks=(0xF800, 0x7E0, 0x1F, 0)),
        "palette": dds_file(W, H, words4[:1024] + words2[:W * H], pfflags=0x20, bitcount=8),
        "luminance_16_no_alpha": dds_file(W, H, words2, pfflags=0x20000, bitcount=16),
        "fourcc_unknown": dds_file(W, H, words2, fourcc=b"ABCD"),
        "no_flags": dds_file(W, H, words2, pfflags=0, bitcount=8),
        "header_size": b"DDS " + struct.pack("<I", 100) + bytes(120),
        "bc7_mipmaps": dds_file(16, 16, bc7_mode6(np.dstack([seeded_rgb((16, 16), 4)] * 2)[..., :4])
                                + bytes(48), fourcc=b"DX10", dxgi=98, mipmaps=3),
        "truncated_blocks": dds_file(W, H, bc_blocks(W, H, 16, 11)[:-20], fourcc=b"DXT5"),
    }


@pytest.mark.parametrize("name", list(_mask_cases()))
def test_dds_variants_equal_pillow(tmp_path, name):
    """Bit masks (Pillow's ``int(v / max * 255)``), palettes, mip levels after
    the first surface, and the headers and data Pillow refuses."""
    check(tmp_path, _mask_cases()[name], f"{name}.dds", dds.decode_dds)


def test_native_bcn_equals_plain_on_random_blocks():
    """Every block format over 4 x 7 blocks of random bytes at an odd size."""
    need_gpp()
    assert codecs.bcn_available()
    for fmt, (_, size, _) in dds.BCN.items():
        data = bc_blocks(27, 25, size, len(fmt))
        np.testing.assert_array_equal(
            codecs.bcn_decode(data, dds.BCN[fmt][0], fmt in ("BC5S", "BC6HS"), 27, 25),
            dds.bcn_decode_python(data, fmt, 27, 25))


def _psd_cases():
    rng = np.random.default_rng(80)
    rgb = seeded_rgb((13, 19), 81)
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1))
    alpha = rng.integers(0, 256, (1, 13, 19)).astype(np.uint8)
    pal = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    bitmap = np.packbits(planes[:1] > 100, axis=2)
    return {
        "rgb_raw": psd_file(planes, 3), "rgb_rle": psd_file(planes, 3, rle=True),
        "rgb_no_sections": psd_file(planes, 3, rle=True, resources=False, layer=False),
        "rgba_rle": psd_file(np.concatenate([planes, alpha]), 3, rle=True),
        "rgb_5_channels_rle": psd_file(np.concatenate([planes, alpha, alpha]), 3, rle=True),
        "rgb_5_channels_raw": psd_file(np.concatenate([planes, alpha, alpha]), 3),
        "gray_rle": psd_file(planes[:1], 1, rle=True),
        "gray_2_channels_rle": psd_file(np.concatenate([planes[:1], alpha]), 1, rle=True),
        "multichannel_rle": psd_file(planes, 7, rle=True),
        "duotone": psd_file(planes[:1], 8, color_data=b"duotone data"),
        "indexed": psd_file(planes[:1], 2, color_data=pal, rle=True),
        "indexed_no_palette": psd_file(planes[:1], 2),
        "cmyk_rle": psd_file(np.concatenate([planes, alpha]), 4, rle=True),
        "cmyk_raw": psd_file(np.concatenate([planes, alpha]), 4),
        "bitmap_rle": psd_file(bitmap, 0, bits=1, rle=True),
        "bitmap_raw": psd_file(bitmap, 0, bits=1),
        "too_few_channels": psd_file(planes[:2], 3),
        "bits_16": psd_file(planes, 3, bits=16),
        "bits_32": psd_file(planes, 3, bits=32),
        "psb": b"8BPS\x00\x02" + psd_file(planes, 3)[6:],
        "zip": psd_file(planes, 3)[:-(13 * 19 * 3 + 2)] + b"\x00\x02" + bytes(300),
        "truncated_raw": psd_file(planes, 3)[:-30],
        "truncated_rle": psd_file(planes, 3, rle=True)[:-30],
        "mode_5": psd_file(planes, 5),
    }


@pytest.mark.parametrize("name", list(_psd_cases()))
def test_psd_equals_pillow(tmp_path, name):
    """Every colour mode PIL reads, raw and PackBits, and PIL's refusals."""
    check(tmp_path, _psd_cases()[name], f"{name}.psd", psd.decode_psd)


def test_psd_lab_own_array_and_refused_conversions(tmp_path):
    """A Lab PSD: ``np.asarray`` as PIL holds it (a and b signed); "RGB"
    equals PIL's conversion through Little CMS, on both paths; PIL refuses
    "L", and so does the port, naming the file."""
    planes = np.ascontiguousarray(seeded_rgb((13, 19), 82).transpose(2, 0, 1))
    path = tmp_path / "lab.psd"
    path.write_bytes(psd_file(planes, 9, rle=True))
    with Image.open(path) as im:
        assert im.mode == "LAB"
        np.testing.assert_array_equal(read_image(str(path)), np.asarray(im))
        want = np.asarray(im.convert("RGB"))
        with pytest.raises(ValueError):
            im.convert("L")
    np.testing.assert_array_equal(read_image(str(path), "RGB"), want)
    decoded = psd.decode_psd(path.read_bytes(), "lab.psd", native=False)
    np.testing.assert_array_equal(lcms.lab_to_rgb(decoded.pixels, native=False), want)
    with pytest.raises(ValueError, match=r"lab\.psd.*LAB"):
        read_image(str(path), "L")


def test_psd_packbits_rows_native_equals_plain():
    """PIL's row-cut PackBits on random bytes (packets across row ends, the
    0x80 no-op, data ending early) through both decoders."""
    need_gpp()
    rng = np.random.default_rng(83)
    for k in range(20):
        data = rng.integers(0, 256, 400 + 37 * k).astype(np.uint8).tobytes()
        outcomes = []
        for fn in (psd.packbits_rows_python, codecs.packbits_rows_decode):
            try:
                outcomes.append(fn(data, 3, 7 + k, 9))
            except ValueError:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1]


def _manifest() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        return {e["file"]: e for e in json.load(fh)["files"]}


def fixture_bytes(entry: dict) -> bytes:
    with open(os.path.join(FIXTURES, entry.get("stored", entry["file"])), "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if entry.get("stored", "").endswith(".gz") else data


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("name", ["atlas_dxt1_2048x1536.dds", "atlas_rle_2048x1536.psd",
                                  "atlas_bc7_2048x1536.dds"])
def test_atlas_equals_pillow_hash(name, native):
    """The 2048 x 1536 atlas as DDS DXT1, PSD PackBits and DDS BC7 (the
    plain BC7 decoder, Python per block, only on its first block rows)."""
    if native:
        need_gpp()
    entry = _manifest()[name]
    data = fixture_bytes(entry)
    reader = dds.decode_dds if name.endswith(".dds") else psd.decode_psd
    if name.startswith("atlas_bc7") and not native:
        head = dds.bcn_decode_python(data[148:148 + 512 * 16 * 2], "BC7", 2048, 8)
        full = reader(data, name, native=True).pixels if shutil.which("g++") else None
        if full is not None:
            np.testing.assert_array_equal(head, full[:8])
        return
    assert array_sha(reader(data, name, native=native).pixels) == entry["sha256"]["None"]
