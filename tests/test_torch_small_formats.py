"""The port's readers of the small raster formats ``coma_tpu`` reads through
PIL (``utils/{qoi,sgi,pcx,ico,xbm,msp,sun,spider,im,icns,blp}.py``, the
bare DIB of ``utils/bmp.py``) and ``utils/image_io``'s dispatch in PIL's
plugin order, against Pillow 12.1.0, bit for bit, with no tolerance:

- seeded files Pillow writes (SGI, PCX, ICO, QOI, XBM, IM, ICNS, BLP, MSP,
  SPIDER, DIB) and files the fixture tool writes (SGI RLE, CUR, DCX, Sun
  raster, BLP2 DXT and BLP1 JPEG, ICNS run-length members, MSP version 2,
  big-endian SPIDER, every IM image type), for modes None, RGB and L
  through ``read_image``, and the plain and native (``native/src/
  image_codecs.cpp``, ``bcn_decode.cpp``) decoders equal; files Pillow
  refuses, refused naming the file;
- PIL's conversions of the modes these readers add ("F", "I", "I;16B",
  "PA", "RGBX", "YCbCr": every YCbCr triple);
- the formats Pillow reads and the port does not (AVIF with quantizer
  matrices, HTJ2K): a
  ``ValueError`` naming the file and the format; those Pillow opens here
  and cannot load (BUFR, GRIB, HDF5, EPS, MPEG, WMF/EMF): a plain
  ``ValueError`` naming the file, Pillow refusing it too; those the port
  once refused (FITS, FLI/FLC, FTEX, GBR, IMT, IPTC/NAA, McIdas, PhotoCD,
  PIXAR, XPM, XV thumbnails): equal to Pillow's;
- the order of the plugins that take any file (IM, IMT, IPTC, PCD,
  SPIDER, TGA): a TGA still a TGA, an IM or SPIDER file never one;
- the 2048 x 1536 atlas as QOI and SGI RLE against the manifest's hashes.
"""
import functools
import gzip
import io
import json
import os
import re
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.utils import blp, icns, im, jp2, msp, pcx, qoi, sgi, sun
from coma_tpu_torch.utils.image_io import PLUGINS, decode_image, read_image
from coma_tpu_torch.utils.modes import Decoded, FormatNotRead, to_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (array_sha, blp1_jpeg_file, blp2_file, dcx_file,  # noqa: E402
                                 icns_file, icns_rgb, im_file, msp_file, ONCE_REFUSED, pcx_file,
                                 PILLOW_REFUSES, REFUSED_FORMATS, refused_format_files,
                                 seeded_rgb, sgi_file, spider_file, sun_file)

MODES = (None, "RGB", "L")
REFUSALS = (OSError, SyntaxError, ValueError, NotImplementedError, IndexError, KeyError,
            TypeError, EOFError, struct.error)
NATIVE = shutil.which("g++") is not None


def pillow_arrays(path):
    with Image.open(path) as image:
        image.load()
        return {m: np.asarray(image if m is None else image.convert(m)) for m in MODES}


def check(tmp_path, data: bytes, name: str, reader=None) -> None:
    """Every mode equal to Pillow's through ``read_image`` (a refusal naming
    the file where Pillow refuses), and ``reader``'s plain and native paths
    equal to Pillow's own array."""
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
        assert got.shape == want[m].shape and got.dtype == want[m].dtype, \
            (m, got.shape, got.dtype, want[m].shape, want[m].dtype)
        np.testing.assert_array_equal(got, want[m])
    with Image.open(path) as image:
        image.load()
        assert decode_image(data, name).mode == image.mode
    if reader is not None:
        for native in (False, True) if NATIVE else (False,):
            np.testing.assert_array_equal(reader(data, name, native=native).pixels, want[None])


def pil_bytes(image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, fmt, **kw)
    return buf.getvalue()


RGB = seeded_rgb((24, 40), 160)
ALPHA = np.clip(np.random.default_rng(161).normal(180, 70, (24, 40, 1)), 0, 255).astype(np.uint8)
RGBA = np.concatenate([RGB, ALPHA], -1)


def pillow_images() -> dict:
    rgb = Image.fromarray(RGB)
    return {"RGB": rgb, "RGBA": Image.fromarray(RGBA), "L": Image.fromarray(RGB[..., 0]),
            "1": Image.fromarray(RGB[..., 1] > 120),
            "P": rgb.convert("P", palette=Image.Palette.ADAPTIVE, colors=20),
            "LA": Image.fromarray(RGBA[..., [0, 3]], "LA"),
            "PA": rgb.convert("P", palette=Image.Palette.ADAPTIVE, colors=9).convert("PA"),
            "I": Image.fromarray(RGB[..., 2].astype(np.int32) * 300 - 9000, "I"),
            "I;16": Image.fromarray(RGB[..., 2].astype(np.uint16) * 257),
            "I;16B": Image.fromarray(RGB[..., 2].astype(np.uint16) * 3).convert("I;16B"),
            "I;16L": Image.fromarray(RGB[..., 0].astype(np.uint16) * 2).convert("I;16L"),
            "F": Image.fromarray((RGB[..., 1].astype(np.float32) - 40) * 1.37, "F"),
            "RGBX": rgb.convert("RGBX"), "CMYK": rgb.convert("CMYK"),
            "YCbCr": rgb.convert("YCbCr")}


# --- Pillow-written files ----------------------------------------------------

PILLOW_WRITES = [
    ("SGI", "sgi", {}, ("RGB", "RGBA", "L")),
    ("SGI", "sgi", {"bpc": 2}, ("RGB", "RGBA", "L")),
    ("PCX", "pcx", {}, ("RGB", "L", "P", "1")),
    ("QOI", "qoi", {}, ("RGB", "RGBA")),
    ("XBM", "xbm", {}, ("1",)),
    ("IM", "im", {}, ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB",
                      "RGBA", "RGBX", "CMYK", "YCbCr")),
    ("MSP", "msp", {}, ("1",)),
    ("SPIDER", "spi", {}, ("F",)),
    ("DIB", "dib", {}, ("RGB", "L", "1", "P")),
    ("BLP", "blp", {}, ("P",)),
    ("BLP", "blp", {"blp_version": "BLP1"}, ("P",)),
    ("ICO", "ico", {}, ("RGB", "RGBA", "P", "L")),
    ("ICO", "ico", {"bitmap_format": "bmp"}, ("RGB", "RGBA", "P", "L", "1")),
    ("ICNS", "icns", {}, ("RGB", "RGBA")),
]
CASES = [(fmt, ext, kw, mode) for fmt, ext, kw, modes in PILLOW_WRITES for mode in modes]


@pytest.mark.parametrize("fmt,ext,kw,mode", CASES,
                         ids=[f"{c[0]}-{c[3]}-{'-'.join(f'{k}={v}' for k, v in c[2].items())}"
                              for c in CASES])
def test_pillow_written_files_equal_pillow(tmp_path, fmt, ext, kw, mode):
    image = pillow_images()[mode]
    if fmt == "BLP" and mode == "P":
        image = Image.fromarray(RGBA).quantize(30)      # an RGBA palette: alpha depth 1
    if fmt == "ICNS":
        image = Image.fromarray(seeded_rgb((64, 64), 162)).convert(mode)
    check(tmp_path, pil_bytes(image, fmt, **kw), f"pillow.{ext}")


def test_ico_picks_pillows_member(tmp_path):
    """A 40 x 24 image saved with Pillow's default sizes opens as its 24 x 14
    member; several depths of one size open as the lowest, as PIL sorts."""
    data = pil_bytes(Image.fromarray(RGBA), "ICO")
    check(tmp_path, data, "default.ico")
    with Image.open(io.BytesIO(data)) as image:
        assert image.size == (24, 14)
    square = Image.fromarray(seeded_rgb((32, 32), 163))
    data = pil_bytes(square, "ICO", bitmap_format="bmp", sizes=[(32, 32)],
                     append_images=[square.convert("P"), square.convert("RGBA")])
    check(tmp_path, data, "depths.ico")


# --- files the fixture tool writes -------------------------------------------

def _sgi_cases():
    rng = np.random.default_rng(170)
    flat = np.repeat(RGB[:, ::5], 5, axis=1)            # runs for the RLE
    yield "rgb_rle", sgi_file(flat.transpose(2, 0, 1), rle=True)
    yield "rgba_rle", sgi_file(np.concatenate([flat, ALPHA], -1).transpose(2, 0, 1), rle=True)
    yield "l_rle_dim1", sgi_file(flat[:1, :, 0][None], rle=True, dimension=1)
    yield "l_rle", sgi_file(flat[None, ..., 1], rle=True)
    yield "rgb16_rle", sgi_file((flat.astype(np.uint16) * 257 + rng.integers(0, 3, flat.shape)
                                 ).astype(np.uint16).transpose(2, 0, 1), rle=True)
    yield "l16_raw", sgi_file((RGB[None, ..., 0].astype(np.uint16) * 250), rle=False)
    yield "refused_two_channels", sgi_file(flat[..., :2].transpose(2, 0, 1), rle=False)
    cut = sgi_file(flat.transpose(2, 0, 1), rle=True)
    yield "refused_cut", cut[:-30]
    bad = bytearray(sgi_file(flat[None, ..., 0], rle=True))
    bad[512 + 8 * 24] = 0x7F                             # a run of 127 past its row's end
    yield "refused_overrun", bytes(bad)
    lengths = 512 + 4 * 3 * 24                           # the length table of rgb_rle
    huge = bytearray(sgi_file(flat.transpose(2, 0, 1), rle=True))
    huge[lengths + 4 * 19] = 0xAF                        # 2^31 and up: the row keeps the last
    yield "row_length_negative_as_int", bytes(huge)
    stop = bytearray(sgi_file(flat.transpose(2, 0, 1), rle=True))
    stop[lengths + 4 * 30:lengths + 4 * 31] = struct.pack(">I", 1)  # ends the image at row 6
    yield "nonzero_last_packet_ends_the_image", bytes(stop)


@pytest.mark.parametrize("name", [c[0] for c in _sgi_cases()])
def test_sgi_variants_equal_pillow(tmp_path, name):
    data = dict(_sgi_cases())[name]
    check(tmp_path, data, f"{name}.sgi", sgi.decode_sgi)


def _pcx_cases():
    rng = np.random.default_rng(171)
    w, h = 37, 21
    idx2 = rng.integers(0, 4, (h, w)).astype(np.uint8)
    idx4 = rng.integers(0, 16, (h, w)).astype(np.uint8)

    def planes(idx, n, stride):
        return np.concatenate([np.pad(np.packbits((idx >> k) & 1, axis=1),
                                      ((0, 0), (0, stride - (w + 7) // 8)))
                               for k in range(n)], 1)
    pal16 = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    yield "p2_planes", pcx_file(planes(idx2, 2, 5), w, h, 1, 2, version=5, palette16=pal16)
    yield "p4_planes", pcx_file(planes(idx4, 4, 5), w, h, 1, 4, version=5, palette16=pal16)
    yield "p4_padded_stride", pcx_file(planes(idx4, 4, 6), w, h, 1, 4, palette16=pal16,
                                       stride=6)
    rgb_rows = np.concatenate([np.pad(RGB[..., c], ((0, 0), (0, 1))) for c in range(3)], 1)
    yield "rgb_odd_stride", pcx_file(rgb_rows, 40, 24, 8, 3, stride=41)
    gray = RGB[..., 0][:, :39]
    yield "l_no_palette", pcx_file(np.pad(gray, ((0, 0), (0, 1))), 39, 24, 8, 1,
                                   stride=40) + bytes(800)
    yield "gray_ramp_palette", pcx_file(RGB[..., 1], 40, 24, 8, 1,
                                        palette256=bytes(np.repeat(np.arange(256), 3)
                                                         .astype(np.uint8)))
    yield "origin", pcx_file(RGB[..., 2], 40, 24, 8, 1, origin=(7, 3),
                             palette256=rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    yield "refused_empty_box", pcx_file(RGB[..., 2], 0, 24, 8, 1, origin=(5, 0))
    yield "refused_too_short_for_the_palette_look", pcx_file(RGB[:4, :8, 2], 8, 4, 8, 1)
    yield "refused_two_planes_8bit", pcx_file(np.concatenate([RGB[..., 0], RGB[..., 1]], 1),
                                              40, 24, 8, 2) + bytes(800)
    page = pil_bytes(Image.fromarray(RGB), "PCX")
    yield "refused_cut", page[:len(page) // 2]
    yield "dcx_two_pages", dcx_file([page, pil_bytes(Image.fromarray(RGB[..., 0]), "PCX")])
    yield "dcx_palette_page", dcx_file([pil_bytes(pillow_images()["P"], "PCX")])


@pytest.mark.parametrize("name", [c[0] for c in _pcx_cases()])
def test_pcx_and_dcx_variants_equal_pillow(tmp_path, name):
    data = dict(_pcx_cases())[name]
    ext = "dcx" if name.startswith("dcx") else "pcx"
    reader = pcx.decode_dcx if ext == "dcx" else pcx.decode_pcx
    check(tmp_path, data, f"{name}.{ext}", reader)


def _dib_and_mask_cases():
    dib = pil_bytes(pillow_images()["1"], "DIB")
    yield "dib_last_row_unpadded", dib[:-1]
    yield "refused_dib_last_row_cut", dib[:-5]
    ico = pil_bytes(pillow_images()["P"].crop((0, 0, 24, 24)), "ICO", bitmap_format="bmp",
                    sizes=[(24, 24)])
    yield "ico_and_mask_last_row_unpadded", ico[:-1]
    yield "refused_ico_and_mask_cut", ico[:-2]


@pytest.mark.parametrize("name", [c[0] for c in _dib_and_mask_cases()])
def test_last_rows_without_padding_equal_pillow(tmp_path, name):
    """PIL's raw decoder reads a last row's pixels and not its padding."""
    ext = "ico" if "ico" in name else "dib"
    check(tmp_path, dict(_dib_and_mask_cases())[name], f"{name}.{ext}")


def _png_cases():
    png = pil_bytes(Image.fromarray(RGB), "PNG")
    iend = png.rindex(b"IEND") - 4
    idat = png.index(b"IDAT") - 4
    yield "idat_bad_crc", png[:iend - 1] + bytes([png[iend - 1] ^ 1]) + png[iend:]
    yield "cut_after_idat", png[:iend + 3]
    yield "cut_inside_the_stream_tail", png[:iend - 6]
    broken = bytearray(png)
    broken[idat + 8 + 40] ^= 0x55
    yield "refused_broken_stream", bytes(broken)
    head = bytearray(png)
    head[idat - 1] ^= 1                                  # IHDR's CRC
    yield "refused_ihdr_bad_crc", bytes(head)
    (length,) = struct.unpack(">I", png[idat:idat + 4])
    stream = png[idat + 8:idat + 8 + length]
    sum_flipped = stream[:-1] + bytes([stream[-1] ^ 1])

    def with_stream(body: bytes) -> bytes:
        chunk = struct.pack(">I", len(body)) + b"IDAT" + body
        return png[:idat] + chunk + struct.pack(">I", zlib.crc32(chunk[4:])) + \
            png[idat + 12 + length:]
    yield "refused_bad_checksum_right_after_the_image", with_stream(sum_flipped)
    longer = zlib.compress(zlib.decompress(stream) + bytes(range(40)))
    yield "data_past_the_image", with_stream(longer)
    yield "bad_checksum_past_more_data", with_stream(longer[:-1] + bytes([longer[-1] ^ 1]))
    tail = png[:iend] + struct.pack(">I", 500) + b"tEXt" + b"cut short"
    yield "refused_a_text_chunk_cut_short", tail


@pytest.mark.parametrize("name", [c[0] for c in _png_cases()])
def test_png_damage_as_pillow_takes_it(tmp_path, name):
    """ICO and ICNS members are PNGs: an IDAT's CRC is not checked, the file
    may end after the image data, data past the image is not inflated (so a
    bad checksum after it goes unseen), and a broken zlib stream, a checksum
    right after the image, a header chunk's bad CRC or a later chunk cut
    short is refused, as PIL does."""
    check(tmp_path, dict(_png_cases())[name], f"{name}.png")


def _cur_cases():
    for mode in ("RGB", "RGBA", "P", "1"):
        ico = pil_bytes(pillow_images()[mode], "ICO", bitmap_format="bmp")
        yield f"cur_{mode}", ico[:2] + b"\2" + ico[3:]
        one = pil_bytes(pillow_images()[mode].crop((0, 0, 24, 24)), "ICO", bitmap_format="bmp",
                        sizes=[(24, 24)])
        yield f"cur_single_{mode}", one[:2] + b"\2" + one[3:]


@pytest.mark.parametrize("name", [c[0] for c in _cur_cases()])
def test_cursors_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_cur_cases())[name], f"{name}.cur")


def _sun_cases():
    rng = np.random.default_rng(172)
    flat = np.repeat(RGB[:, ::4], 4, axis=1)[:, :37]
    cmap = rng.integers(0, 256, 3 * 40).astype(np.uint8).tobytes()
    idx = (flat[..., 0] // 7).astype(np.uint8)
    for kind in (1, 2):
        yield f"rgb24_type{kind}", sun_file(flat[..., ::-1].reshape(24, -1), 37, 24, kind)
        yield f"bgrx32_type{kind}", sun_file(np.concatenate(
            [flat[..., ::-1], np.zeros((24, 37, 1), np.uint8)], -1).reshape(24, -1), 37, 32,
            kind)
        yield f"l8_type{kind}", sun_file(flat[..., 1], 37, 8, kind)
        yield f"p8_type{kind}", sun_file(idx, 37, 8, kind, colour_map=cmap)
        yield f"bits1_type{kind}", sun_file(np.packbits(flat[..., 2] > 100, axis=1), 37, 1, kind)
        nib = np.pad(idx % 16, ((0, 0), (0, 1)))
        yield f"l4_type{kind}", sun_file((nib[:, 0::2] << 4 | nib[:, 1::2]).astype(np.uint8), 37,
                                         4, kind)
    yield "rgb24_type3", sun_file(flat.reshape(24, -1), 37, 24, 3)
    yield "p4_type2", sun_file((np.pad(idx % 16, ((0, 0), (0, 1)))[:, 0::2] << 4).astype(
        np.uint8), 37, 4, 2, colour_map=cmap[:48])
    yield "runs_of_0x80", sun_file(np.full((24, 37), 0x80, np.uint8), 37, 8, 2)
    yield "refused_cut", sun_file(flat[..., 0], 37, 8, 2)[:-20]
    yield "refused_depth16", sun_file(flat[..., :2].reshape(24, -1), 37, 16, 1)
    yield "refused_rgb24_with_colour_map", sun_file(flat[..., ::-1].reshape(24, -1), 37, 24, 1,
                                                    colour_map=cmap)


@pytest.mark.parametrize("name", [c[0] for c in _sun_cases()])
def test_sun_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_sun_cases())[name], f"{name}.ras", sun.decode_sun)


def _msp_cases():
    bits = RGB[..., 0] > 110
    bits[3] = True                                      # a white row: count 0
    yield "v2_rle", msp_file(bits)
    yield "v1_raw", msp_file(bits, rle=False)
    yield "v2_odd_width", msp_file(bits[:, :29])
    rows = np.packbits(bits, axis=1)
    coded = [bytes([rows.shape[1]]) + r.tobytes() for r in rows]
    coded[5] = bytes([0, rows.shape[1] + 1, 0x5A])       # a row one byte too long: the rest move
    head = msp_file(bits)[:32]
    yield "v2_long_row", head + struct.pack(f"<{len(coded)}H", *map(len, coded)) + b"".join(coded)
    yield "refused_v2_row_map_cut", head + bytes(10)
    yield "refused_cut", msp_file(bits)[:-10]


@pytest.mark.parametrize("name", [c[0] for c in _msp_cases()])
def test_msp_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_msp_cases())[name], f"{name}.msp", msp.decode_msp)


def _spider_cases():
    f = (RGB[..., 1].astype(np.float32) - 60) * 1.73
    yield "big_endian", spider_file(f)
    yield "little_endian", spider_file(f, big_endian=False)
    yield "stack", spider_file(f, stack=True)
    yield "refused_cut", spider_file(f)[:-100]


@pytest.mark.parametrize("name", [c[0] for c in _spider_cases()])
def test_spider_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_spider_cases())[name], f"{name}.spi")


def _icns_cases():
    big = seeded_rgb((128, 128), 173, noise=4) // 8 * 8
    mask = np.clip(np.random.default_rng(174).normal(200, 50, (128, 128)), 0, 255).astype(
        np.uint8)
    yield "it32_mask", icns_file([(b"it32", icns_rgb(big, it32=True)), (b"t8mk", mask.tobytes())])
    yield "it32_only", icns_file([(b"it32", icns_rgb(big, it32=True))])
    mid = big[::2, ::2][:48, :48]
    yield "ih32_mask", icns_file([(b"ih32", icns_rgb(mid)), (b"h8mk", mask[:48, :48].tobytes())])
    yield "il32_raw", icns_file([(b"il32", big[:32, :32].tobytes()),
                                 (b"l8mk", mask[:32, :32].tobytes())])
    yield "is32_beside_png", icns_file([
        (b"is32", icns_rgb(big[:16, :16])), (b"s8mk", mask[:16, :16].tobytes()),
        (b"ic11", pil_bytes(Image.fromarray(big[:32, :32]), "PNG"))])
    yield "png_and_rle_same_size", icns_file([
        (b"ic07", pil_bytes(Image.fromarray(big).convert("RGBA"), "PNG")),
        (b"it32", icns_rgb(big, it32=True))])
    yield "refused_overshoot", icns_file([(b"is32", b"\xff\x10" * 2 + icns_rgb(big[:16, :16]))])


@pytest.mark.parametrize("name", [c[0] for c in _icns_cases()])
def test_icns_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_icns_cases())[name], f"{name}.icns", icns.decode_icns)


def _blp_cases():
    rng = np.random.default_rng(175)
    palette = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
    for w, h in ((40, 24), (21, 13)):
        for enc, size, depth in ((0, 8, 0), (0, 8, 1), (1, 16, 4), (7, 16, 8), (7, 16, 0)):
            blocks = rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * size).astype(
                np.uint8).tobytes()
            yield f"dxt{enc}_alpha{depth}_{w}x{h}", blp2_file(w, h, 2, blocks, depth, enc)
    idx = rng.integers(0, 256, 40 * 24).astype(np.uint8).tobytes()
    yield "blp2_palette_alpha8", blp2_file(40, 24, 1, idx, 8, 0, palette)
    yield "refused_raw_bgra", blp2_file(40, 24, 3, RGBA.tobytes(), 8, 0)
    yield "refused_alpha_encoding_2", blp2_file(40, 24, 2, bytes(8 * 60), 0, 2)
    yield "refused_cut_blocks", blp2_file(40, 24, 2, bytes(8 * 50), 0, 0)
    jpg = pil_bytes(Image.fromarray(RGB), "JPEG", quality=85)
    yield "blp1_jpeg", blp1_jpeg_file(jpg, 40, 24, 200)
    yield "blp1_jpeg_alpha_gap", blp1_jpeg_file(jpg, 40, 24, 300, alpha_bits=8, gap=17)
    yield "blp1_jpeg_gray", blp1_jpeg_file(pil_bytes(Image.fromarray(RGB[..., 0]), "JPEG"),
                                           40, 24, 150)
    yield "blp1_jpeg_cmyk", blp1_jpeg_file(pil_bytes(Image.fromarray(RGB).convert("CMYK"),
                                                     "JPEG"), 40, 24, 250)


@pytest.mark.parametrize("name", [c[0] for c in _blp_cases()])
def test_blp_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_blp_cases())[name], f"{name}.blp", blp.decode_blp)


def _im_cases():
    rng = np.random.default_rng(176)
    w, h = 13, 7
    for kind, (mode, rawmode) in sorted(im.OPEN.items()):
        bits = 32 if rawmode in ("RGB;T", "RYB;T") else 0
        if rawmode.startswith("F;") and rawmode[2:].isdigit():
            bits = int(rawmode[2:])
        per = {"1": 1, "P;2": 2, "P;4": 4}.get(rawmode)
        size = 3 * w * h if rawmode in ("RGB;T", "RYB;T") else \
            ((w * per + 7) // 8 if per else w * 4) * h
        body = rng.integers(0, 256, size).astype(np.uint8).tobytes()
        yield kind, im_file([f"Image type: {kind}", f"Image size (x*y): {w}*{h}"], body)
    lut = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    gray_lut = bytes(np.repeat(rng.integers(0, 256, 256).astype(np.uint8)[None], 3, 0))
    body = rng.integers(0, 256, 2 * w * h).astype(np.uint8).tobytes()
    for name, kind, table in (("lut_l", "Greyscale image", lut), ("lut_la", "LA image", lut),
                              ("lut_b4", "B4 image", lut), ("gray_lut_l", "Greyscale image",
                                                            gray_lut),
                              ("gray_lut_b4", "B4 image", gray_lut)):
        yield name, im_file([f"Image type: {kind}", f"Image size (x*y): {w}*{h}", "Lut: 1"],
                            body, table)
    yield "comments_and_name", im_file(["Comment: one", "Name: x.im", "Comment: two",
                                        "Image type: RGB image", f"Image size (x*y): {w}*{h}",
                                        "File size (no of images): 1"], body * 2)
    yield "no_size", im_file(["Image type: Greyscale image"], bytes(512 * 512))
    yield "refused_cut", im_file(["Image type: RGB image", f"Image size (x*y): {w}*{h}"],
                                 body[:50])
    yield "refused_float_size", im_file(["Image type: Greyscale image",
                                         "Image size (x*y): 13.5*7"], body)
    yield "refused_three_sizes", im_file(["Image type: Greyscale image",
                                          "Image size (x*y): 13*7*2"], body)
    yield "refused_size_not_a_number", im_file(["Image type: Greyscale image",
                                                "Image size (x*y): 13*x"], body)


@pytest.mark.parametrize("name", [c[0] for c in _im_cases()])
def test_im_types_equal_pillow(tmp_path, name):
    """Every image type of PIL's ``OPEN`` table, and Luts: equal to Pillow's,
    or refused where Pillow refuses (a raw mode it cannot unpack)."""
    check(tmp_path, dict(_im_cases())[name], name.replace(" ", "_").replace("*", "x") + ".im")


def _xbm_cases():
    bits = RGB[..., 0] > 120
    text = pil_bytes(Image.fromarray(bits), "XBM").decode()
    yield "hotspot", text.replace("#define im_height 24\n",
                                  "#define im_height 24\n#define im_x_hot 3\n#define im_y_hot 4\n"
                                  ).encode()
    yield "odd_hex", (b"#define t_width 17\n#define t_height 2\nstatic char t_bits[] = {\n"
                      b"0x1,0x80,0xg1, 0X22,x5f,0xAB,0x33};\n")
    yield "refused_short", (b"#define t_width 17\n#define t_height 2\n"
                            b"static char t_bits[] = {\n0x01,0x02};\n")


@pytest.mark.parametrize("name", [c[0] for c in _xbm_cases()])
def test_xbm_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_xbm_cases())[name], f"{name}.xbm")


def _qoi_cases():
    rng = np.random.default_rng(177)
    yield "noise_rgba", pil_bytes(Image.fromarray(rng.integers(0, 256, (9, 11, 4)).astype(
        np.uint8)), "QOI")
    flat = np.repeat(RGBA[:, ::6], 6, axis=1)
    yield "runs", pil_bytes(Image.fromarray(flat), "QOI")
    ops = bytes([0x00, 0x41, 0x80, 0x2A, 0xC3, 0xFE, 1, 2, 3, 0x05, 0xFF, 9, 8, 7, 6, 0x3F]) * 8
    yield "every_op_and_unset_index", b"qoif" + struct.pack(">II", 8, 7) + b"\x03\x00" + ops + \
        bytes(7) + b"\x01"
    yield "refused_cut", pil_bytes(Image.fromarray(RGBA), "QOI")[:-100]


@pytest.mark.parametrize("name", [c[0] for c in _qoi_cases()])
def test_qoi_variants_equal_pillow(tmp_path, name):
    check(tmp_path, dict(_qoi_cases())[name], f"{name}.qoi", qoi.decode_qoi)


# --- modes -------------------------------------------------------------------

def test_new_modes_convert_as_pil():
    """"F" truncated and clipped (NaN to 0), "I" and the 16-bit modes clipped,
    "PA" through its palette, "RGBX" dropping its pad, every YCbCr triple."""
    f = np.array([[-3.7, 0.5, 1.5, 2.5, 254.5, 300.2, np.nan, np.inf, -np.inf, 254.99]],
                 np.float32)
    images = pillow_images()
    images["F_edges"] = Image.fromarray(f, "F")
    for key, image in images.items():
        own = np.asarray(image)
        decoded = Decoded(own, image.mode, None if image.mode not in ("P", "PA") else
                          np.asarray(image.getpalette()[:768], np.uint8).reshape(-1, 3))
        for m in ("RGB", "L"):
            np.testing.assert_array_equal(to_mode(decoded, m), np.asarray(image.convert(m)),
                                          err_msg=f"{key} -> {m}")
    y, cb, cr = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    ycc = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(4096, 4096, 3)
    image = Image.fromarray(ycc, "YCbCr")
    for m in ("RGB", "L"):
        np.testing.assert_array_equal(to_mode(Decoded(ycc, "YCbCr"), m),
                                      np.asarray(image.convert(m)))


# --- refusals and dispatch ---------------------------------------------------

@functools.lru_cache(maxsize=1)
def refused_files() -> dict:
    return refused_format_files()


@pytest.mark.parametrize("word", sorted(REFUSED_FORMATS))
def test_formats_pillow_opens_are_refused_naming_the_format(tmp_path, word):
    """Pillow reads these files; the port says which file and which format
    it does not read, and never "not an image file"."""
    ext, data = refused_files()[word]
    path = tmp_path / f"refused.{ext}"
    path.write_bytes(data)
    with Image.open(path) as image:
        assert image.size[0] > 0
    with pytest.raises(FormatNotRead, match=rf"refused\.{ext}.*{re.escape(word)}") as err:
        read_image(str(path), "RGB")
    assert word in err.value.format


@pytest.mark.parametrize("word", PILLOW_REFUSES)
def test_formats_pillow_cannot_load_are_refused_naming_the_file(tmp_path, word):
    """Pillow opens these files on this host and then refuses to load them
    (no loader, no Ghostscript, an MPEG header only); the port raises a
    plain ``ValueError`` naming the file, not ``FormatNotRead``."""
    ext, data = refused_files()[word]
    path = tmp_path / f"stub.{ext}"
    path.write_bytes(data)
    with Image.open(path) as image:
        assert image.size[0] > 0
        with pytest.raises(OSError):
            image.load()
    with pytest.raises(ValueError, match=rf"stub\.{ext}") as err:
        read_image(str(path), "RGB")
    assert not isinstance(err.value, FormatNotRead)


@pytest.mark.parametrize("word", ONCE_REFUSED)
def test_formats_once_refused_equal_pillow(tmp_path, word):
    """The files of the formats the port refused before it read them: every
    mode equal to Pillow's."""
    ext, data = refused_files()[word]
    check(tmp_path, data, f"once_refused.{ext}")
    with Image.open(tmp_path / f"once_refused.{ext}") as image:
        image.load()                        # Pillow reads it: not a refusal in disguise


def test_mesh_warning_names_the_refused_format(tmp_path, capsys):
    """An OBJ whose texture is an AVIF ``avis`` sequence (PIL reads it, the
    port does not) keeps its Kd colour, and the warning names the
    format."""
    from coma_tpu_torch.geometry.mesh import load_obj_textured

    (tmp_path / "t.avif").write_bytes(refused_files()["AVIF"][1])
    (tmp_path / "m.mtl").write_text("newmtl m\nKd 0.1 0.9 0.2\nmap_Kd t.avif\n")
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    "usemtl m\nf 1/1 2/1 3/1\n")
    mesh = load_obj_textured(str(tmp_path / "a.obj"), tex_size=4)
    np.testing.assert_allclose(mesh.textures[1], np.broadcast_to([0.1, 0.9, 0.2], (4, 4, 3)))
    assert "t.avif (AVIF) not decoded" in capsys.readouterr().out


def test_unidentified_bytes_refused_as_pillow_refuses(tmp_path):
    for k, data in enumerate((b"", b"hello world, not an image", bytes(range(256)) * 3)):
        path = tmp_path / f"junk{k}.bin"
        path.write_bytes(data)
        with pytest.raises(REFUSALS):
            with Image.open(path) as image:
                image.load()
        with pytest.raises(ValueError, match=rf"junk{k}\.bin"):
            read_image(str(path))


def test_plugins_in_pillows_order():
    """The port's table is the ``Image.ID`` a fresh process's
    ``Image.open`` walks on this host, AVIF's and the stubs' places
    included."""
    import subprocess

    order = subprocess.run([sys.executable, "-c", "from PIL import Image; Image.preinit(); "
                            "Image.init(); print(' '.join(Image.ID))"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.split()
    assert [p[0] for p in PLUGINS] == [i for i in order if i != "MPO"]


def test_weak_accept_order(tmp_path):
    """A valid TGA is still a TGA; files Pillow opens as IM or SPIDER (which
    TGA's header test would also pass) are never read as TGA."""
    tga = pil_bytes(Image.fromarray(RGB), "TGA")
    check(tmp_path, tga, "plain.tga")
    assert decode_image(tga).mode == "RGB"
    body = bytes(np.random.default_rng(178).integers(0, 256, 13 * 7).astype(np.uint8))
    # an IM header whose first bytes also pass TGA's header test
    im_data = im_file(["Image type: Greyscale image", "Image size (x*y): 13*7"], body)
    spider_data = spider_file(RGB[..., 0].astype(np.float32), big_endian=False)
    for name, data, fmt in (("weak.im", im_data, "IM"), ("weak.spi", spider_data, "SPIDER")):
        with Image.open(io.BytesIO(data)) as image:
            assert image.format == fmt
        check(tmp_path, data, name)


NATIVE_READERS = {".sgi": sgi.decode_sgi, ".pcx": pcx.decode_pcx, ".dcx": pcx.decode_dcx,
                  ".qoi": qoi.decode_qoi, ".icns": icns.decode_icns, ".blp": blp.decode_blp,
                  ".ras": sun.decode_sun, ".msp": msp.decode_msp, ".jp2": jp2.decode_jp2,
                  ".j2k": jp2.decode_jp2}
with open(os.path.join(FIXTURES, "manifest.json")) as _fh:
    # the 2048 x 1536 JPEG 2000 atlases are held in tests/test_torch_jpeg2000.py
    NATIVE_FIXTURES = [e for e in json.load(_fh)["files"] if "stored" not in e
                       and os.path.splitext(e["file"])[1] in NATIVE_READERS
                       and not e["file"].startswith("atlas")]


@pytest.mark.parametrize("entry", NATIVE_FIXTURES, ids=[e["file"] for e in NATIVE_FIXTURES])
def test_committed_fixtures_plain_and_native_equal(entry):
    """Every committed fixture of a reader with a native twin: the plain and
    native paths give Pillow's array (its manifest hash), or both refuse."""
    if not NATIVE:
        pytest.skip("no g++ on this host: the native decoders cannot be built")
    with open(os.path.join(FIXTURES, entry["file"]), "rb") as fh:
        data = fh.read()
    reader = NATIVE_READERS[os.path.splitext(entry["file"])[1]]
    for native in (False, True):
        if entry.get("raises"):
            with pytest.raises(ValueError, match=re.escape(entry["file"])):
                reader(data, entry["file"], native=native)
        else:
            assert array_sha(reader(data, entry["file"], native=native).pixels) == \
                entry["sha256"]["None"]


# --- the texture atlas -------------------------------------------------------

@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("name", ["atlas_2048x1536.qoi", "atlas_rle_2048x1536.sgi"])
def test_atlas_equals_pillow_hash(name, native):
    if native and not NATIVE:
        pytest.skip("no g++ on this host: the native decoders cannot be built")
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entry = {e["file"]: e for e in json.load(fh)["files"]}[name]
    with open(os.path.join(FIXTURES, entry["stored"]), "rb") as fh:
        data = gzip.decompress(fh.read())
    reader = qoi.decode_qoi if name.endswith(".qoi") else sgi.decode_sgi
    assert array_sha(reader(data, name, native=native).pixels) == entry["sha256"]["None"]
