"""The port's readers of the image formats ``coma_tpu`` opens with PIL, other
than PNG and JPEG's baseline: BMP, TGA, PNM, TIFF and GIF (``utils/{bmp,
tga,pnm,tiff,gif_reader}.py``), the JPEG processes beyond Huffman coding
(arithmetic, lossless, block smoothing, CMYK/YCCK, every sampling), and
``read_image``'s mode None. Held against Pillow 12.1.0 bit for bit, with no
tolerance:

- seeded images written by Pillow at test time in every mode and
  compression each format takes, and by ``tools/jpeg_fixture_writer.c``
  (libjpeg-turbo's compressor, built with gcc) in every JPEG process;
- TIFF's JPEG compression (Pillow's RGB, YCbCr, gray, CMYK and RGBA files,
  and YCbCr 4:2:0 and 4:2:2 strips written by libjpeg with the tables in
  JPEGTables), separate planes, fill order 2 and BigTIFF;
- the native codecs (``native/src/image_codecs.cpp``: LZW, PackBits, TGA
  run-length) against their plain Python versions;
- JPEG 2000, WebP, DDS and TIFF-JPEG files, once left out, equal to Pillow;
  a format still left out (an AVIF ``avis`` sequence) raises a
  ``ValueError`` naming the file and the format;
- ``load_obj_textured`` on an OBJ whose materials take TGA, BMP, TIFF-LZW,
  CMYK and arithmetic JPEG, WebP (lossy with alpha, lossless), DDS (BC1,
  BC3, BC7), PSD and TIFF-JPEG textures, and ``BehaveSequence`` on a YCCK
  colour frame, against ``coma_tpu``'s.

The committed fixtures of ``tests/data/images/`` are held in
``tests/test_torch_image_io.py``; WebP, DDS and PSD in detail in
``tests/test_torch_webp.py`` and ``tests/test_torch_dds_psd.py``.
"""
import hashlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
from coma_tpu.pipelines import behave_eval as J
from coma_tpu_torch.geometry import mesh as t_mesh
from coma_tpu_torch.native import codecs
from coma_tpu_torch.pipelines import behave_eval as T
from coma_tpu_torch.utils import gif_reader, jpeg, tga, tiff
from coma_tpu_torch.utils.image_io import decode_image, read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (LibjpegWriter, array_sha, bc7_mode6,  # noqa: E402
                                 blp2_file, bmp_file, bmp_rle4, bmp_rle8, bmp_rows, dds_file,
                                 jpeg_tiff, psd_file, seeded_rgb, sgi_file, sun_file, tga_file,
                                 tga_rle, tiff_file)

MODES = (None, "RGB", "L")


def need_gpp():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native codecs cannot be built")


def pillow_arrays(path) -> dict:
    with Image.open(path) as im:
        im.load()
        return {m: np.asarray(im if m is None else im.convert(m)) for m in MODES}


def assert_equal_to_pillow(path) -> None:
    """Every mode equal to Pillow's, or, where Pillow refuses the file, a
    ``ValueError`` naming it."""
    try:
        want = pillow_arrays(path)
    except (OSError, SyntaxError, ValueError):
        with pytest.raises(ValueError, match=os.path.basename(str(path)).replace(".", r"\.")):
            read_image(str(path))
        return
    for m in MODES:
        got = read_image(str(path), m)
        assert got.shape == want[m].shape and got.dtype == want[m].dtype, (m, got.shape,
                                                                            want[m].shape)
        np.testing.assert_array_equal(got, want[m])


def seeded_images():
    rng = np.random.default_rng(70)
    rgb = seeded_rgb((27, 41), 71)
    alpha = rng.integers(0, 256, (27, 41, 1)).astype(np.uint8)
    im = Image.fromarray(rgb)
    return {"RGB": im, "RGBA": Image.fromarray(np.concatenate([rgb, alpha], -1)),
            "L": Image.fromarray(rgb[..., 0]), "1": Image.fromarray(rgb[..., 1] > 120),
            "P": im.convert("P", palette=Image.Palette.ADAPTIVE, colors=30),
            "LA": Image.fromarray(np.concatenate([rgb[..., :1], alpha], -1), "LA"),
            "CMYK": im.convert("CMYK"), "I;16": Image.fromarray(rgb[..., 2].astype(np.uint16)
                                                               * 251)}


PILLOW_WRITES = [
    ("BMP", {}, ("RGB", "RGBA", "L", "1", "P")),
    ("TGA", {}, ("RGB", "RGBA", "L", "P", "LA")),
    ("TGA", {"compression": "tga_rle"}, ("RGB", "RGBA", "L", "P", "LA")),
    ("PPM", {}, ("RGB", "L", "1", "I;16")),
    ("TIFF", {}, ("RGB", "RGBA", "L", "1", "P", "LA", "CMYK", "I;16")),
    ("TIFF", {"compression": "tiff_lzw"}, ("RGB", "RGBA", "L", "1", "P", "LA", "CMYK")),
    ("TIFF", {"compression": "tiff_adobe_deflate"}, ("RGB", "L", "P", "CMYK")),
    ("TIFF", {"compression": "packbits"}, ("RGB", "RGBA", "L", "P")),
    ("TIFF", {"compression": "tiff_lzw", "tiffinfo": {317: 2}}, ("RGB", "RGBA", "L", "CMYK")),
    ("GIF", {}, ("RGB", "L", "P", "1")),
    ("GIF", {"interlace": False}, ("RGB", "P")),
]
CASES = [(fmt, kw, mode) for fmt, kw, modes in PILLOW_WRITES for mode in modes]


@pytest.mark.parametrize("fmt,kw,mode", CASES,
                         ids=[f"{f}-{'-'.join(map(str, k.values())) or 'plain'}-{m}"
                              for f, k, m in CASES])
def test_pillow_written_files_equal_pillow(tmp_path, fmt, kw, mode):
    path = tmp_path / f"x.{fmt.lower()}"
    seeded_images()[mode].save(path, fmt, **kw)
    assert_equal_to_pillow(path)


def _bmp_cases():
    rng = np.random.default_rng(72)
    idx16 = rng.integers(0, 16, (19, 23)).astype(np.uint8)
    idx16[:, 4:15] = 9
    idx256 = rng.integers(0, 256, (17, 29)).astype(np.uint8)
    idx256[3:9, 2:20] = 77
    pal = rng.integers(0, 256, (256, 3))
    rgb = seeded_rgb((13, 21), 73)
    return {
        "rle8": bmp_file(bmp_rle8(idx256), 29, 17, 8, compression=1, palette=pal),
        "rle4": bmp_file(bmp_rle4(idx16), 23, 19, 4, compression=2, palette=pal[:16]),
        "rle8_delta": bmp_file(bytes([3, 5, 0, 2, 9, 9, 1, 1, 2, 7, 0, 0, 8, 1, 0, 0, 8, 3,
                                      0, 1]), 8, 4, 8, compression=1, palette=pal),
        "gray_ramp_4bit": bmp_file(bmp_rows(idx16, 4), 23, 19, 4,
                                   palette=np.repeat(np.arange(16)[:, None], 3, 1)),
        "os2_8bit": bmp_file(bmp_rows(idx256, 8), 29, 17, 8, palette=pal, header=12),
        "top_down_24": bmp_file(bmp_rows(rgb[..., ::-1], 24), 21, 13, 24, top_down=True),
        "bitfields_555": bmp_file(bmp_rows(rgb[..., 0].astype(np.uint16) * 97, 16), 21, 13, 16,
                                  compression=3, masks=(0x7C00, 0x3E0, 0x1F), header=56),
        "bitfields32_40_byte": bmp_file(bmp_rows(np.dstack([rgb, rgb[..., :1]]), 32), 21, 13,
                                        32, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    }


@pytest.mark.parametrize("name", list(_bmp_cases()))
def test_bmp_variants_equal_pillow(tmp_path, name):
    """RLE escapes (PIL's delta reads two bytes more than it uses), OS/2
    headers, top-down rows, bitfields, and a 4-bit gray ramp, which PIL
    (mapping the file) reads as 8-bit "L" rows wider than the file's."""
    path = tmp_path / f"{name}.bmp"
    path.write_bytes(_bmp_cases()[name])
    assert_equal_to_pillow(path)


def _tga_cases():
    rng = np.random.default_rng(74)
    rgb = seeded_rgb((11, 17), 75)
    idx = rng.integers(0, 8, (11, 17)).astype(np.uint8)
    idx[:, 3:12] = 5
    cmap = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    return {
        f"origin_{o:#x}": tga_file(2, 17, 11, 24, rgb[::1 if o & 0x20 else -1,
                                                     ::-1 if o & 0x10 else 1, ::-1].tobytes(),
                                   origin=o) for o in (0, 0x10, 0x20, 0x30)} | {
        "type9_literals_across": tga_file(9, 17, 11, 8, tga_rle(idx, 1, across_rows=True),
                                          cmap=cmap[:, ::-1].tobytes(), cmap_len=8,
                                          cmap_depth=24),
        "type11_runs": tga_file(11, 17, 11, 8, tga_rle(idx * 30, 1)),
        "type1_no_map": tga_file(1, 17, 11, 8, idx.tobytes()),
    }


@pytest.mark.parametrize("name", list(_tga_cases()))
def test_tga_variants_equal_pillow(tmp_path, name):
    """The four origins, literal packets across rows, a colour-mapped type
    without a map (both refuse it)."""
    path = tmp_path / f"{name}.tga"
    path.write_bytes(_tga_cases()[name])
    assert_equal_to_pillow(path)


PNM = {
    "pf_little_endian_nan_inf": b"Pf 3 2 -0.5\n" + np.array(
        [np.nan, np.inf, -np.inf, 254.9, 255.0, -1e-3], "<f4").tobytes(),
    "pf_big_endian_rows_up": b"Pf\n2 3\n1e3\n" + np.arange(6, dtype=">f4").tobytes() * 40,
    "pf_zero_scale_refused": b"Pf\n1 1\n0\n" + bytes(4),
    "pf_truncated_refused": b"Pf\n4 4\n-1\n" + bytes(20),
    "pyp_no_palette": b"PyP\n3 1\n255\n\x00\x07\xff",
    "pyp_maxval_1000": b"PyP\n4 1\n1000\n" + np.array([0, 1000, 5, 500], ">u2").tobytes(),
    "pyrgba_maxval_7": b"PyRGBA\n2 1\n7\n" + bytes([0, 1, 2, 3, 4, 5, 6, 7]),
    "pycmyk": b"PyCMYK 1 2 255 " + bytes([0, 64, 128, 255, 9, 8, 7, 6]),
    "p0cmyk_maxval_65535": b"P0CMYK\n1 1\n65535\n" + np.array([0, 257, 65535, 30000],
                                                                 ">u2").tobytes(),
    "p0rgb_not_a_magic": b"P0RGB\n1 1\n255\n\x00\x00\x00",
    "p1_runs_together": b"P1\n4 2\n0110\n1001\n",
    "p2_comment_in_data": b"P2\n3 2\n7\n0 1 2 # a comment\n3 5 7\n",
    "p3_maxval_3": b"P3 2 1 3 0 1 2 3 3 1\n",
    "p5_maxval_1000_big_endian": b"P5\n2 2\n1000\n" + np.array([0, 1, 999, 1000], ">u2").tobytes(),
    "p6_maxval_7": b"P6\n2 1\n7\n" + bytes([0, 3, 4, 7, 1, 2]),
    "p5_header_comment": b"P5\n# made by hand\n2 1\n255\n\x00\xff",
}


@pytest.mark.parametrize("name", list(PNM))
def test_pnm_variants_equal_pillow(tmp_path, name):
    """maxval scaling (Python's rounding), 16-bit samples, comments; Pillow's
    own magics: PFM (either byte order, rows bottom-up, NaN and infinities,
    its "F" converted to "RGB" and "L"), PyP, PyRGBA, PyCMYK and P0CMYK, and
    the ones it refuses."""
    path = tmp_path / f"{name}.pnm"
    path.write_bytes(PNM[name])
    assert_equal_to_pillow(path)


def _tiff_cases():
    rgb = seeded_rgb((21, 35), 76)
    rng = np.random.default_rng(77)
    idx = rng.integers(0, 4, (21, 35)).astype(np.uint8)
    packed2 = (np.pad(idx, ((0, 0), (0, 1))).reshape(21, 9, 4) << np.array([6, 4, 2, 0],
                                                                          np.uint8)).sum(-1)
    cmap = rng.integers(0, 256, (4, 3))
    rgba = np.dstack([rgb, rgb[..., :1]])
    return {
        "tiled_deflate_predictor": tiff_file(rgb, (8, 8, 8), 2, compression=8, predictor=2,
                                             tile=(16, 16)),
        "tiled_none_be": tiff_file(rgb, (8, 8, 8), 2, tile=(16, 32), big_endian=True),
        "strips_packbits_rgbx": tiff_file(np.dstack([rgb, rgb[..., :1]]), (8, 8, 8, 8), 2,
                                          compression=32773, rows_per_strip=4, extra=(0,)),
        "palette_2bit": tiff_file(packed2.astype(np.uint8), (2,), 3, colormap=cmap, width=35),
        "gray_2bit_white_is_zero": tiff_file(packed2.astype(np.uint8), (2,), 0, width=35),
        "gray_predictor_deflate": tiff_file(rgb[..., :1], (8,), 1, compression=8, predictor=2,
                                            rows_per_strip=7),
        "planar_rgb_strips": tiff_file(rgb, (8, 8, 8), 2, planar=True, rows_per_strip=8),
        "planar_rgb_deflate_predictor": tiff_file(rgb, (8, 8, 8), 2, planar=True, compression=8,
                                                  predictor=2, rows_per_strip=5),
        "planar_rgba_tiles": tiff_file(rgba, (8, 8, 8, 8), 2, planar=True, extra=(2,),
                                       tile=(16, 16)),
        "planar_cmyk_packbits": tiff_file(rgba, (8, 8, 8, 8), 5, planar=True,
                                          compression=32773),
        "planar_la_refused": tiff_file(rgba[..., :2], (8, 8), 1, planar=True, extra=(2,)),
        "fill2_gray": tiff_file(rgb[..., :1], (8,), 1, fill_order=2),
        "fill2_rgb_deflate": tiff_file(rgb, (8, 8, 8), 2, fill_order=2, compression=8),
        "fill2_rgb_packbits": tiff_file(rgb, (8, 8, 8), 2, fill_order=2, compression=32773,
                                        rows_per_strip=6),
        "fill2_1bit": tiff_file(np.packbits(rgb[..., 0] > 100, axis=1), (1,), 1, fill_order=2,
                                width=35),
        "bigtiff_strips": tiff_file(rgb, (8, 8, 8), 2, bigtiff=True, rows_per_strip=7),
        "bigtiff_tiles_deflate": tiff_file(rgb, (8, 8, 8), 2, bigtiff=True, tile=(16, 16),
                                           compression=8),
        "bigtiff_palette": tiff_file(rgb[..., :1], (8,), 3, bigtiff=True,
                                     colormap=rng.integers(0, 256, (256, 3))),
        "bigtiff_big_endian_refused": tiff_file(rgb, (8, 8, 8), 2, bigtiff=True,
                                                big_endian=True),
    } | {f"jpeg_{mode.lower()}_{k}": _pillow_tiff(rgb, mode, compression="jpeg", **kw)
         for mode in ("RGB", "YCbCr", "L", "CMYK", "RGBA")
         for k, kw in (("one_strip", {}), ("strips_of_8", {"tiffinfo": {278: 8}}),
                       ("q40", {"quality": 40}))}


def _pillow_tiff(rgb: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    image = Image.fromarray(np.dstack([rgb, rgb[..., :1]]) if mode == "RGBA" else rgb)
    image.convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", list(_tiff_cases()))
def test_tiff_variants_equal_pillow(tmp_path, name):
    """Tiles, big-endian files, predictor 2, an unused extra sample, 2-bit
    palette and gray; separate planes (PIL unpacks each with one letter of
    the raw mode, so "LA" is refused), fill order 2, BigTIFF (PIL reads the
    little-endian header only), and JPEG compression as Pillow writes it."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(_tiff_cases()[name])
    assert_equal_to_pillow(path)


def test_gif_first_frame_and_every_frame_equal_pillow(tmp_path):
    """A first frame with a transparent index, later frames as PIL composes
    them (delta frames with transparency from PIL's writer, disposal 2)."""
    frames = [Image.fromarray(seeded_rgb((24, 30), s)) for s in range(3)]
    frames.append(frames[-1])
    for name, kw in (("optimised.gif", {}), ("disposal2.gif", dict(disposal=2)),
                     ("transparent.gif", dict(transparency=0, disposal=[0, 2, 3, 1]))):
        frames[0].save(tmp_path / name, save_all=True, append_images=frames[1:],
                       duration=[80, 90, 100, 110], loop=2, **kw)
        assert_equal_to_pillow(tmp_path / name)
        got, durations, loop = gif_reader.decode_gif_frames((tmp_path / name).read_bytes())
        with Image.open(tmp_path / name) as im:
            want, want_d = [], []
            for k in range(im.n_frames):
                im.seek(k)
                want.append(np.asarray(im.convert("RGB")))
                want_d.append(im.info.get("duration"))
            assert loop == im.info.get("loop")
        np.testing.assert_array_equal(got, np.stack(want))
        assert durations == want_d


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_big_fixtures_equal_pillow_hashes(native):
    """The 2048 x 1536 atlas as TGA (run-length) and TIFF-LZW through the
    plain and the native codecs."""
    if native:
        need_gpp()
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entries = {e["file"]: e for e in json.load(fh)["files"]}
    for name in ("atlas_rle_2048x1536.tga", "atlas_lzw_2048x1536.tif"):
        with open(os.path.join(FIXTURES, name), "rb") as fh:
            data = fh.read()
        reader = tga.decode_tga if name.endswith(".tga") else tiff.decode_tiff
        assert array_sha(reader(data, name, native=native).pixels) == \
            entries[name]["sha256"]["None"]


def test_native_codecs_equal_plain_ones():
    """LZW (GIF and TIFF), PackBits and TGA run-length: the C++ decoders
    against the plain Python ones on Pillow's output and on random bytes
    (corrupt streams fail in both)."""
    need_gpp()
    assert codecs.available()
    rng = np.random.default_rng(79)
    image = Image.fromarray(seeded_rgb((64, 90), 80))
    for kw in ({"compression": "tiff_lzw"}, {"compression": "packbits"}):
        buf = io.BytesIO()
        image.save(buf, "TIFF", **kw)
        data = buf.getvalue()
        for native in (False, True):
            np.testing.assert_array_equal(tiff.decode_tiff(data, native=native).pixels,
                                          np.asarray(image))
    noise = rng.integers(0, 256, 3000).astype(np.uint8).tobytes()
    assert codecs.packbits_decode(noise, 50000) == tiff.packbits_decode_python(noise, 50000)
    from coma_tpu_torch.utils.gif import lzw_encode
    for min_code in (2, 5):
        idx = rng.integers(0, 1 << min_code, 5000).astype(np.uint8)
        stream = lzw_encode(idx, min_code)
        assert codecs.lzw_decode(stream, min_code, False, idx.size) == \
            gif_reader.lzw_decode_python(stream, min_code, idx.size) == idx.tobytes()
    idx = rng.integers(0, 200, (40, 125)).astype(np.uint8)
    stream, min_code, want = _gif_lzw(idx)
    assert codecs.lzw_decode(stream, min_code, False, idx.size) == \
        gif_reader.lzw_decode_python(stream, min_code, idx.size) == want.tobytes()
    for bad in (noise, b"\xff" * 40):
        outcomes = []
        for fn in (lambda d: codecs.lzw_decode(d, 8, True, 10 ** 5),
                   lambda d: tiff.lzw_decode_python(d, 10 ** 5)):
            try:
                outcomes.append(fn(bad))
            except ValueError:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1]
    px = rng.integers(0, 4, (9, 12, 3)).astype(np.uint8)
    stream = tga_rle(px.reshape(9, -1), 3, across_rows=True)
    assert codecs.tga_rle_decode(stream, 0, 36, 9, 3) == tga.rle_decode_python(stream, 0, 36, 9,
                                                                                3) == px.tobytes()


def _gif_lzw(idx: np.ndarray):
    """Pillow's GIF LZW of the image of (H, W) palette indices: (stream,
    code size, the indices Pillow decodes from it)."""
    palette = np.stack([np.arange(256), 255 - np.arange(256), 7 * np.arange(256) % 256], 1)
    im = Image.fromarray(palette[idx].astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, "GIF", interlace=False)
    data = buf.getvalue()
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    while data[pos] == 0x21:                       # extensions before the image
        pos += 2
        while data[pos]:
            pos += 1 + data[pos]
        pos += 1
    flags = data[pos + 9]
    pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    size, pos = data[pos], pos + 1
    chunks = []
    while data[pos]:
        chunks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    with Image.open(io.BytesIO(data)) as back:
        order = np.asarray(back)                   # Pillow's own indices for the stream
    return b"".join(chunks), size, order


LEFT_OUT = [
    ("avif", "AVIF", {"save_all": True, "append_images": [         # an avis sequence
        Image.fromarray(seeded_rgb((16, 16), 82))]}, "AVIF"),
]


@pytest.mark.parametrize("ext,fmt,kw,word", LEFT_OUT, ids=[c[3] for c in LEFT_OUT])
def test_left_out_formats_raise_naming_the_file(tmp_path, ext, fmt, kw, word):
    """Pillow reads these; the port does not (ROADMAP Queue 3), and says
    which file and which format."""
    image = Image.fromarray(seeded_rgb((16, 16), 81))
    if kw.get("compression") in ("group3", "group4", "tiff_ccitt"):
        image = image.convert("1")
    path = tmp_path / f"left_out.{ext}"
    try:
        image.save(path, fmt, **kw)
    except (OSError, KeyError, ValueError) as err:
        pytest.fail(f"this host's Pillow cannot write {fmt} {kw}: {err}")
    with Image.open(path) as im:
        im.load()
    with pytest.raises(ValueError, match=rf"left_out\.{ext}.*{word}"):
        read_image(str(path), "RGB")


ONCE_LEFT_OUT = [
    ("jp2", "JPEG2000", {}, "JPEG 2000"),
    ("webp", "WEBP", {}, "WebP"),
    ("dds", "DDS", {}, "DDS"),
    ("tif", "TIFF", {"compression": "jpeg"}, "JPEG compression"),
    ("tif", "TIFF", {"compression": "group4"}, "CCITT Group 4"),
    ("tif", "TIFF", {"compression": "group3"}, "CCITT Group 3"),
    ("tif", "TIFF", {"compression": "tiff_ccitt"}, "CCITT RLE"),
    ("tif", "TIFF", {"compression": "lzma"}, "LZMA"),
    ("tif", "TIFF", {"compression": "zstd"}, "Zstandard"),
]


@pytest.mark.parametrize("ext,fmt,kw,word", ONCE_LEFT_OUT, ids=[c[3] for c in ONCE_LEFT_OUT])
def test_formats_once_left_out_equal_pillow(tmp_path, ext, fmt, kw, word):
    """The files the port refused before it read JPEG 2000, WebP, DDS,
    TIFF-JPEG and the CCITT, LZMA and Zstandard TIFFs: now every mode equal
    to Pillow's."""
    path = tmp_path / f"once_left_out.{ext}"
    image = Image.fromarray(seeded_rgb((16, 16), 81))
    if kw.get("compression") in ("group3", "group4", "tiff_ccitt"):
        image = image.convert("1")
    image.save(path, fmt, **kw)
    assert_equal_to_pillow(path)


def test_psd_raises_naming_the_file(tmp_path):
    """Image data cut short: Pillow refuses it ("image file is truncated"),
    and so does the port, naming the file."""
    path = tmp_path / "layers.psd"
    path.write_bytes(b"8BPS\x00\x01" + bytes(6) + b"\x00\x03\x00\x00\x00\x10\x00\x00\x00\x10"
                     b"\x00\x08\x00\x03" + bytes(16))
    with pytest.raises(OSError):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match=r"layers\.psd.*PSD"):
        read_image(str(path))


def test_mode_none_gives_pils_array(tmp_path):
    """``read_image(path, None)`` is ``np.asarray(Image.open(path))``: a
    palette PNG's indices, gray as (H, W), 1-bit as bool, 16-bit gray as
    uint16, CMYK as (H, W, 4)."""
    rgb = seeded_rgb((12, 14), 82)
    files = {"p.png": Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE),
             "g.png": Image.fromarray(rgb[..., 0]), "g.jpg": Image.fromarray(rgb[..., 0]),
             "b.png": Image.fromarray(rgb[..., 0] > 100),
             "w.png": Image.fromarray(rgb[..., 0].astype(np.uint16) * 257),
             "c.jpg": Image.fromarray(rgb).convert("CMYK"),
             "la.png": Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 1]]), "LA")}
    want = {"p.png": ((12, 14), np.uint8), "g.png": ((12, 14), np.uint8),
            "g.jpg": ((12, 14), np.uint8), "b.png": ((12, 14), np.bool_),
            "w.png": ((12, 14), np.uint16), "c.jpg": ((12, 14, 4), np.uint8),
            "la.png": ((12, 14, 2), np.uint8)}
    for name, im in files.items():
        im.save(tmp_path / name)
        got = read_image(str(tmp_path / name))
        assert (got.shape, got.dtype) == want[name], name
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / name)))
    assert decode_image((tmp_path / "p.png").read_bytes()).mode == "P"


@pytest.fixture(scope="module")
def libjpeg_writer():
    if shutil.which("gcc") is None or not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("gcc and libjpeg's headers are needed to write these JPEGs")
    writer = LibjpegWriter()
    yield writer
    writer.close()


def test_load_obj_textured_reads_every_texture_format(tmp_path, libjpeg_writer):
    """An OBJ whose materials take TGA, BMP, TIFF-LZW, CMYK JPEG, arithmetic
    JPEG, WebP (lossy with alpha, lossless), DDS (BC1, BC3, BC7), PSD,
    TIFF-JPEG (Pillow's RGB, and YCbCr 4:2:0 strips), SGI RLE, PCX, QOI,
    ICO, BLP2 DXT5 and Sun raster RLE textures: every layer equal to
    ``coma_tpu``'s (PIL's decode and bilinear resize), none left at its Kd
    colour."""
    rng = np.random.default_rng(83)
    yy, xx = np.mgrid[:24, :40]
    tex = np.uint8(np.clip(np.stack([120 + 90 * np.sin(xx / 4 + c) * np.cos(yy / 3)
                                     for c in range(3)], -1) + rng.normal(0, 10, (24, 40, 3)),
                           0, 255))
    tex_a = np.concatenate([tex, rng.integers(60, 256, (24, 40, 1)).astype(np.uint8)], -1)
    Image.fromarray(tex).save(tmp_path / "t.tga", compression="tga_rle")
    Image.fromarray(tex[::-1]).save(tmp_path / "b.bmp")
    Image.fromarray(tex[:, ::-1]).save(tmp_path / "l.tif", compression="tiff_lzw")
    Image.fromarray(tex).convert("CMYK").save(tmp_path / "c.jpg", quality=85)
    (tmp_path / "a.jpg").write_bytes(libjpeg_writer(tex[::-1, ::-1], arith=1, quality=90))
    Image.fromarray(tex_a).save(tmp_path / "w.webp", quality=80)
    Image.fromarray(tex[::-1]).save(tmp_path / "wl.webp", lossless=True)
    Image.fromarray(tex_a).save(tmp_path / "d1.dds", pixel_format="DXT1")
    Image.fromarray(tex_a[:, ::-1]).save(tmp_path / "d3.dds", pixel_format="DXT5")
    (tmp_path / "d7.dds").write_bytes(dds_file(40, 24, bc7_mode6(tex_a[::-1]), fourcc=b"DX10",
                                               dxgi=98))
    (tmp_path / "p.psd").write_bytes(psd_file(np.ascontiguousarray(tex.transpose(2, 0, 1)), 3,
                                              rle=True))
    Image.fromarray(tex).save(tmp_path / "j.tif", compression="jpeg")
    (tmp_path / "y.tif").write_bytes(jpeg_tiff(libjpeg_writer, tex[:, ::-1], 16))
    (tmp_path / "s.rgb").write_bytes(sgi_file(tex[::-1].transpose(2, 0, 1), rle=True))
    Image.fromarray(tex[:, ::-1]).save(tmp_path / "x.pcx")
    Image.fromarray(tex_a[::-1]).save(tmp_path / "q.qoi")
    Image.fromarray(tex_a).save(tmp_path / "i.ico", sizes=[(40, 24)])
    (tmp_path / "z.blp").write_bytes(blp2_file(40, 24, 2, rng.integers(0, 256, 60 * 16).astype(
        np.uint8).tobytes(), 8, 7))
    (tmp_path / "r.ras").write_bytes(sun_file(tex[:, :, ::-1].reshape(24, -1), 40, 24, 2))
    names = ["t.tga", "b.bmp", "l.tif", "c.jpg", "a.jpg", "w.webp", "wl.webp", "d1.dds",
             "d3.dds", "d7.dds", "p.psd", "j.tif", "y.tif", "s.rgb", "x.pcx", "q.qoi", "i.ico",
             "z.blp", "r.ras"]
    (tmp_path / "m.mtl").write_text("".join(f"newmtl m{k}\nKd 0.1 0.9 0.2\nmap_Kd {n}\n"
                                            for k, n in enumerate(names)))
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    + "".join(f"usemtl m{k}\nf 1/1 2/1 3/1\n"
                                              for k in range(len(names))))
    got = t_mesh.load_obj_textured(str(tmp_path / "a.obj"), tex_size=16)
    want = j_load_obj_textured(str(tmp_path / "a.obj"), tex_size=16)
    np.testing.assert_array_equal(got.face_material, want.face_material)
    assert len(got.textures) == len(want.textures) == len(names) + 1
    np.testing.assert_array_equal(got.textures, want.textures)
    for layer in got.textures[1:]:
        assert not np.allclose(layer, [0.1, 0.9, 0.2])


JPEG_TIFFS = [("2x2,1x1,1x1", 16, (37, 29)), ("2x2,1x1,1x1", 8, (45, 33)),
              ("2x1,1x1,1x1", 16, (30, 41)), ("1x2,1x1,1x1", 8, (27, 19)),
              ("1x1,1x1,1x1", 30, (30, 41)), ("2x2,1x1,1x1", 64, (21, 50))]


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("sampling,rows,shape", JPEG_TIFFS,
                         ids=[f"{c[0].split(',')[0]}-rows{c[1]}-{c[2][0]}x{c[2][1]}"
                              for c in JPEG_TIFFS])
def test_tiff_jpeg_strips_from_libjpeg_equal_pillow(tmp_path, libjpeg_writer, sampling, rows,
                                                    shape, native):
    """YCbCr TIFFs whose strips are JPEGs libjpeg wrote at 4:2:0, 4:2:2 and
    4:4:0, their tables in JPEGTables: each strip upsampled on its own (the
    chroma does not cross a strip's edge), libjpeg's fancy upsampling, an
    odd last strip."""
    if native and shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native JPEG decoder cannot be built")
    data = jpeg_tiff(libjpeg_writer, seeded_rgb(shape, rows + shape[0], noise=30), rows,
                     sampling=sampling)
    path = tmp_path / "ycbcr.tif"
    path.write_bytes(data)
    assert_equal_to_pillow(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(tiff.decode_tiff(data, "ycbcr.tif", native=native).pixels,
                                      np.asarray(im))


def test_behave_sequence_reads_a_ycck_frame(tmp_path, libjpeg_writer):
    """A BEHAVE frame stored as an Adobe YCCK JPEG: ``get_color_image`` (PIL's
    ``convert("RGB")`` of Pillow's inverted CMYK) equal to ``coma_tpu``'s."""
    seq = tmp_path / "Date01_Sub01_chairwood"
    (seq / "t0001.000").mkdir(parents=True)
    (seq / "info.json").write_text(json.dumps(dict(cat="chairwood", kinects=[0, 1])))
    rgb = seeded_rgb((36, 48), 84)
    cmyk = np.dstack([rgb, rgb[..., 2:] // 3])
    for kid, space in ((0, "ycck"), (1, "cmyk")):
        (seq / "t0001.000" / f"k{kid}.color.jpg").write_bytes(libjpeg_writer(cmyk, space=space))
    t, j = T.BehaveSequence(str(seq)), J.BehaveSequence(str(seq))
    for kid in range(2):
        got, want = t.get_color_image(0, kid), j.get_color_image(0, kid)
        assert got.shape == (36, 48, 3)
        np.testing.assert_array_equal(got, want)


JPEG_CONFIGS = [
    # (space, sampling, arith, progression, restart rows, conditioning, shape)
    ("ycc", "2x2,1x1,1x1", 1, 0, 0, (0, 1, 5), (33, 47)),
    ("ycc", "2x1,1x1,1x1", 1, 1, 2, (1, 3, 2), (40, 21)),
    ("ycc", "1x2,1x1,1x1", 0, 2, 0, (0, 1, 5), (39, 69)),
    ("ycc", "4x1,1x1,1x1", 1, 2, 1, (0, 4, 20), (34, 32)),
    ("ycc", "1x4,1x1,1x1", 0, 2, 0, (0, 1, 5), (39, 30)),
    ("ycc", "2x2,2x1,1x1", 1, 0, 0, (0, 1, 5), (20, 31)),
    ("ycc", "1x1,2x2,1x1", 0, 1, 0, (0, 1, 5), (17, 17)),
    ("ycc", "3x1,1x1,1x1", 0, 0, 0, (0, 1, 5), (9, 50)),
    ("ycc", "2x2,1x1,1x1", 0, 2, 0, (0, 1, 5), (21, 57)),
    ("ycc", "2x2,1x1,1x1", 1, 2, 0, (0, 1, 5), (16, 12)),
    ("gray", "2x2", 0, 2, 0, (0, 1, 5), (17, 23)),
    ("gray", "1x2", 1, 2, 1, (0, 1, 5), (54, 7)),
    ("gray", "1x1", 1, 1, 0, (2, 2, 1), (8, 8)),
    ("rgb", "1x1,1x1,1x1", 1, 1, 0, (0, 1, 5), (25, 25)),
    ("cmyk", "2x2,1x1,1x1,1x1", 1, 0, 0, (0, 1, 5), (30, 35)),
    ("ycck", "1x2,1x1,1x1,2x1", 0, 2, 1, (0, 1, 5), (26, 44)),
    ("ycck", "2x2,1x1,1x1,2x2", 1, 1, 0, (0, 1, 5), (22, 18)),
]


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("config", JPEG_CONFIGS,
                         ids=[f"{c[0]}-{c[1]}-a{c[2]}-p{c[3]}-r{c[4]}" for c in JPEG_CONFIGS])
def test_libjpeg_written_jpegs_equal_pillow(libjpeg_writer, config, native):
    """Arithmetic coding with its DAC conditioning and restart intervals,
    every sampling libjpeg takes (the h1v2 triangle filter, int_upsample's
    replication), RGB, CMYK and YCCK, and block smoothing of progressive
    scans cut at Al 1 at sizes whose block rows and columns end where
    ``decompress_smooth_data``'s window does odd things."""
    if native:
        need_gpp()
    space, sampling, arith, progression, restart, conditioning, shape = config
    image = seeded_rgb(shape, sum(shape), noise=35)
    if space == "gray":
        image = image[..., 0]
    if space in ("cmyk", "ycck"):
        image = np.dstack([image, image[..., :1] // 2])
    data = libjpeg_writer(image, space=space, arith=arith, progression=progression,
                          sampling=sampling, restart_rows=restart, conditioning=conditioning)
    got = jpeg.decode_jpeg(data, "x", native=native)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
    np.testing.assert_array_equal(got[..., 0] if got.shape[-1] == 1 else got, want)
    if progression == 2:
        assert jpeg.smoothing_wanted(jpeg.decode_coefficients(data, "x", native=native))


def test_sha_of_a_bool_array_reads_its_values():
    """PIL's "1" arrays hold 0/255 bytes behind numpy's bool; the manifest
    hashes their values, as the port's arrays give them."""
    a = np.asarray(Image.fromarray(np.eye(5, dtype=bool)))
    assert array_sha(a) == array_sha(np.eye(5, dtype=bool))
    assert hashlib.sha256(a.tobytes()).hexdigest() != array_sha(a) or a.view(np.uint8).max() == 1
