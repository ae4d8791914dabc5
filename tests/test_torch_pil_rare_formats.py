"""The port's readers of the rarer formats ``coma_tpu`` reads through PIL,
against Pillow 12.1.0, bit for bit, with no tolerance: FITS
(``utils/fits.py``), FLI/FLC (``utils/fli.py``), Kodak PhotoCD
(``utils/pcd.py``), XPM (``utils/xpm.py``), FTEX (``utils/ftex.py``), GIMP
brushes (``utils/gbr.py``), PIXAR (``utils/pixar.py``), IM Tools
(``utils/imt.py``), McIdas areas (``utils/mcidas.py``), XV thumbnails
(``utils/xvthumb.py``), IPTC/NAA (``utils/iptc.py``) and tiled TIFFs at 1,
2 and 4 bits a pixel (``utils/tiff.py``):

- seeded files of the fixture tool's writers and their variants, for modes
  None, RGB and L through ``read_image``, and the plain and native
  (``native/src/image_codecs.cpp``, ``bcn_decode.cpp``) decoders equal;
  files Pillow refuses, refused naming the file;
- PhotoCD's PhotoYCC conversion for all 2^24 triples, against Pillow's
  ``YCC;P`` unpacker;
- FITS read little-endian, as Pillow reads it;
- the native FLI frame decoder and the sub-byte tile gathering against
  their plain references on seeded bytes.
"""
import io
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.utils import fli, ftex, pcd, tiff
from coma_tpu_torch.utils.image_io import decode_image, read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (bc_blocks, fits_file, fits_gzip_file, fli_brun,  # noqa: E402
                                 fli_color, fli_file, fli_lc, fli_ss2, ftex_file, gbr_file,
                                 imt_file, iptc_file, mcidas_file, pcd_file, pixar_file,
                                 seeded_rgb, subbyte_tiled_tiff, xpm_file, xv_file)

MODES = (None, "RGB", "L")
REFUSALS = (OSError, SyntaxError, ValueError, NotImplementedError, IndexError, KeyError,
            TypeError, EOFError, struct.error, AssertionError)
NATIVE = shutil.which("g++") is not None


def check(tmp_path, data: bytes, name: str, reader=None) -> None:
    """Every mode equal to Pillow's through ``read_image`` (a refusal naming
    the file where Pillow refuses), and ``reader``'s plain and native paths
    equal to Pillow's own array (or both refusing)."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        with Image.open(path) as image:
            image.load()
            want = {m: np.asarray(image if m is None else image.convert(m)) for m in MODES}
            mode = image.mode
    except REFUSALS:
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(path))
        for native in (False, True) if (reader and NATIVE) else (False,) if reader else ():
            with pytest.raises(ValueError, match=name.replace(".", r"\.")):
                reader(data, name, native=native)
        return
    for m in MODES:
        got = read_image(str(path), m)
        assert got.shape == want[m].shape and got.dtype == want[m].dtype, \
            (m, got.shape, got.dtype, want[m].shape, want[m].dtype)
        np.testing.assert_array_equal(got, want[m])
    assert decode_image(data, name).mode == mode
    if reader is not None:
        for native in (False, True) if NATIVE else (False,):
            np.testing.assert_array_equal(reader(data, name, native=native).pixels, want[None])


GRAY = seeded_rgb((13, 21), 300)[..., 1]
RNG = np.random.default_rng(301)
PALETTE = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
IDX = (seeded_rgb((11, 19), 302)[..., 0] // 16).astype(np.uint8)
IDX_EVEN = (seeded_rgb((11, 20), 303)[..., 2] // 16).astype(np.uint8)


# --- FITS ------------------------------------------------------------------

def _fits_cases():
    values = {8: GRAY, 16: GRAY.astype(np.int64) * 211 - 9000,
              32: GRAY.astype(np.int64) * 70001 - 10 ** 6, -32: GRAY * np.float32(1.37) - 40,
              -64: GRAY * 2.5 - 100}
    for bits, v in values.items():
        yield f"bitpix{bits}", fits_file(v, bits)
        yield f"bitpix{bits}_naxis3", fits_file(v, bits, planes=3)
        yield f"bitpix{bits}_extension", fits_file(v, bits, extension=True)
    for bits in (8, 16, 32, -32, 64):
        yield f"gzip_bitpix{bits}", fits_gzip_file(GRAY.astype(np.int64) * 1001 - 7, bits)
    yield "naxis1", fits_file(GRAY[:1], 8).replace(b"NAXIS   =                    2",
                                                   b"NAXIS   =                    1")
    plain = fits_file(GRAY, 16)
    yield "refused_data_cut", plain[:2880 + 200]
    yield "refused_no_data_unit", plain[:2880]
    yield "refused_naxis0_only", fits_file(GRAY, 8).replace(b"NAXIS   =                    2",
                                                            b"NAXIS   =                    0")
    yield "refused_bitpix_not_a_number", plain.replace(b"=                   16",
                                                       b"=                  1x6")
    yield "not_simple", plain.replace(b"=                    T", b"=                    F", 1)
    gz = fits_gzip_file(GRAY, 8)
    yield "refused_gzip_cut", gz[:-3000]


@pytest.mark.parametrize("name", [c[0] for c in _fits_cases()])
def test_fits_equals_pillow(tmp_path, name):
    """Every BITPIX PIL reads, cubes, extensions, one-axis images and the
    GZIP_1 table; files cut short or unreadable refused as Pillow refuses
    them."""
    check(tmp_path, dict(_fits_cases())[name], f"{name}.fits")


def test_fits_is_read_little_endian_as_pillow_reads_it(tmp_path):
    """Pillow's raw mode "I;16" reads FITS's big-endian int16 as
    little-endian, bottom row first: [[1, 2, 3], [4, 5, 300]] reads as
    [[1024, 1280, 11265], [256, 512, 768]]."""
    data = fits_file(np.array([[1, 2, 3], [4, 5, 300]]), 16)
    path = tmp_path / "order.fits"
    path.write_bytes(data)
    want = np.array([[1024, 1280, 11265], [256, 512, 768]], np.uint16)
    np.testing.assert_array_equal(read_image(str(path)), want)
    with Image.open(path) as image:
        np.testing.assert_array_equal(np.asarray(image), want)


# --- FLI / FLC -------------------------------------------------------------

def _fli_cases():
    chunks = {
        "brun_color11": [(11, fli_color(PALETTE[:64], 11)), (15, fli_brun(IDX))],
        "lc_color256": [(4, fli_color(PALETTE, 4, skip=3)), (12, fli_lc(IDX, 2))],
        "ss2_odd_width": [(7, fli_ss2(IDX, 1))],
        "black_after_copy": [(16, IDX.tobytes()), (13, bytes(4))],
        "copy_after_stamp": [(18, b"stamp!"), (16, IDX.tobytes())],
        "refused_black_last_short": [(16, IDX.tobytes()), (13, b"")],
        "refused_unknown_chunk": [(99, bytes(8))],
        "refused_copy_short": [(16, IDX.tobytes()[:-5])],
    }
    for name, parts in chunks.items():
        for flc in (False, True):
            data = fli_file(parts, 19, 11, flc)
            yield f"{name}_{'flc' if flc else 'fli'}", data
            yield f"refused_{name}_{'flc' if flc else 'fli'}_cut", data[:-3]
    yield "ss2_even_skip", fli_file([(7, fli_ss2(IDX_EVEN, 3))], 20, 11)
    yield "three_frames", fli_file([(15, fli_brun(IDX_EVEN))], 20, 11, frames=3, more_frames=2)
    yield "refused_prefix_chunk", fli_file([(15, fli_brun(IDX_EVEN))], 20, 11, prefix=b"ab")
    yield "no_frames", fli_file([(15, fli_brun(IDX_EVEN))], 20, 11, frames=0)
    brun = bytearray(fli_file([(15, fli_brun(IDX_EVEN))], 20, 11))
    brun[128 + 16 + 6 + 1] = 0x7F                   # a run past the row
    yield "refused_brun_overrun", bytes(brun)
    zero = bytearray(fli_file([(15, fli_brun(IDX_EVEN)), (18, bytes(4))], 20, 11))
    at = 128 + 16 + struct.unpack_from("<I", zero, 128 + 16)[0]
    zero[at:at + 4] = bytes(4)                      # a subchunk of size 0
    yield "refused_zero_advance", bytes(zero)
    yield "refused_header_only", fli_file([(15, fli_brun(IDX_EVEN))], 20, 11)[:140]


@pytest.mark.parametrize("name", [c[0] for c in _fli_cases()])
def test_fli_equals_pillow(tmp_path, name):
    """Each chunk kind of ``FliDecode.c`` (BRUN, LC, SS2 with line skips and
    an odd width's last byte, BLACK, COPY, colour and stamp chunks skipped),
    COLOR and COLOR256 palettes; cut, overrunning and unknown chunks, a
    prefix chunk and a zero advance refused as Pillow refuses them."""
    check(tmp_path, dict(_fli_cases())[name], f"{name}.flc", fli.decode_fli)


@pytest.mark.skipif(not NATIVE, reason="no g++ for the native FLI decoder")
def test_fli_native_frame_decoder_equals_plain():
    """``fli_decode`` (C++) against ``frame_decode_python`` on seeded
    damage of every chunk kind: status, error and pixels equal."""
    rng = np.random.default_rng(304)
    frames = [fli_file(parts, 19, 11)[128:] for parts in (
        [(15, fli_brun(IDX))], [(12, fli_lc(IDX, 1))], [(7, fli_ss2(IDX, 2))],
        [(16, IDX.tobytes()), (13, bytes(4))])]
    for trial in range(400):
        buf = bytearray(frames[trial % len(frames)])
        for _ in range(rng.integers(1, 4)):
            buf[rng.integers(0, len(buf))] = rng.integers(0, 256)
        buf = bytes(buf[:len(buf) - rng.integers(0, 8)])
        a, b = np.zeros((11, 19), np.uint8), np.zeros((11, 19), np.uint8)
        assert fli.frame_decode(buf, 19, 11, a, native=False) == \
            fli.frame_decode(buf, 19, 11, b, native=True), trial
        np.testing.assert_array_equal(a, b)


# --- PhotoCD -----------------------------------------------------------------

YCC = RNG.integers(0, 256, (512, 768, 3)).astype(np.uint8)


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd_orientations_equal_pillow(tmp_path, orientation):
    """The base image, rotated 90 (1) or 270 (3) degrees, as Pillow does."""
    check(tmp_path, pcd_file(YCC, orientation), f"o{orientation}.pcd")


def test_pcd_cut_is_refused(tmp_path):
    check(tmp_path, pcd_file(YCC)[:-100], "cut.pcd")


def test_pcd_photoycc_every_triple_equals_pillow():
    """All 2^24 (Y, C1, C2) triples through ``ycc_to_rgb`` and through
    Pillow's ``YCC;P`` unpacker (the raw mode ``PcdDecode.c`` shuffles
    with)."""
    y, c1, c2 = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    ycc = np.stack([y, c1, c2], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("RGB", (4096, 4096), ycc.tobytes(), "raw", "YCC;P"))
    np.testing.assert_array_equal(pcd.ycc_to_rgb(ycc), want)


# --- XPM -------------------------------------------------------------------

def _xpm_cases():
    colours = ["#FF0000", "#00ff00", "#0000FF", "#123456", "None"]
    many = [f"#{v:06X}" for v in RNG.integers(0, 1 << 24, 300)]
    yield "two_char_keys_with_none", xpm_file(IDX % 4, colours, 2)
    yield "one_char_pixels_comment", xpm_file(IDX % 4, colours, 1, pixels_line=True)
    yield "more_than_256_colours", xpm_file(RNG.integers(0, 300, (6, 11)), many, 2)
    yield "short_hex_colour", xpm_file(IDX % 2, ["#FFF", "#0a0b0c0d0e0f"], 1)
    yield "rows_as_one_stream", xpm_file(IDX[:2, :4] % 4, colours, 1,
                                          rows=["ab", "cdab", "cd"])
    yield "refused_named_colour", xpm_file(IDX % 3, ["#000000", "#FFFFFF", "red"], 1)
    yield "refused_transparent_key_used", xpm_file(IDX % 5, colours, 1)
    yield "refused_stream_short", xpm_file(IDX % 4, colours, 1, rows=["abcd", "ab"])
    yield "refused_no_c_key", xpm_file(IDX % 2, ["#000000", "#FFFFFF"], 1).replace(
        b'"b c #FFFFFF"', b'"b m #FFFFFF"')
    yield "not_xpm_no_header", b"/* XPM */\nstatic char *x[] = {\n};\n"


@pytest.mark.parametrize("name", [c[0] for c in _xpm_cases()])
def test_xpm_equals_pillow(tmp_path, name):
    """Keys of one and two characters, a transparent key, over 256 colours
    (RGB), short and long hexadecimal colours, rows read as one stream; a
    named colour, a used transparent key, a short stream refused."""
    check(tmp_path, dict(_xpm_cases())[name], f"{name}.xpm")


# --- FTEX, GBR, PIXAR, IMT, XV ------------------------------------------------

RGB = seeded_rgb((9, 14), 305)


def _small_raw_cases():
    rgba = np.concatenate([RGB, RNG.integers(0, 256, (9, 14, 1)).astype(np.uint8)], -1)
    yield "dxt1.ftc", ftex_file(14, 9, 0, bc_blocks(14, 9, 8, 306))
    yield "raw.ftu", ftex_file(14, 9, 1, RGB.tobytes())
    yield "refused_cut.ftu", ftex_file(14, 9, 1, RGB.tobytes()[:-1])
    yield "refused_format_2.ftu", ftex_file(14, 9, 2, RGB.tobytes())
    yield "refused_two_formats.ftu", ftex_file(14, 9, 1, RGB.tobytes()).replace(
        struct.pack("<ii", 1, 1), struct.pack("<ii", 1, 2), 1)
    yield "v1_gray.gbr", gbr_file(RGB[..., 0], 1)
    yield "v2_rgba.gbr", gbr_file(rgba, 2)
    yield "v1_rgba.gbr", gbr_file(rgba, 1)
    yield "refused_cut.gbr", gbr_file(rgba, 2)[:-3]
    yield "rgb.pxr", pixar_file(RGB)
    yield "refused_cut.pxr", pixar_file(RGB)[:-1]
    yield "gray.imt", imt_file(RGB[..., 1])
    yield "refused_cut.imt", imt_file(RGB[..., 1], comment=False)[:-1]
    yield "refused_no_form_feed.imt", imt_file(RGB[..., 1]).replace(b"\x0c", b"\n")
    yield "thumb.xv", xv_file(RGB[..., 2])
    yield "refused_cut.xv", xv_file(RGB[..., 2])[:-1]
    yield "refused_one_number.xv", xv_file(RGB[..., 2]).replace(b"14 9 255", b"14")


@pytest.mark.parametrize("name", [c[0] for c in _small_raw_cases()])
def test_small_raw_formats_equal_pillow(tmp_path, name):
    """FTEX (DXT1 through the BC1 decoder, raw RGB), GIMP brushes (versions
    1 and 2, gray and RGBA), PIXAR, IM Tools and XV thumbnails; cut files,
    FTEX's other formats and counts, an IMT header without its form feed and
    an XV size line of one number refused as Pillow refuses them."""
    reader = ftex.decode_ftex if name.endswith((".ftc", ".ftu")) else None
    check(tmp_path, dict(_small_raw_cases())[name], name, reader)


# --- McIdas --------------------------------------------------------------------

def _mcidas_cases():
    for nbytes in (1, 2, 4):
        v = RGB[..., 0].astype(np.int64) * (1 if nbytes == 1 else 251) - (nbytes == 4) * 9999
        for label, prefix, bands in (("plain", 0, 1), ("prefix_two_bands", 3, 2),
                                     ("no_bands", 0, 0)):
            data = mcidas_file(v, nbytes, prefix, bands)
            yield f"{nbytes}byte_{label}", data
            yield f"{nbytes}byte_{label}_cut", data[:-1]


@pytest.mark.parametrize("name", [c[0] for c in _mcidas_cases()])
def test_mcidas_equals_pillow(tmp_path, name):
    """1, 2 and 4 bytes an element ("L", "I;16B", "I"), row prefixes, more
    bands than the image's, no bands (a stride of the prefix alone: Pillow's
    memory map overlaps the rows); files cut short as Pillow reads or
    refuses them."""
    check(tmp_path, dict(_mcidas_cases())[name], f"{name}.area")


# --- IPTC/NAA ------------------------------------------------------------------

def _jpeg(pixels: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _iptc_cases():
    g = RGB[..., 1]
    yield "raw_l", iptc_file(14, 9, g.tobytes())
    yield "raw_l_in_fields_of_20", iptc_file(14, 9, g.tobytes(), split=20)
    yield "rgb_band_2", iptc_file(14, 9, g.tobytes(), 3, 1, band=2)
    yield "rgb_first_band", iptc_file(14, 9, g.tobytes(), 3, 1)
    yield "cmyk_band_4", iptc_file(14, 9, g.tobytes(), 4, 1, band=4)
    yield "jpeg_l", iptc_file(14, 9, _jpeg(g), compression=5)
    yield "jpeg_band_1", iptc_file(14, 9, _jpeg(g), 3, 1, compression=5, band=1)
    yield "refused_band_5_of_rgb", iptc_file(14, 9, g.tobytes(), 3, 1, band=5)
    yield "refused_colour_jpeg_as_a_band", iptc_file(14, 9, _jpeg(RGB), 3, 1, compression=5,
                                                     band=2)
    yield "refused_compression_7", iptc_file(14, 9, g.tobytes(), compression=7)
    yield "refused_cut", iptc_file(14, 9, g.tobytes()[:-4])
    yield "not_iptc_two_layers", iptc_file(14, 9, g.tobytes(), 2, 1)


@pytest.mark.parametrize("name", [c[0] for c in _iptc_cases()])
def test_iptc_equals_pillow(tmp_path, name):
    """Raw data behind a P5 header (in one field or several), a band of RGB
    or CMYK, JPEG data; a band past the mode's, a colour JPEG as a band, an
    unknown compression and data cut short refused as Pillow refuses them."""
    check(tmp_path, dict(_iptc_cases())[name], f"{name}.iptc")


@pytest.mark.parametrize("case", ["colour_jpeg_in_l", "jpeg_of_another_size"])
def test_iptc_inconsistent_image_is_refused(tmp_path, case):
    """A deliberate divergence (ROADMAP Queue 3): where the image data is not
    one band of the declared size, Pillow's image disagrees with itself (its
    own array against its ``convert``), and the port refuses the file,
    naming it."""
    g = RGB[..., 1]
    data = iptc_file(14, 9, _jpeg(RGB), compression=5) if case == "colour_jpeg_in_l" else \
        iptc_file(15, 9, _jpeg(g), compression=5)
    path = tmp_path / f"{case}.iptc"
    path.write_bytes(data)
    with Image.open(path) as image:
        image.load()
        own, converted = np.asarray(image), np.asarray(image.convert("L"))
    assert own.shape != converted.shape or own.tobytes() != converted.tobytes()
    with pytest.raises(ValueError, match=rf"{case}\.iptc"):
        read_image(str(path))


# --- tiled TIFFs below 8 bits ----------------------------------------------------

TILED = [(bits, comp, tile, phot, fill)
         for bits in (1, 2, 4) for comp in (1, 5, 32773)
         for tile, phot, fill in (((16, 16), 1, 1), ((32, 8), 0, 1), ((16, 8), 3, 1),
                                  ((24, 16), 1, 2), ((12, 8), 1, 1))]


@pytest.mark.parametrize("bits,comp,tile,phot,fill", TILED,
                         ids=[f"{b}bit-c{c}-{t[0]}x{t[1]}-p{p}-f{f}" for b, c, t, p, f in TILED])
def test_tiled_subbyte_tiff_equals_pillow(tmp_path, bits, comp, tile, phot, fill):
    """1, 2 and 4-bit tiles, uncompressed (Pillow's raw decoder), LZW and
    PackBits (libtiff's), ragged edge tiles, gray of either photometric and
    palette, fill order 2, a tile width of 12 (Pillow's libtiff path
    refuses its compressed tiles); plain and native gathering."""
    levels = np.random.default_rng(bits * 100 + comp).integers(0, 1 << bits, (21, 37))
    cmap = RNG.integers(0, 256, (1 << bits, 3)) if phot == 3 else None
    data = subbyte_tiled_tiff(levels.astype(np.uint8), bits, tile, comp, phot, cmap, fill)
    check(tmp_path, data, "tiled.tif", tiff.decode_tiff)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_tiled_subbyte_tiff_cut_is_refused(tmp_path, bits):
    levels = np.random.default_rng(bits).integers(0, 1 << bits, (21, 37)).astype(np.uint8)
    for comp in (1, 5, 32773):
        data = subbyte_tiled_tiff(levels, bits, (16, 16), comp)[:-40]
        check(tmp_path, data, f"cut_{comp}.tif", tiff.decode_tiff)


@pytest.mark.skipif(not NATIVE, reason="no g++ for the native tile gathering")
def test_tile_bits_gather_native_equals_plain():
    rng = np.random.default_rng(307)
    for bits in (1, 2, 4):
        for tw in (8, 12, 16, 24, 40):
            row = (tw * bits + 7) // 8
            for width in (1, tw - 1, tw, 3 * tw - 5):
                across = -(-width // tw)
                raw = rng.integers(0, 256, (7, across * row)).astype(np.uint8)
                np.testing.assert_array_equal(
                    tiff.tile_bits_gather(raw, across, row, tw, bits, width, native=True),
                    tiff.tile_bits_gather_python(raw, across, row, tw, bits, width))


RARE_FUZZ = (".fits", ".fli", ".flc", ".xpm", ".ftc", ".ftu", ".gbr", ".pxr", ".imt", ".area",
             ".xv", ".iptc")


@pytest.mark.parametrize("ext", RARE_FUZZ)
def test_seeded_fuzz_against_pillow(ext):
    """Three seeded damages (seed 7) of each small fixture of the format,
    read by Pillow (from a file) and by the port: equal arrays or both
    refuse, every time (``tools/fuzz_image_readers.py``'s harness)."""
    import json
    import warnings

    import fuzz_image_readers as fuzz

    warnings.simplefilter("ignore")
    rng = np.random.default_rng(7)
    with open(os.path.join(fuzz.FIXTURES, "manifest.json")) as fh:
        files = [e["file"] for e in json.load(fh)["files"]
                 if "stored" not in e and e["bytes"] < 64_000 and e["file"].endswith(ext)]
    assert files
    diverged = []
    for name in files:
        with open(os.path.join(fuzz.FIXTURES, name), "rb") as fh:
            data = fh.read()
        for trial in range(3):
            damaged = fuzz.damage(data, rng)
            result, message = fuzz.outcome(fuzz.pillow(damaged), fuzz.port(damaged))
            if result not in fuzz.AGREE:
                diverged.append((name, trial, result, message))
    assert not diverged, diverged
