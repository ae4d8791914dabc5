"""The TIFF compressions of libtiff 4.7.1 that the port reads beside LZW,
PackBits, Deflate and JPEG, held against Pillow 12.1.0 (which reads them
through its bundled libtiff) on files written here:

- CCITT RLE, RLEW, Group 3 1-D and 2-D, Group 4 (``utils/tiff_codecs.py``'s
  run decoder and its twin in ``native/src/tiff_codecs.cpp``), ThunderScan,
  LZMA (Python's ``lzma``), Zstandard (the port's RFC 8878 decoder, plain
  and native) and old-style JPEG (``utils/ojpeg.py``): Pillow-written files
  and hand-made ones for what Pillow cannot write, each in modes None, RGB
  and L, on the native and the plain path;
- a seeded damaged-file class a codec: equal arrays or both refuse;
- the compressions Pillow refuses too, each refused by the port naming the
  file; libtiff's YCbCr tables; the predictor libtiff ignores for raw and
  PackBits strips; an incomplete directory; the DDS bit counts Pillow reads.
"""
from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import ojpeg, tiff_codecs
from coma_tpu_torch.utils.image_io import decode_image, read_image
from coma_tpu_torch.utils.modes import to_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_image_fixtures as mf  # noqa: E402

MODES = (None, "RGB", "L")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def pillow(data: bytes):
    """Pillow's three arrays, or None where it refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.load()
            return [np.asarray(im if m is None else im.convert(m)) for m in MODES]
    except Exception:                       # every refusal of Pillow's
        return None


def port(data: bytes, native: bool, monkeypatch):
    """The port's three arrays on one path, or None where it refuses."""
    from coma_tpu_torch.utils import jpeg, tiff

    with monkeypatch.context() as m:
        if not native:
            m.setattr(codecs, "available", lambda: False)
            m.setattr(codecs, "tiff_available", lambda: False)
            m.setattr(jpeg, "native_available", lambda: False)
        try:
            decoded = tiff.decode_tiff(data, "damaged.tif")
        except ValueError as err:
            assert "damaged.tif" in str(err)
            return None
    return [to_mode(decoded, mode) for mode in MODES]


def need_gpp():
    if not codecs.tiff_available():
        pytest.skip("no g++ to build native/src/tiff_codecs.cpp")


def assert_equal_to_pillow(data: bytes, monkeypatch, tmp_path, may_refuse: bool = False):
    """Modes None, RGB and L through ``read_image`` on both paths equal to
    Pillow's; a file Pillow refuses refused by both (``may_refuse``)."""
    want = pillow(data)
    assert want is not None or may_refuse
    path = tmp_path / "case.tif"
    path.write_bytes(data)
    for native in (False, True):
        got = port(data, native, monkeypatch)
        if want is None:
            assert got is None, f"native {native}: read, Pillow refuses"
            continue
        assert got is not None, f"native {native}: refused, Pillow reads"
        for mode, a, b in zip(MODES, want, got):
            assert a.shape == b.shape and a.dtype == b.dtype, (mode, native)
            np.testing.assert_array_equal(a, b, err_msg=f"mode {mode}, native {native}")
    if want is not None:
        np.testing.assert_array_equal(read_image(str(path), "RGB"), want[1])


def pil_tiff(image: np.ndarray, mode=None, **kw) -> bytes:
    im = Image.fromarray(image)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


RGB = mf.seeded_rgb((29, 45), 300, noise=10) // 4 * 4
BITS = np.cumsum(np.random.default_rng(301).random((29, 45)) < 0.15, axis=1) % 2 == 1

PILLOW_WRITTEN = {
    "rle": lambda: pil_tiff(BITS, compression="tiff_ccitt"),
    "rle strips fill order 2": lambda: pil_tiff(BITS, compression="tiff_ccitt",
                                                tiffinfo={278: 7, 266: 2}),
    "g3 1-D": lambda: pil_tiff(BITS, compression="group3"),
    "g3 1-D fill bits": lambda: pil_tiff(BITS, compression="group3", tiffinfo={292: 4}),
    "g3 2-D": lambda: pil_tiff(BITS, compression="group3", tiffinfo={292: 1}),
    "g3 2-D strips fill order 2": lambda: pil_tiff(BITS, compression="group3",
                                                   tiffinfo={292: 5, 278: 6, 266: 2}),
    "g4": lambda: pil_tiff(BITS, compression="group4"),
    "g4 min-is-white strips": lambda: pil_tiff(BITS, compression="group4",
                                               tiffinfo={262: 0, 278: 8}),
    "g4 fill order 2": lambda: pil_tiff(BITS, compression="group4", tiffinfo={266: 2}),
    "g4 strips of 1": lambda: pil_tiff(BITS, compression="group4", tiffinfo={278: 1}),
    "lzma rgb": lambda: pil_tiff(RGB, compression="lzma"),
    "lzma gray strips": lambda: pil_tiff(RGB, "L", compression="lzma", tiffinfo={278: 5}),
    "lzma rgba predictor 2": lambda: pil_tiff(RGB, "RGBA", compression="lzma",
                                              tiffinfo={317: 2}),
    "lzma palette": lambda: pil_tiff(RGB, "P", compression="lzma"),
    "lzma 1-bit": lambda: pil_tiff(BITS, compression="lzma"),
    "zstd rgb": lambda: pil_tiff(RGB, compression="zstd"),
    "zstd gray predictor 2 strips": lambda: pil_tiff(RGB, "L", compression="zstd",
                                                     tiffinfo={317: 2, 278: 4}),
    "zstd 16-bit": lambda: pil_tiff((RGB[..., 0].astype(np.uint16) * 251), compression="zstd"),
    "zstd cmyk": lambda: pil_tiff(RGB, "CMYK", compression="zstd"),
    "zstd 1-bit fill order 2": lambda: pil_tiff(BITS, compression="zstd", tiffinfo={266: 2}),
}


@pytest.mark.parametrize("case", PILLOW_WRITTEN, ids=list(PILLOW_WRITTEN))
def test_pillow_written_equal(case, monkeypatch, tmp_path):
    need_gpp()
    assert_equal_to_pillow(PILLOW_WRITTEN[case](), monkeypatch, tmp_path)


def _jfif(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _ojpeg_tiles(width: int, tile: tuple) -> bytes:
    """A tag-only old-style JPEG of tiles, each a restart interval."""
    tw, th = tile
    height = 40
    jpg = _jfif(mf.seeded_rgb((-(-height // th) * th, tw), 302), quality=85, subsampling=2,
                restart_marker_rows=th // 16)
    qt, ht, intervals = mf._jpeg_tables(jpg)
    blobs = [qt[0], qt[1], ht[(0, 0)], ht[(0, 1)], ht[(1, 0)], ht[(1, 1)]]

    def build(offs):
        tags = {262: (3, [6]), 530: (3, [2, 2]), 512: (3, [1]),
                519: (4, [offs[0], offs[1], offs[1]]), 520: (4, [offs[2], offs[3], offs[3]]),
                521: (4, [offs[4], offs[5], offs[5]])}
        return mf.tiff_file(np.zeros((height, width * 3), np.uint8), (8, 8, 8), 6,
                            compression=6, width=width, tile=tile,
                            chunks=intervals * -(-width // tw), tags=tags)

    at, offs = len(build([0] * 6)), []
    for blob in blobs:
        offs.append(at)
        at += len(blob)
    return build(offs) + b"".join(blobs)


HAND_MADE = {
    "rlew": lambda: mf.tiff_file(np.packbits(BITS, axis=1), (1,), 0, compression=32771,
                                 width=45, chunks=[mf.ccitt_rle(BITS, word=True)]),
    "rle strips of 4": lambda: mf.tiff_file(
        np.packbits(BITS, axis=1), (1,), 1, compression=2, width=45, rows_per_strip=4,
        chunks=[mf.ccitt_rle(BITS[y:y + 4]) for y in range(0, 29, 4)]),
    "g3 1-D eols without fill": lambda: mf.tiff_file(
        np.packbits(BITS, axis=1), (1,), 0, compression=3, width=45,
        chunks=[mf.g3_file(BITS, fill_bits=False)]),
    "g3 no eol": lambda: mf.tiff_file(
        np.packbits(BITS, axis=1), (1,), 0, compression=3, width=45,
        chunks=[mf.ccitt_rle(BITS)]),
    "thunderscan": lambda: mf.tiff_file(
        np.zeros((29, 23), np.uint8), (4,), 1, compression=32809, width=45,
        chunks=[mf.thunder_rows((RGB[..., 0] // 16).astype(np.uint8))]),
    "thunderscan min-is-white strips": lambda: mf.tiff_file(
        np.zeros((29, 23), np.uint8), (4,), 0, compression=32809, width=45, rows_per_strip=8,
        chunks=[mf.thunder_rows((RGB[y:y + 8, :, 1] // 16).astype(np.uint8))
                for y in range(0, 29, 8)]),
    "lzma tiles": lambda: mf.codec_tiff(RGB, 34925, tile=(16, 16)),
    "lzma strips predictor 2": lambda: mf.codec_tiff(RGB[..., 2], 34925, rows_per_strip=6,
                                                     predictor=2),
    "zstd tiles checksum": lambda: mf.codec_tiff(RGB, 50000, tile=(32, 16), checksum=True),
    "zstd strips checksum": lambda: mf.codec_tiff(RGB, 50000, rows_per_strip=7, checksum=True),
    "ojpeg jif 4:4:4": lambda: mf.ojpeg_tiff(_jfif(RGB, quality=92, subsampling=0), 45, 29,
                                             (1, 1)),
    "ojpeg jif 4:2:2": lambda: mf.ojpeg_tiff(_jfif(RGB, quality=70, subsampling=1), 45, 29,
                                             (2, 1)),
    "ojpeg jif 4:2:0, tag 1 x 1": lambda: mf.ojpeg_tiff(_jfif(RGB, quality=80, subsampling=2),
                                                        45, 29, (1, 1)),
    "ojpeg jif gray min-is-white": lambda: mf.ojpeg_tiff(_jfif(RGB[..., 0], quality=75), 45,
                                                         29, (1, 1), photometric=0),
    "ojpeg jif reference black white": lambda: mf.ojpeg_tiff(
        _jfif(RGB, quality=85, subsampling=2), 45, 29, (2, 2),
        tags={532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
              529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}),
    "ojpeg tags 4:2:0": lambda: mf.ojpeg_tiff(_jfif(RGB, quality=85, subsampling=2), 45, 29,
                                              (2, 2), "tags"),
    "ojpeg tags 4:2:0 strips of 16": lambda: mf.ojpeg_tiff(
        _jfif(RGB, quality=85, subsampling=2, restart_marker_rows=1), 45, 29, (2, 2), "tags",
        rows_per_strip=16),
    "ojpeg tags 4:4:4 strips of 8": lambda: mf.ojpeg_tiff(
        _jfif(RGB, quality=60, subsampling=0, restart_marker_rows=1), 45, 29, (1, 1), "tags",
        rows_per_strip=8),
    "ojpeg tags one column of tiles": lambda: _ojpeg_tiles(27, (32, 16)),
}


@pytest.mark.parametrize("case", HAND_MADE, ids=list(HAND_MADE))
def test_hand_made_equal(case, monkeypatch, tmp_path):
    need_gpp()
    assert_equal_to_pillow(HAND_MADE[case](), monkeypatch, tmp_path)


def test_ojpeg_two_columns_of_tiles_as_pillow(monkeypatch, tmp_path):
    """libtiff's stream for a tiled old-style JPEG is one tile wide and one
    column of tiles tall: the tiles past it get the last iMCU row libjpeg
    gave, again and again, and Pillow shows them so."""
    need_gpp()
    data = _ojpeg_tiles(40, (32, 16))
    assert pillow(data) is not None
    assert_equal_to_pillow(data, monkeypatch, tmp_path)


def test_ycbcr_tables_equal_libtiff():
    """``ojpeg.ycbcr_tables`` against ``TIFFYCbCrToRGBInit`` of Pillow's
    libtiff (exported), read back through ctypes, and ``TIFFYCbCrtoRGB``
    on seeded samples."""
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                                  "pillow.libs", "libtiff-*.so*"))
    if not libs:
        pytest.skip("no libtiff bundled with this Pillow")
    lib = ctypes.CDLL(libs[0])
    lib.TIFFYCbCrToRGBInit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_float)]
    lib.TIFFYCbCrtoRGB.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int32,
                                   ctypes.c_int32] + [ctypes.POINTER(ctypes.c_uint32)] * 3
    rng = np.random.default_rng(303)
    for luma, rbw in (((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255)),
                      ((0.2125, 0.7154, 0.0721), (16, 235, 128, 240, 128, 240)),
                      ((0.299, 0.587, 0.114), (15.5, 235.25, 127, 240.5, 129, 241))):
        state = ctypes.create_string_buffer(8192)
        lib.TIFFYCbCrToRGBInit(state, (ctypes.c_float * 3)(*luma), (ctypes.c_float * 6)(*rbw))
        pointers = ctypes.cast(state, ctypes.POINTER(ctypes.c_void_p))
        want = [np.ctypeslib.as_array(ctypes.cast(pointers[k], ctypes.POINTER(ctypes.c_int32)),
                                      (256,)) for k in range(1, 6)]
        tables = ojpeg.ycbcr_tables(luma, rbw)
        for a, b in zip(tables, want):
            np.testing.assert_array_equal(a, b)
        y, cb, cr = (rng.integers(0, 256, 200) for _ in range(3))
        r, g, b = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        ref = []
        for yy, bb, rr in zip(y, cb, cr):
            lib.TIFFYCbCrtoRGB(state, int(yy), int(bb), int(rr), ctypes.byref(r), ctypes.byref(g),
                               ctypes.byref(b))
            ref.append((r.value, g.value, b.value))
        np.testing.assert_array_equal(ojpeg.ycbcr_to_rgb(y, cb, cr, tables), ref)


def test_zstd_decoder_against_libzstd_frames():
    """Frames of libzstd's compressor at levels -5 to 19 (raw, RLE and
    compressed blocks, Huffman and treeless literals, every sequence table
    mode, long matches), with and without the checksum: both decoders give
    the content back."""
    need_gpp()
    rng = np.random.default_rng(304)
    for k in range(10):
        n = int(rng.integers(1, 300_000))
        kind = k % 4
        if kind == 0:
            raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            raw = (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(np.uint8).tobytes()
        elif kind == 2:
            raw = bytes(rng.choice(list(b"abcdefgh  \n"), n).astype(np.uint8))
        else:
            raw = np.repeat(rng.integers(0, 256, n // 50 + 1), 50)[:n].astype(np.uint8).tobytes()
        frame = mf.libzstd_compress(raw, int(rng.integers(-5, 20)), checksum=bool(k % 2))
        assert codecs.zstd_decode(frame, len(raw)) == raw
        if n < 60_000:
            assert tiff_codecs.zstd_decode_python(frame, len(raw)) == raw


# -------------------------------------------------------------- damaged files


def _strips(data: bytes):
    from coma_tpu_torch.utils.tiff import _Ifd

    ifd = _Ifd(data, "x")
    return list(ifd.get(273) or ifd.get(324)), list(ifd.get(279) or ifd.get(325))


def _damaged(data: bytes, rng, first_strip: int = 0) -> bytes:
    """One of: one to three bytes of a strip overwritten, a bit flipped, or
    the strip's tail zeroed; the strip drawn from ``first_strip`` on."""
    b = bytearray(data)
    offsets, counts = _strips(data)
    k = int(rng.integers(first_strip, len(offsets)))
    off, count = offsets[k], counts[k]
    kind = int(rng.integers(0, 3))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            b[off + int(rng.integers(0, count))] = int(rng.integers(0, 256))
    elif kind == 1:
        b[off + int(rng.integers(0, count))] ^= 1 << int(rng.integers(0, 8))
    else:
        cut = int(rng.integers(0, count))
        b[off + cut:off + count] = bytes(count - cut)
    return bytes(b)


# Group 4 strips of more than one row are damaged from the second on: where
# a strip ends early libtiff leaves the rest of Pillow's strip buffer
# unwritten, which for the first strip is uninitialised memory
DAMAGED = {
    "ccitt rle": (lambda: pil_tiff(BITS, compression="tiff_ccitt", tiffinfo={278: 10}), 0),
    "ccitt g3 1-D": (lambda: pil_tiff(BITS, compression="group3", tiffinfo={278: 10}), 0),
    "ccitt g3 2-D": (lambda: pil_tiff(BITS, compression="group3", tiffinfo={292: 1, 278: 10}),
                     0),
    "ccitt g4": (lambda: pil_tiff(BITS, compression="group4", tiffinfo={278: 6}), 1),
    "thunderscan": (HAND_MADE["thunderscan min-is-white strips"], 0),
    "lzma": (lambda: pil_tiff(RGB, compression="lzma", tiffinfo={278: 10}), 0),
    "ojpeg": (lambda: mf.ojpeg_tiff(_jfif(RGB, quality=85, subsampling=2,
                                          restart_marker_rows=1), 45, 29, (2, 2), "tags",
                                    rows_per_strip=16), 0),
}


@pytest.mark.parametrize("case", DAMAGED, ids=list(DAMAGED))
def test_damaged_against_pillow(case, monkeypatch, tmp_path):
    """Twelve seeded damages of a codec's strips (seed 305): equal to
    Pillow on both paths, or refused by both."""
    need_gpp()
    make, first = DAMAGED[case]
    data = make()
    rng = np.random.default_rng(305)
    for _ in range(12):
        assert_equal_to_pillow(_damaged(data, rng, first), monkeypatch, tmp_path,
                               may_refuse=True)


def test_damaged_zstd_against_pillow(monkeypatch, tmp_path):
    """Zstandard strips with their frame or block headers, checksums or
    lengths damaged (seed 306): equal to Pillow on both paths, or refused
    by both. (Damage inside a 4-stream Huffman literal section can differ:
    libzstd's fast decoder refuses some streams read past their start that
    the port reads; ROADMAP Queue 3 keeps it.)"""
    need_gpp()
    data = mf.codec_tiff(RGB, 50000, rows_per_strip=10, checksum=True)
    offsets, counts = _strips(data)
    rng = np.random.default_rng(306)
    for _ in range(16):
        b = bytearray(data)
        k = int(rng.integers(0, len(offsets)))
        off, count = offsets[k], counts[k]
        kind = int(rng.integers(0, 4))
        if kind == 0:                                  # the frame header
            b[off + int(rng.integers(0, 6))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:                                # the first block header
            b[off + 6 + int(rng.integers(0, 3))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:                                # the checksum
            b[off + count - 1 - int(rng.integers(0, 4))] ^= 1 << int(rng.integers(0, 8))
        else:                                          # the strip's tail zeroed
            cut = int(rng.integers(1, count))
            b[off + cut:off + count] = bytes(count - cut)
        assert_equal_to_pillow(bytes(b), monkeypatch, tmp_path, may_refuse=True)


def test_g4_early_end_keeps_the_strip_before(monkeypatch, tmp_path):
    """A Group 4 strip that ends after its first row: libtiff returns the
    strip, and Pillow's buffer keeps the earlier strip's rows for the rest."""
    need_gpp()
    data = bytearray(pil_tiff(BITS, compression="group4", tiffinfo={278: 6}))
    offsets, counts = _strips(bytes(data))
    data[offsets[2] + counts[2] // 3:offsets[2] + counts[2]] = bytes(counts[2] - counts[2] // 3)
    want = pillow(bytes(data))
    assert want is not None and not np.array_equal(want[0], BITS)
    assert_equal_to_pillow(bytes(data), monkeypatch, tmp_path)


# ------------------------------------------------------- refused, and fixes

REFUSED_TOO = {"NeXT": (32766, 1), "PixarLog": (32909, 1), "JPEG 2000": (34712, 1),
               "LERC": (34887, 1), "WebP": (50001, 1), "SGILog": (34676, 32844),
               "SGILog24": (34677, 32845)}


@pytest.mark.parametrize("name", REFUSED_TOO, ids=list(REFUSED_TOO))
def test_pillow_refuses_too(name, tmp_path):
    """Compressions this host's Pillow refuses (absent from its
    COMPRESSION_INFO, not configured in its libtiff, or SGILog's LogL and
    LogLuv photometrics, which PIL's OPEN_INFO lacks): the port refuses them
    too, naming the file."""
    compression, photometric = REFUSED_TOO[name]
    spp = 3 if photometric == 32845 else 1
    data = mf.tiff_file(np.zeros((8, 8 * spp), np.uint8), (8,) * spp, photometric,
                        compression=compression, chunks=[bytes(range(64)) * spp])
    assert pillow(data) is None
    path = tmp_path / f"refused_{compression}.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"refused_{compression}.tif.*{name}"):
        read_image(str(path))


@pytest.mark.parametrize("compression", [1, 32773], ids=["raw", "packbits"])
def test_predictor_ignored_for_raw_and_packbits(compression, monkeypatch, tmp_path):
    """libtiff undoes horizontal differencing only for the codecs that set
    it up (LZW, Deflate, LZMA, Zstandard); Pillow's raw reader and
    PackBits leave a predictor tag alone, and so does the port."""
    data = mf.tiff_file(RGB, (8, 8, 8), 2, compression=compression, tags={317: (3, [2])})
    assert np.array_equal(pillow(data)[0], RGB)
    assert_equal_to_pillow(data, monkeypatch, tmp_path)


@pytest.mark.parametrize("compression", [5, 34925, 50000, 4], ids=["lzw", "lzma", "zstd", "g4"])
def test_incomplete_directory_refused(compression, monkeypatch, tmp_path):
    """A file cut inside its directory's last entry: Pillow's own parser
    keeps the entries that fit, but libtiff reads a directory whole or not
    at all, so Pillow refuses the file, and so does the port."""
    image = BITS if compression == 4 else RGB
    data = pil_tiff(image, compression={5: "tiff_lzw", 34925: "lzma", 50000: "zstd",
                                        4: "group4"}[compression])
    ifd = int.from_bytes(data[4:8], "little")
    count = int.from_bytes(data[ifd:ifd + 2], "little")
    cut = data[:ifd + 2 + 12 * count - 6]
    assert pillow(cut) is None
    assert_equal_to_pillow(cut, monkeypatch, tmp_path, may_refuse=True)


def test_dds_any_rgb_bit_count():
    """Pillow's DdsRgbDecoder reads every DDPF_RGB bit count (``bitcount //
    8`` bytes a pixel, none for counts under 8): the fuzz's seed 1, trial 15
    of ``dds_rgb565.dds`` (a byte dropped, the count 0) and other counts."""
    with open(os.path.join(REPO, "tests", "data", "images", "dds_rgb565.dds"), "rb") as fh:
        data = fh.read()
    cases = [data[:87] + data[88:]]
    for bits in (4, 12, 24, 40, 72, 0xFFFF):
        b = bytearray(data)
        b[88:92] = struct.pack("<I", bits)
        cases.append(bytes(b))
    for case in cases:
        want = pillow(case)
        got = decode_image(case, "case.dds")
        for mode, a in zip(MODES, want):
            np.testing.assert_array_equal(to_mode(got, mode), a)


def _entry_at(data: bytearray, tag: int) -> int:
    ifd = int.from_bytes(data[4:8], "little")
    for k in range(int.from_bytes(data[ifd:ifd + 2], "little")):
        e = ifd + 2 + 12 * k
        if int.from_bytes(data[e:e + 2], "little") == tag:
            return e
    raise KeyError(tag)


def _directory_case(case: str) -> bytes:
    d = bytearray(mf.codec_tiff(RGB, 50000))
    if case == "repeated tag, libtiff's first bad":
        e = _entry_at(d, 278)                    # RowsPerStrip becomes a bad PlanarConfig
        d[e:e + 2], d[e + 8:e + 12] = (284).to_bytes(2, "little"), (9).to_bytes(4, "little")
    elif case == "byte count 0, estimated":
        e = _entry_at(d, 279)
        d[e + 8:e + 12] = bytes(4)
    elif case == "byte count too large, limited":
        e = _entry_at(d, 279)
        d[e + 8:e + 12] = (1 << 28).to_bytes(4, "little")
    elif case == "more offsets than strips":
        e = _entry_at(d, 273)                    # two offsets for the one strip
        d[e + 4:e + 8] = (2).to_bytes(4, "little")
        d[e + 8:e + 12] = len(d).to_bytes(4, "little")
        d += (8).to_bytes(4, "little") + (len(d) - 4).to_bytes(4, "little")
    elif case == "samples unseen by Pillow":
        e = _entry_at(d, 262)                    # its data past the end: Pillow stops there
        d[e + 4:e + 8] = (40).to_bytes(4, "little")
        d[e + 8:e + 12] = (1 << 20).to_bytes(4, "little")
    elif case == "bits of an unknown type":
        e = _entry_at(d, 258)
        d[e + 2:e + 4] = (200).to_bytes(2, "little")
    return bytes(d)


DIRECTORY = ["repeated tag, libtiff's first bad", "byte count 0, estimated",
             "byte count too large, limited", "more offsets than strips",
             "samples unseen by Pillow", "bits of an unknown type"]


@pytest.mark.parametrize("case", DIRECTORY, ids=DIRECTORY)
def test_directory_as_libtiff_reads_it(case, monkeypatch, tmp_path):
    """Directories where libtiff's view (the layout and the codec's tags)
    and Pillow's (the mode) part: a repeated tag's first entry, a byte count
    estimated or limited, offsets cut to the strips, samples Pillow's parser
    stops before, a tag of a type libtiff does not convert."""
    need_gpp()
    assert_equal_to_pillow(_directory_case(case), monkeypatch, tmp_path, may_refuse=True)


def test_damaged_zstd_literals_against_pillow(monkeypatch, tmp_path):
    """Zstandard strips whose literals header or jump table has a byte
    changed (seed 307), small enough that libzstd decodes their 4-stream
    literals with its single-symbol Huffman decoder: the streams' bounds
    move, and libzstd's fast loop, its check of a stream read past its
    start and its tail's reading near the section's start are followed.
    (The double-symbol decoder of larger literal sections is ROADMAP Queue
    3's residue.)"""
    need_gpp()
    image = (np.cumsum(np.random.default_rng(309).integers(0, 3, (16, 64, 3)), axis=1) * 7
             % 256).astype(np.uint8)
    data = pil_tiff(image, compression="zstd", tiffinfo={278: 16})
    offsets, counts = _strips(data)
    rng = np.random.default_rng(307)
    for _ in range(60):
        b = bytearray(data)
        k = int(rng.integers(0, len(offsets)))
        b[offsets[k] + int(rng.integers(9, 20))] = int(rng.integers(0, 256))
        assert_equal_to_pillow(bytes(b), monkeypatch, tmp_path, may_refuse=True)


def test_damaged_zstd_double_symbol_literals_against_pillow(monkeypatch, tmp_path):
    """The committed ``zstd_rgb.tif``, whose 4-stream literal section libzstd
    decodes with its double-symbol Huffman decoder (``HUF_selectDecoder``),
    with one byte of its literals header, jump table or streams changed
    (seed 308; the fuzz's seeds 10 and 11, trials 50 and 103, among them):
    libzstd's double-symbol fast loop and its check of a stream read past
    its start are followed, on both paths."""
    need_gpp()
    with open(os.path.join(REPO, "tests", "data", "images", "zstd_rgb.tif"), "rb") as fh:
        data = fh.read()
    rng = np.random.default_rng(308)
    changes = [(18, 248), (58, 95)] + [(int(rng.integers(9, 120)), int(rng.integers(0, 256)))
                                       for _ in range(40)]
    for at, value in changes:
        b = bytearray(data)
        b[at] = value
        assert_equal_to_pillow(bytes(b), monkeypatch, tmp_path, may_refuse=True)
