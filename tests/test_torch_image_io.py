"""The port's image reading against Pillow and ``coma_tpu``.

``coma_tpu`` opens every image with PIL; the port reads them with
``utils/image_io.read_image`` (its own decoders: ``utils/jpeg.py``,
``utils/png.py``, ``utils/{bmp,tga,pnm,tiff,gif_reader}.py``). Held here,
bit for bit, with no tolerance:

- the committed fixtures of ``tests/data/images/`` (``tools/make_image_fixtures.py``
  writes them) against the Pillow hashes of their manifest, for modes None,
  RGB and L, and against Pillow at test time; every fixture Pillow refuses,
  the port refuses naming the file; seeded images written by Pillow at test
  time (every sampling, quality, progressive, optimised tables, restart
  intervals, grayscale, odd sizes, EXIF/ICC/COM segments); Adam7-interlaced
  PNGs;
- the plain (Python entropy decoders, numpy reconstruction and codecs) and
  native (C++) paths: equal coefficients and equal pixels on every fixture;
- PIL's bicubic resize (``utils/resize.resize_bicubic``) and ``cli/inpaint``'s
  and ``cli/select_mask``'s inputs against ``coma_tpu``'s own lines;
- the refusals: JPEGs libjpeg refuses (hierarchical, arithmetic lossless,
  12-bit, a DNL height, sampling ratios that are not whole) and files of no
  format read here raise a ``ValueError`` naming the file, as Pillow raises.

Images stay at 128² or smaller, except the resize's inputs. The 512² and
2048 x 1536 fixtures are decoded on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 16) and by ``tests/test_torch_image_formats.py``.
"""
import io
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.cli import inpaint as t_inpaint
from coma_tpu_torch.utils import dds, gif_reader, jpeg, psd, tga, tiff, webp
from coma_tpu_torch.utils.image_io import decode_image, read_image
from coma_tpu_torch.utils.resize import resize_bicubic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import adam7_png, array_sha, seeded_rgb  # noqa: E402

with open(os.path.join(FIXTURES, "manifest.json")) as _fh:
    MANIFEST = json.load(_fh)
SMALL = [e for e in MANIFEST["files"]
         if e.get("raises") or e["shape"][0] * e["shape"][1] <= 128 * 128]


def sha(a: np.ndarray) -> str:
    return array_sha(a)


def pillow(data: bytes, mode: str) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert(mode))


def jpeg_bytes(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def need_gpp():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native entropy decoder cannot be built")


def test_manifest_is_small_and_covers_every_kind():
    assert sum(e["bytes"] for e in MANIFEST["files"]) <= 4_134_207
    kinds = " ".join(e["kind"] for e in MANIFEST["files"])
    for word in ("baseline 420", "baseline 422", "baseline 444", "q30", "q75", "q95",
                 "grayscale", "odd size", "optimize", "restart", "progressive 4:2:0",
                 "progressive grayscale", "EXIF", "CMYK", "Adam7 RGB", "Adam7 palette",
                 "BEHAVE colour", "BEHAVE person mask", "SOF9", "SOF10", "DAC", "4:1:1",
                 "4:4:0", "mixed sampling", "YCCK", "block smoothing", "DC interpolation",
                 "lossless (SOF3)", "12-bit", "DNL", "hierarchical", "SOF11", "BMP RLE8",
                 "BMP RLE4", "BI_BITFIELDS", "top-down", "TGA type 1", "TGA type 2", "TGA type 3",
                 "TGA type 9", "TGA type 10", "TGA type 11", "P1", "P2", "P3", "P4", "P5", "P6",
                 "TIFF RGB, LZW", "Deflate", "PackBits", "tiles", "predictor 2", "TIFF palette",
                 "TIFF 1-bit", "TIFF LA", "TIFF RGBA", "GIF palette", "interlaced",
                 "transparent", "5 frames", "(refused)", "WebP lossy", "WebP lossless",
                 "ALPH", "simple loop filter", "token partitions", "colour indexing",
                 "animation", "DDS DXT1", "DXT3", "DXT5", "BC5", "BC4", "BC5S", "BC6H UF16",
                 "BC6H SF16", "BC7", "bit masks", "DDS luminance", "DDS 8-bit palette",
                 "R8G8B8A8", "PSD RGB", "PSD RGBA", "PSD gray", "multichannel", "duotone",
                 "PSD indexed", "PSD CMYK", "PSD bitmap", "TIFF JPEG, RGB",
                 "TIFF JPEG, YCbCr", "YCbCr 4:2:0", "separate planes", "fill order 2",
                 "BigTIFF", "SGI RLE", "SGI verbatim", "PCX RGB", "PCX 4 bit planes", "DCX",
                 "ICO, PNG members", "ICO, BMP member", "CUR", "QOI", "XBM", "IM YCC", "IM Lut",
                 "ICNS is32 RLE", "BLP1 palette", "BLP1 JPEG", "BLP2 DXT5", "BLP2 raw BGRA",
                 "Sun raster RLE", "Sun raster 8-bit", "MSP version 2", "SPIDER", "bare DIB",
                 "CCITT RLE", "RLEW", "Group 3 1-D", "Group 3 2-D", "CCITT Group 4",
                 "ThunderScan", "LZMA", "Zstandard", "content checksum", "old-style JPEG",
                 "JPEGInterchangeFormat", "tables in tags", "JPEG 2000 JP2 RGB, 5/3",
                 "9/7, ICT", "JPEG 2000 I;16", "progression RPCL", "progression PCRL",
                 "progression CPRL", "code-block style bypass", "code-block style vsc",
                 "POC", "4:2:0 subsampled", "ROI maxshift", "SOP and EPH", "PPM", "PPT",
                 "JP2 palette", "ICNS ic07 JPEG 2000 member", "PSD Lab", "TIFF CIELab",
                 "big-endian", "PFM", "PyP", "PyRGBA", "PyCMYK", "P0CMYK", "FITS BITPIX -32",
                 "NAXIS 3", "FITS GZIP_1", "FLI BRUN", "FLC LC and SS2", "FLC BLACK and COPY",
                 "prefix chunk", "PhotoCD", "XPM two-character keys", "XPM of 300 colours",
                 "XPM named colour", "FTEX DXT1", "FTEX uncompressed", "GIMP brush version 1",
                 "GIMP brush version 2", "PIXAR", "IM Tools", "McIdas area, 2 bytes",
                 "McIdas area, 4 bytes", "XV thumbnail", "IPTC/NAA raw", "IPTC/NAA RGB",
                 "IPTC/NAA JPEG", "TIFF tiled 1-bit", "TIFF tiled 2-bit", "TIFF tiled 4-bit",
                 "AVIF lossless 4:4:4", "AVIF lossless 4:2:2", "AVIF lossless 4:2:0",
                 "AVIF lossless 4:0:0", "limited range", "AVIF lossless RGBA", "two tile columns",
                 "two by two tiles", "128 x 128 superblocks", "Exif orientation 6",
                 "identity matrix", "bt709 matrix", "bt2020 matrix", "premultiplied alpha",
                 "limited-range alpha item", "AVIF lossy, quality 75", "AVIF lossy 4:2:2",
                 "a lossy alpha item", "AVIF lossy at Pillow's defaults",
                 "CDEF with loop restoration", "a restored alpha item",
                 "AVIF screen content", "intra block copy", "AVIF quantizer matrices",
                 "AVIF film grain"):
        assert word in kinds, word
    big = [e["shape"][:2] for e in MANIFEST["files"] if e["file"].startswith("behave")]
    assert big == [[1536, 2048], [1536, 2048]]
    atlas = [e["shape"][:2] for e in MANIFEST["files"] if e["file"].startswith("atlas")]
    assert atlas == [[1536, 2048]] * 23
    assert MANIFEST["step_video"]["decoded_shape"] == [17, 256, 512, 3]


@pytest.mark.parametrize("entry", SMALL, ids=[e["file"] for e in SMALL])
def test_fixture_equals_pillow(entry):
    """Modes None, RGB and L against the manifest's Pillow hashes and Pillow
    now; a file Pillow refuses, both refuse."""
    path = os.path.join(FIXTURES, entry["file"])
    with open(path, "rb") as fh:
        data = fh.read()
    if entry.get("raises"):
        with pytest.raises(ValueError, match=re.escape(entry["file"])):
            read_image(path)
        # Pillow refuses unknown DDS formats with NotImplementedError
        with pytest.raises((OSError, SyntaxError, ValueError, NotImplementedError)):
            with Image.open(path) as im:
                im.load()
                np.asarray(im)
        return
    for mode in ("RGB", "L"):
        if entry["sha256"][mode] is None:          # Pillow refuses "LAB" to "L"; so does the port
            with pytest.raises(ValueError, match=re.escape(entry["file"])):
                read_image(path, mode)
            with pytest.raises(ValueError):
                pillow(data, mode)
            continue
        got = read_image(path, mode)
        assert got.dtype == np.uint8
        assert sha(got) == entry["sha256"][mode]
        np.testing.assert_array_equal(got, pillow(data, mode))
    own = read_image(path)
    assert list(own.shape) == entry["shape"] and str(own.dtype) == entry["dtype"]
    assert sha(own) == entry["sha256"]["None"]
    with Image.open(path) as im:
        assert decode_image(data, entry["file"]).mode == im.mode == entry["mode"]
        np.testing.assert_array_equal(own, np.asarray(im))


SEEDED = [
    ("420_q30", (64, 64), dict(quality=30)),
    ("420_q90", (50, 70), dict(quality=90)),
    ("422_q55", (40, 56), dict(quality=55, subsampling=1)),
    ("444_q85", (33, 47), dict(quality=85, subsampling=0)),
    ("q100", (24, 24), dict(quality=100)),
    ("q1", (24, 40), dict(quality=1)),
    ("optimize", (48, 64), dict(quality=70, optimize=True)),
    ("restart_blocks", (48, 64), dict(quality=70, restart_marker_blocks=3)),
    ("restart_rows", (48, 64), dict(quality=70, restart_marker_rows=1, subsampling=1)),
    ("progressive_420", (61, 77), dict(quality=75, progressive=True)),
    ("progressive_422", (40, 40), dict(quality=95, progressive=True, subsampling=1)),
    ("progressive_444", (40, 40), dict(quality=60, progressive=True, subsampling=0)),
    ("progressive_restart", (48, 64), dict(quality=75, progressive=True,
                                           restart_marker_blocks=2)),
    ("tiny_1x1", (1, 1), dict(quality=75)),
    ("narrow_3x2", (3, 2), dict(quality=75)),
    ("narrow_5x4", (5, 4), dict(quality=75, subsampling=1)),
    ("tall_128x9", (128, 9), dict(quality=75)),
]


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("name,shape,kw", SEEDED, ids=[s[0] for s in SEEDED])
def test_seeded_jpeg_equals_pillow(name, shape, kw, gray, native):
    if native:
        need_gpp()
    image = seeded_rgb(shape, seed=sum(shape) + len(name))
    data = jpeg_bytes(image[..., 1] if gray else image, **kw)
    got = jpeg.decode_jpeg(data, name, native=native)
    assert got.shape == shape + ((1,) if gray else (3,))
    np.testing.assert_array_equal(got[..., 0] if gray else got, pillow(data, "L" if gray else "RGB"))


def test_noise_and_metadata_jpegs_equal_pillow():
    """Full-range noise (large coefficients, long codes) and a file with
    EXIF, ICC and COM segments before the frame."""
    rng = np.random.default_rng(11)
    noise = rng.integers(0, 256, (45, 67, 3), dtype=np.uint8)
    for kw in (dict(quality=98), dict(quality=90, progressive=True, subsampling=0)):
        data = jpeg_bytes(noise, **kw)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), pillow(data, "RGB"))
    exif = Image.Exif()
    exif[0x0112] = 3
    data = jpeg_bytes(noise, quality=80, exif=exif.tobytes(), icc_profile=b"icc" * 300,
                      comment=b"a comment")
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pillow(data, "RGB"))


@pytest.mark.parametrize("kw", [dict(quality=75), dict(quality=40, subsampling=1),
                                dict(quality=90, subsampling=0, restart_marker_blocks=4),
                                dict(quality=80, progressive=True),
                                dict(quality=60, progressive=True, optimize=True,
                                     restart_marker_rows=1)],
                         ids=["420", "422", "444_restart", "progressive", "progressive_opt"])
def test_plain_and_native_entropy_decoders_agree(kw):
    """The same quantised coefficients and pixels; the native library is
    built with g++ (skipped only where there is none)."""
    need_gpp()
    assert jpeg.native_available()
    for gray in (False, True):
        image = seeded_rgb((56, 72), seed=5)
        data = jpeg_bytes(image[..., 0] if gray else image,
                          **{k: v for k, v in kw.items() if not (gray and k == "subsampling")})
        plain = jpeg.decode_coefficients(data, native=False)
        native = jpeg.decode_coefficients(data, native=True)
        assert len(plain.coef) == len(native.coef) == (1 if gray else 3)
        for a, b in zip(plain.coef, native.coef):
            assert a.dtype == b.dtype == np.int16 and np.abs(a).sum() > 0
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jpeg.reconstruct(native, native=True),
                                      jpeg.reconstruct(plain, native=False))


def test_plain_and_native_agree_on_every_small_fixture():
    """Every JPEG fixture (Huffman, arithmetic, lossless, smoothed): equal
    coefficients or samples and pixels; every GIF, TGA, TIFF, WebP, DDS and
    PSD fixture: equal pixels through the plain and the native codecs."""
    need_gpp()
    readers = {".gif": gif_reader.decode_gif, ".tga": tga.decode_tga, ".tif": tiff.decode_tiff,
               ".webp": webp.decode_webp, ".dds": dds.decode_dds, ".psd": psd.decode_psd}
    for entry in SMALL:
        if entry.get("raises"):
            continue
        with open(os.path.join(FIXTURES, entry["file"]), "rb") as fh:
            data = fh.read()
        ext = os.path.splitext(entry["file"])[1]
        if ext in readers:
            plain = readers[ext](data, entry["file"], native=False)
            native = readers[ext](data, entry["file"], native=True)
            np.testing.assert_array_equal(plain.pixels, native.pixels)
            continue
        if ext != ".jpg":
            continue
        plain = jpeg.decode_coefficients(data, entry["file"], native=False)
        native = jpeg.decode_coefficients(data, entry["file"], native=True)
        for a, b in zip(plain.coef, native.coef):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jpeg.reconstruct(native, native=True),
                                      jpeg.reconstruct(plain, native=False))


def patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with byte ``offset`` of the first ``marker`` segment's body
    set to ``value`` (offset -1: the marker code itself)."""
    pos = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    if offset < 0:
        out[pos + 1] = value
    else:
        out[pos + 4 + offset] = value
    return bytes(out)


@pytest.mark.parametrize("what,edit,match", [
    ("arithmetic", (0xC0, -1, 0xCB), "arithmetic lossless"),
    ("arithmetic_progressive", (0xC0, -1, 0xCE), "arithmetic hierarchical"),
    ("lossless", (0xC0, -1, 0xC7), "hierarchical lossless"),
    ("hierarchical", (0xC0, -1, 0xC5), "hierarchical"),
    ("12-bit", (0xC0, 0, 12), "12-bit"),
    ("fractional_sampling", (0xC0, 10, 0x21), "sampling factors"),
    ("mcu_over_10_blocks", (0xC0, 7, 0x44), "10 blocks"),
    ("dnl_height", (0xC0, 1, 0), "DNL"),
])
def test_unsupported_jpegs_raise_naming_the_file(tmp_path, what, edit, match):
    """JPEGs libjpeg-turbo refuses: Pillow raises, and the port raises a
    ``ValueError`` naming the file and the feature."""
    path = tmp_path / f"{what}.jpg"
    data = jpeg_bytes(seeded_rgb((16, 16), 1), quality=75, subsampling=1)
    if what == "dnl_height":
        data = patched(data, 0xC0, 2, 0)
    if what == "fractional_sampling":                  # luma 3x1 over chroma 2x1
        data = patched(data, 0xC0, 7, 0x31)
    path.write_bytes(patched(data, *edit))
    with pytest.raises((OSError, SyntaxError)):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match=rf"{what}\.jpg.*{match}"):
        read_image(str(path), "RGB")


def test_other_files_raise_naming_the_file(tmp_path):
    for name, data in (("a.gif", b"GIF89a" + bytes(20)), ("b.txt", b"hello"),
                       ("c.jpg", jpeg_bytes(seeded_rgb((16, 16), 2))[:300])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(tmp_path / name))
    with pytest.raises(ValueError, match="mode"):
        read_image(str(tmp_path / "a.gif"), "RGBA")


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (7, 9), (29, 37), (64, 48)])
def test_interlaced_pngs_equal_pillow(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    cases = {"rgb": adam7_png(seeded_rgb(shape, 3), 2)}
    for depth in (1, 2, 4, 8):
        palette = rng.integers(0, 256, (1 << depth, 3))
        idx = rng.integers(0, 1 << depth, shape + (1,)).astype(np.uint8)
        cases[f"p{depth}"] = adam7_png(idx, 3, depth=depth, palette=palette)
    for name, data in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(read_image(str(path), mode), pillow(data, mode))


@pytest.mark.parametrize("shape", [(384, 384), (480, 640), (500, 300)])
def test_resize_bicubic_equals_pillow_and_coma_tpu(tmp_path, shape):
    """``resize_bicubic`` against ``Image.resize((512, 512))`` (Pillow's
    default, BICUBIC), and ``cli/inpaint.load_batch`` against ``coma_tpu``'s
    own lines on a render and a mask of that size."""
    rng = np.random.default_rng(shape[1])
    render = seeded_rgb(shape, 7)
    mask = np.zeros(shape, np.uint8)
    mask[shape[0] // 5:4 * shape[0] // 5, shape[1] // 4:3 * shape[1] // 4] = 255
    mask[rng.uniform(size=shape) < 0.02] ^= 255
    for image in (render, mask):
        for size in ((512, 512), (64, 64)):
            np.testing.assert_array_equal(resize_bicubic(image, size),
                                          np.asarray(Image.fromarray(image).resize(size)))
    Image.fromarray(render).save(tmp_path / "r.png")
    Image.fromarray(mask).save(tmp_path / "m.jpg", quality=90)     # a JPEG under the mask
    w = dict(render=str(tmp_path / "r.png"), mask=str(tmp_path / "m.jpg"))
    imgs, masks = t_inpaint.load_batch([w], 512)
    # coma_tpu/cli/inpaint.py's lines
    want_img = np.asarray(Image.open(w["render"]).convert("RGB").resize((512, 512)),
                          np.float32) / 127.5 - 1.0
    want_mask = (np.asarray(Image.open(w["mask"]).convert("L").resize((512, 512))) > 127) \
        .astype(np.float32)
    np.testing.assert_array_equal(imgs[0].permute(1, 2, 0).numpy(), want_img)
    np.testing.assert_array_equal(masks[0].numpy(), want_mask)


def test_select_mask_and_predict_inputs_equal_coma_tpu(tmp_path):
    """``select_mask`` reads ``convert("L")``, ``segment_human`` and
    ``predict_human`` ``convert("RGB")``: the same arrays from JPEG data
    (under a .png name, as PIL opens by content) and from PNGs."""
    rgb = seeded_rgb((40, 56), 9)
    files = {"a.png": lambda p: Image.fromarray(rgb).save(p),
             "b.png": lambda p: Image.fromarray(rgb).save(p, "JPEG", quality=70),
             "c.jpg": lambda p: Image.fromarray(rgb[..., 2]).save(p, quality=85),
             "d.png": lambda p: Image.fromarray(rgb).convert("P").save(p)}
    for name, write in files.items():
        write(str(tmp_path / name))
        for mode in ("L", "RGB"):
            with Image.open(tmp_path / name) as im:
                np.testing.assert_array_equal(read_image(str(tmp_path / name), mode),
                                              np.asarray(im.convert(mode)))
