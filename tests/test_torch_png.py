"""The port's PNG reader and writer: round trips, and agreement with PIL.

Every mode the inpaint CLI meets (gray, gray+alpha, RGB, RGBA, 8-bit) is
written with each of the five filter types and read back unchanged; PIL
reads what the port writes, the port reads what PIL writes (PIL chooses its
own filters), and ``to_rgb``/``to_gray`` equal PIL's ``convert``.
"""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.utils import png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def image(channels, seed=0, h=37, w=53):
    rng = np.random.default_rng(seed)
    # smooth ramps plus noise, so every filter sees both kinds of rows
    yy, xx = np.mgrid[:h, :w]
    base = (yy * 7 + xx * 3)[..., None] + rng.integers(0, 40, size=(h, w, channels))
    return np.uint8(base % 256)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_round_trip_and_pil_reads_it(tmp_path, channels, filter_type):
    img = image(channels, seed=channels * 10 + filter_type)
    path = tmp_path / "x.png"
    path.write_bytes(png.encode_png(img, filter_type=filter_type))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    assert Image.open(path).mode == MODES[channels]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_reads_what_pil_writes(tmp_path, channels):
    img = image(channels, seed=channels, h=64, w=48)
    path = tmp_path / "pil.png"
    Image.fromarray(img[..., 0] if channels == 1 else img, MODES[channels]).save(path)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


def test_conversions_equal_pil(tmp_path):
    for channels in (1, 2, 3, 4):
        img = image(channels, seed=5)
        pil = Image.fromarray(img[..., 0] if channels == 1 else img, MODES[channels])
        np.testing.assert_array_equal(png.to_rgb(img), np.asarray(pil.convert("RGB")))
        np.testing.assert_array_equal(png.to_gray(img), np.asarray(pil.convert("L")))


def test_write_png_and_errors(tmp_path):
    img = image(3, seed=9)
    png.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), img)
    with pytest.raises(TypeError):
        png.encode_png(img.astype(np.uint16))
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")   # palette: read as PIL does
    (tmp_path / "p.png").write_bytes(buf.getvalue())
    with Image.open(tmp_path / "p.png") as im:
        np.testing.assert_array_equal(png.to_rgb(png.read_png(str(tmp_path / "p.png"))),
                                      np.asarray(im.convert("RGB")))
    interlaced = bytearray(png.encode_png(img))                # Adam7: not read
    interlaced[28] = 1
    interlaced[29:33] = struct.pack(">I", zlib.crc32(bytes(interlaced[12:29])) & 0xFFFFFFFF)
    (tmp_path / "i.png").write_bytes(bytes(interlaced))
    with pytest.raises(ValueError, match="colour type"):
        png.read_png(str(tmp_path / "i.png"))
    bad = bytearray(png.encode_png(img))
    bad[40] ^= 0xFF
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(tmp_path / "bad.png"))
