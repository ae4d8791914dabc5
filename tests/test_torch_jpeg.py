"""The numpy JPEG round trip (``utils/jpeg.py``) against Pillow: the image
``Image.save(buf, "JPEG", quality=q)`` then ``Image.open(buf)`` gives.

Measured against Pillow 12.1.0 (libjpeg-turbo) on the seeded images below,
128² at q ∈ {30, 55, 79} and odd sizes that need edge padding: every value
equal (share 1.0). The test allows what that measurement leaves room for,
and no more: at most 0.1% of values may differ, by 1/255 at most. The
quantisation tables equal the ones Pillow writes into the file.
"""
import io

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch.utils.jpeg import jpeg_roundtrip, quant_tables


def pillow_roundtrip(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf)), Image.open(io.BytesIO(buf.getvalue())).quantization


def seeded_image(shape, seed, kind):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    if kind == "noise":
        return rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    if kind == "person":
        from coma_tpu_torch.models.synthetic_person import person_batch

        assert shape[0] == shape[1]
        return (person_batch(rng, 1, shape[0])[0][0] * 255).astype(np.uint8)
    smooth = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    return np.clip(smooth + rng.normal(0, 20, shape + (3,)), 0, 255).astype(np.uint8)


def check(img, quality):
    got = jpeg_roundtrip(img, quality)
    want, _ = pillow_roundtrip(img, quality)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    assert (diff > 0).mean() <= 1e-3 and diff.max() <= 1
    return (diff == 0).mean()


@pytest.mark.parametrize("quality", [30, 55, 79])
@pytest.mark.parametrize("kind", ["smooth", "noise", "person"])
def test_roundtrip_matches_pillow_128(quality, kind):
    assert check(seeded_image((128, 128), quality, kind), quality) == 1.0


@pytest.mark.parametrize("shape", [(100, 120), (37, 53), (8, 8), (17, 16)])
def test_roundtrip_matches_pillow_odd_sizes(shape):
    for quality in (30, 79):
        assert check(seeded_image(shape, sum(shape), "smooth"), quality) == 1.0


@pytest.mark.parametrize("quality", [1, 30, 50, 55, 79, 100])
def test_quant_tables_match_pillow(quality):
    """Pillow's ``quantization`` lists each table in natural (row) order."""
    _, tables = pillow_roundtrip(np.zeros((16, 16, 3), np.uint8), quality)
    for table, ours in zip((tables[0], tables[1]), quant_tables(quality)):
        np.testing.assert_array_equal(np.asarray(table).reshape(8, 8), ours)


def test_rejects_non_rgb_uint8():
    with pytest.raises(ValueError):
        jpeg_roundtrip(np.zeros((8, 8), np.uint8), 50)
    with pytest.raises(ValueError):
        jpeg_roundtrip(np.zeros((8, 8, 3), np.float32), 50)


# ---------------------------------------------------------------------------
# The decoder's arithmetic coding and block smoothing (utils/jpeg.py)
# ---------------------------------------------------------------------------

def test_arithmetic_tables_equal_the_native_source():
    """The QM decoder's state table (Qe, next LPS with the switch bit, next
    MPS) is the same in the plain and the C++ decoder."""
    import os
    import re

    from coma_tpu_torch.utils import jpeg

    src = open(os.path.join(os.path.dirname(jpeg.__file__), "..", "native", "src",
                            "jpeg_decode.cpp")).read()

    def table(name):
        body = re.search(name + r"\[114\] = \{(.*?)\};", src, re.S).group(1)
        return [int(v, 0) for v in body.replace("\n", " ").split(",")]

    assert table("kQe") == jpeg._QE and len(jpeg._QE) == 114
    assert table("kNextLps") == jpeg._NEXT_LPS and table("kNextMps") == jpeg._NEXT_MPS
    assert jpeg._QE[113] == 0x5A1D and jpeg._NEXT_MPS[113] == 113      # the fixed 0.5 bin


@pytest.fixture(scope="module")
def libjpeg_writer():
    import os
    import shutil
    import sys

    if shutil.which("gcc") is None or not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("gcc and libjpeg's headers are needed to write these JPEGs")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
    from make_image_fixtures import LibjpegWriter

    writer = LibjpegWriter()
    yield writer
    writer.close()


@pytest.mark.parametrize("height", [1, 7, 9, 16, 17, 24, 25, 33, 41, 48, 49])
@pytest.mark.parametrize("sampling", ["gray 2x2", "gray 1x1", "4:2:0", "1x4 luma"])
def test_block_smoothing_equals_pillow_at_every_edge(libjpeg_writer, height, sampling):
    """Progressive scans cut at Al 1 leave the low ACs unrefined, and
    libjpeg smooths the blocks from a 5 x 5 window of DC values. Heights
    that end the image one, two or more block rows into an iMCU row (the
    window's edges), with one and with several block rows per iMCU row."""
    from coma_tpu_torch.utils import jpeg

    rng = np.random.default_rng(height)
    image = np.clip(seeded_image((height, 29), height, "smooth").astype(np.int64)
                    + rng.integers(-40, 40, (height, 29, 3)), 0, 255).astype(np.uint8)
    space, factors = {"gray 2x2": ("gray", "2x2"), "gray 1x1": ("gray", "1x1"),
                      "4:2:0": ("ycc", "2x2,1x1,1x1"), "1x4 luma": ("ycc", "1x4,1x1,1x1")}[sampling]
    if space == "gray":
        image = image[..., 0]
    data = libjpeg_writer(image, space=space, progression=2, sampling=factors)
    frame = jpeg.decode_coefficients(data, "x", native=False)
    assert jpeg.smoothing_wanted(frame)
    got = jpeg.reconstruct(frame, native=False)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got[..., 0] if got.shape[-1] == 1 else got, want)
