"""Lab images in the port: ``utils/lcms.py`` (Little CMS 2.17's Lab -> sRGB
transform as Pillow 12.1.0 builds it, with its C++ interpolation in
``native/src/image_codecs.cpp``), the Lab PSD and CIELab TIFF readers and
``utils/modes.to_mode``'s "LAB" conversions, against Pillow bit for bit:

- all 2^24 Lab triples to PIL's exact "RGB" bytes, on the native and the
  plain paths;
- Lab PSDs and CIELab TIFFs (both byte orders; raw, LZW, Deflate, PackBits,
  JPEG, Zstandard; strips and tiles): "LAB" arrays, "RGB" equal, "L" refused
  as Pillow refuses it;
- the slice as a whole: ``load_obj_textured`` on an OBJ whose materials take
  JPEG 2000, Lab PSD, CIELab TIFF and PFM textures, against ``coma_tpu``'s.
"""
import io
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
from coma_tpu_torch.geometry import mesh as t_mesh
from coma_tpu_torch.utils import lcms, psd, tiff
from coma_tpu_torch.utils.image_io import read_image
from coma_tpu_torch.utils.modes import Decoded, to_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import psd_file, seeded_rgb, tiff_file  # noqa: E402

NATIVE = shutil.which("g++") is not None


@pytest.fixture(scope="module")
def every_lab():
    """(2^24, 3) uint8 Lab triples (PIL's "LAB" array bytes) and Pillow's
    "RGB" conversion of them."""
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    rgb = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes()).convert("RGB"))
    return lab, rgb.reshape(-1, 3)


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
def test_every_lab_triple_converts_as_pillow(every_lab, native):
    if native and not NATIVE:
        pytest.skip("no g++ on this host: the native codecs cannot be built")
    lab, want = every_lab
    got = lcms.lab_to_rgb(lab, native=native)
    mismatched = np.flatnonzero((got != want).any(-1))
    assert mismatched.size == 0, (mismatched[:5], lab[mismatched[:5]], got[mismatched[:5]],
                                  want[mismatched[:5]])


def test_clut_is_33_nodes_a_side_and_saturates():
    table = lcms.clut().reshape(33, 33, 33, 3)
    assert table.dtype == np.int32 and table.min() >= 0 and table.max() <= 65535
    # L = 100, a = b = 0 (the nodes nearest Lab white) is near sRGB white
    assert (table[32, 16, 16] > 64000).all()
    assert (table[0, 16, 16] < 1000).all()


def test_lab_to_l_is_refused_as_pillow_refuses_it():
    image = Image.frombytes("LAB", (2, 1), bytes([50, 0, 0, 90, 10, 250]))
    with pytest.raises(ValueError):
        image.convert("L")
    decoded = Decoded(np.asarray(image), "LAB")
    with pytest.raises(ValueError, match="LAB to L"):
        to_mode(decoded, "L")
    np.testing.assert_array_equal(to_mode(decoded, "RGB"), np.asarray(image.convert("RGB")))


LAB = np.random.default_rng(400).integers(0, 256, (21, 27, 3)).astype(np.uint8)


def _pil_tiff(lab: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.frombytes("LAB", lab.shape[1::-1], lab.tobytes()).save(buf, "TIFF", **kw)
    return buf.getvalue()


LAB_FILES = {
    "psd_raw.psd": lambda: psd_file(np.ascontiguousarray(LAB.transpose(2, 0, 1)), 9),
    "psd_packbits.psd": lambda: psd_file(np.ascontiguousarray(LAB.transpose(2, 0, 1)), 9,
                                         rle=True),
    "tiff_raw.tif": lambda: _pil_tiff(LAB),
    "tiff_lzw.tif": lambda: _pil_tiff(LAB, compression="tiff_lzw"),
    "tiff_deflate.tif": lambda: _pil_tiff(LAB, compression="tiff_adobe_deflate"),
    "tiff_packbits.tif": lambda: _pil_tiff(LAB, compression="packbits"),
    "tiff_jpeg.tif": lambda: _pil_tiff(LAB, compression="jpeg"),
    "tiff_zstd.tif": lambda: _pil_tiff(LAB, compression="zstd"),
    "tiff_big_endian_raw.tif": lambda: tiff_file(LAB, (8, 8, 8), 8, big_endian=True),
    "tiff_big_endian_deflate_strips.tif": lambda: tiff_file(LAB, (8, 8, 8), 8, compression=8,
                                                            big_endian=True, rows_per_strip=4),
    "tiff_tiles_packbits.tif": lambda: tiff_file(LAB, (8, 8, 8), 8, compression=32773,
                                                 tile=(16, 16)),
    "tiff_predictor.tif": lambda: tiff_file(LAB, (8, 8, 8), 8, compression=8, predictor=2),
    "tiff_rows_past_its_strips.tif": lambda: tiff_file(LAB, (8, 8, 8), 8,
                                                       tags={257: (4, [40])}),
    "tiff_icclab_refused.tif": lambda: tiff_file(LAB, (8, 8, 8), 9),
    "tiff_itulab_refused.tif": lambda: tiff_file(LAB, (8, 8, 8), 10),
    "tiff_lab_with_extra_refused.tif": lambda: tiff_file(
        np.concatenate([LAB, LAB[..., :1]], -1), (8, 8, 8, 8), 8, extra=(0,)),
}


@pytest.mark.parametrize("name", list(LAB_FILES))
def test_lab_files_equal_pillow(tmp_path, name):
    """The "LAB" array, its "RGB" through Little CMS and its refused "L", on
    the plain and native paths (rows no strip covers as Pillow shows them:
    L 0, a and b 128); the Lab photometrics Pillow refuses refused."""
    data = LAB_FILES[name]()
    path = tmp_path / name
    path.write_bytes(data)
    reader = psd.decode_psd if name.endswith(".psd") else tiff.decode_tiff
    try:
        with Image.open(path) as im:
            im.load()
            own, mode = np.asarray(im), im.mode
            rgb = np.asarray(im.convert("RGB"))
    except (OSError, SyntaxError, ValueError):
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(path))
        return
    assert mode == "LAB"
    np.testing.assert_array_equal(read_image(str(path)), own)
    np.testing.assert_array_equal(read_image(str(path), "RGB"), rgb)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        read_image(str(path), "L")
    for native in (False, True) if NATIVE else (False,):
        decoded = reader(data, name, native=native)
        assert decoded.mode == "LAB"
        np.testing.assert_array_equal(decoded.pixels, own)
        np.testing.assert_array_equal(lcms.lab_to_rgb(decoded.pixels, native=native), rgb)


def test_load_obj_textured_reads_the_new_formats(tmp_path):
    """An OBJ whose materials take a lossless JP2, a lossy tiled J2K, a Lab
    PSD, a CIELab TIFF and a PFM: every layer equal to
    ``coma_tpu``'s (PIL's decode and resize), none left at its Kd colour."""
    tex = seeded_rgb((24, 40), 401, noise=10)
    Image.fromarray(tex).save(tmp_path / "a.jp2")
    Image.fromarray(tex[::-1]).save(tmp_path / "b.j2k", irreversible=True, tile_size=(16, 16),
                                    num_resolutions=3, quality_mode="rates",
                                    quality_layers=[10, 4])
    (tmp_path / "c.psd").write_bytes(psd_file(np.ascontiguousarray(tex.transpose(2, 0, 1)), 9,
                                              rle=True))
    (tmp_path / "d.tif").write_bytes(_pil_tiff(tex[:, ::-1], compression="tiff_lzw"))
    (tmp_path / "e.pfm").write_bytes(b"Pf\n40 24\n-1.0\n" + (tex[..., 0].astype("<f4") * 0.9 + 3)
                                     .tobytes())
    names = ["a.jp2", "b.j2k", "c.psd", "d.tif", "e.pfm"]
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
