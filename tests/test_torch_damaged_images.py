"""Damaged JPEG, GIF, TIFF, WebP and BLP files: the port reads what Pillow
recovers and refuses what it refuses.

- every file of ``tests/data/images/damaged/`` (``tools/make_image_fixtures.py
  --damaged``) equal to Pillow's hashes for modes None, RGB and L, or refused
  naming the file, on the native decoders and on the plain ones;
- the plain and native decoders equal on each of them (the JPEGs'
  coefficients too);
- a live seeded fuzz against Pillow (``tools/fuzz_image_readers.py``'s
  damage, at seeds other than its default 0) on the small JPEG, GIF, TIFF,
  WebP and BLP fixtures, and 100 changed scan bytes of a seeded JPEG;
- ``coma_tpu``'s own readers (PIL) against the port's on damaged JPEGs: a
  BEHAVE colour frame and mask, and an OBJ's ``map_Kd`` texture.
"""
from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
from coma_tpu.pipelines import behave_eval as J
from coma_tpu_torch.geometry import mesh as t_mesh
from coma_tpu_torch.native import codecs
from coma_tpu_torch.pipelines import behave_eval as T
from coma_tpu_torch.utils import blp, gif_reader, image_io, jpeg, tiff, webp
from coma_tpu_torch.utils.modes import to_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAMAGED = os.path.join(REPO, "tests", "data", "images", "damaged")
sys.path.insert(0, os.path.join(REPO, "tools"))
import fuzz_image_readers as fuzz  # noqa: E402

with open(os.path.join(DAMAGED, "manifest.json")) as _fh:
    MANIFEST = json.load(_fh)["files"]
SMALL = [e for e in MANIFEST if "stored" not in e]
READERS = {".gif": gif_reader.decode_gif, ".tif": tiff.decode_tiff, ".webp": webp.decode_webp,
           ".blp": blp.decode_blp}


def need_gpp():
    if not (jpeg.native_available() and codecs.available() and codecs.webp_available()):
        pytest.skip("no g++ to build the native decoders")


def blob(entry: dict) -> bytes:
    with open(os.path.join(DAMAGED, entry.get("stored", entry["file"])), "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if entry.get("stored", "").endswith(".gz") else data


def sha(a) -> str:
    a = np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
                          .tobytes()).hexdigest()


@pytest.fixture
def plain(monkeypatch):
    """Every reader on its plain Python decoder (as where g++ is missing)."""
    monkeypatch.setattr(jpeg, "native_available", lambda: False)
    monkeypatch.setattr(codecs, "available", lambda: False)
    monkeypatch.setattr(codecs, "webp_available", lambda: False)
    monkeypatch.setattr(codecs, "bcn_available", lambda: False)


def check_entry(entry: dict) -> None:
    name = entry["file"]
    if entry.get("raises"):
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            image_io.decode_image(blob(entry), name)
        return
    decoded = image_io.decode_image(blob(entry), name)
    for mode in (None, "RGB", "L"):
        assert sha(to_mode(decoded, mode)) == entry["sha256"][str(mode)], (name, mode)


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_damaged_fixture_native(entry):
    """Each damaged file on the native decoders: Pillow's arrays or its refusal."""
    need_gpp()
    check_entry(entry)


@pytest.mark.parametrize("entry", SMALL, ids=[e["file"] for e in SMALL])
def test_damaged_fixture_plain(entry, plain):
    """Each small damaged file on the plain decoders: Pillow's arrays or its refusal."""
    check_entry(entry)


def test_manifest_covers_every_rule():
    """The set is what the fixture tool writes: about 60 small files, each
    under 8 kB but the gzipped atlas, every kind of damage named."""
    names = {e["file"] for e in MANIFEST}
    assert 55 <= len(MANIFEST) <= 80
    assert all(e["bytes"] < 8192 for e in SMALL)
    for needed in ("jpeg_bad_huffman_code.jpg", "jpeg_marker_mid_scan.jpg",
                   "jpeg_resync_far.jpg", "jpeg_resync_earlier.jpg", "jpeg_resync_next.jpg",
                   "jpeg_restart_missing.jpg", "jpeg_restart_duplicated.jpg", "jpeg_no_dht.jpg",
                   "jpeg_not_sequential.jpg", "jpeg_bogus_progression.jpg",
                   "jpeg_arith_bad_code.jpg", "jpeg_extraneous_bytes.jpg",
                   "refused_jpeg_unknown_marker.jpg", "refused_jpeg_undefined_dqt.jpg",
                   "refused_jpeg_pillow_tem.jpg", "refused_gif_truncated.gif",
                   "refused_tiff_raw_truncated.tif", "tiff_deflate_bad_check.tif",
                   "webp_lossless_into_padding.webp", "refused_webp_lossy_short.webp",
                   "tiff_jpeg_strip_marker.tif", "blp1_jpeg_damaged.blp",
                   "atlas_damaged_restart_2048x1536.jpg"):
        assert needed in names
    assert sum(not e.get("raises") for e in MANIFEST) > len(MANIFEST) // 2


@pytest.mark.parametrize("entry", SMALL, ids=[e["file"] for e in SMALL])
def test_plain_and_native_agree(entry):
    """The plain and native decoders give the same on each small damaged
    file: a JPEG's coefficients and pixels, another format's pixels, or
    both refuse."""
    need_gpp()
    name, data = entry["file"], blob(entry)
    ext = os.path.splitext(name)[1]
    outcomes = []
    for native in (False, True):
        try:
            if ext == ".jpg":
                frame = jpeg.decode_coefficients(data, name, native=native)
                outcomes.append((frame.coef, jpeg.reconstruct(frame, native=native)))
            else:
                outcomes.append(([], READERS[ext](data, name, native=native).pixels))
        except ValueError:
            outcomes.append(None)
    plain_out, native_out = outcomes
    assert (plain_out is None) == (native_out is None) == bool(entry.get("raises"))
    if plain_out is not None:
        for a, b in zip(plain_out[0], native_out[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(plain_out[1], native_out[1])


FUZZ_FORMATS = (".jpg", ".gif", ".tif", ".webp", ".blp", ".jp2", ".j2k", ".psd", ".pfm", ".ppm")


@pytest.mark.parametrize("ext", FUZZ_FORMATS)
def test_seeded_fuzz_against_pillow(ext):
    """Three seeded damages (seed 7) of each small fixture of a format read
    by Pillow and by the port: equal arrays or both refuse, every time."""
    need_gpp()
    warnings.simplefilter("ignore")
    rng = np.random.default_rng(7)
    with open(os.path.join(fuzz.FIXTURES, "manifest.json")) as fh:
        files = [e["file"] for e in json.load(fh)["files"]
                 if "stored" not in e and e["bytes"] < 64_000 and e["file"].endswith(ext)]
    diverged = []
    for name in files:
        with open(os.path.join(fuzz.FIXTURES, name), "rb") as fh:
            data = fh.read()
        for trial in range(3):
            damaged = fuzz.damage(data, rng)
            want = fuzz.pillow(damaged)
            if isinstance(want, str) and want == "big":
                continue
            result, message = fuzz.outcome(want, fuzz.port(damaged))
            if result not in fuzz.AGREE:
                diverged.append((name, trial, result, message))
    assert files and not diverged


def test_scan_bytes_against_pillow():
    """One byte of a seeded JPEG's scan changed 100 times (seed 11): the
    port's decode equals Pillow's, or both refuse."""
    need_gpp()
    from make_image_fixtures import seeded_rgb

    buf = io.BytesIO()
    Image.fromarray(seeded_rgb((24, 40), 160)).save(buf, "JPEG", quality=85)
    data = buf.getvalue()
    rng = np.random.default_rng(11)
    diverged, read = [], 0
    for trial in range(100):
        b = bytearray(data)
        b[rng.integers(len(data) // 3, len(data) - 2)] = rng.integers(0, 256)
        result, message = fuzz.outcome(fuzz.pillow(bytes(b)), fuzz.port(bytes(b)))
        read += result == "equal"
        if result not in fuzz.AGREE:
            diverged.append((trial, result, message))
    assert not diverged and read > 50


def write_behave_sequence(root, color: bytes, mask: bytes) -> str:
    seq = os.path.join(root, "Date03_Sub04_chairwood")
    frame = os.path.join(seq, "t0000.000")
    os.makedirs(frame)
    with open(os.path.join(seq, "info.json"), "w") as fh:
        json.dump(dict(cat="chairwood", gender="male", kinects=[0, 1]), fh)
    for kid in range(2):
        with open(os.path.join(frame, f"k{kid}.color.jpg"), "wb") as fh:
            fh.write(color)
        with open(os.path.join(frame, f"k{kid}.person_mask.jpg"), "wb") as fh:
            fh.write(mask)
        Image.fromarray(np.zeros((8, 8), np.uint16)).save(os.path.join(frame,
                                                                       f"k{kid}.depth.png"))
    return seq


def test_behave_reader_on_damaged_frames(tmp_path):
    """``coma_tpu/pipelines/behave_eval.py``'s colour frame and person mask
    reads (PIL) against the port's, on a colour frame with a bad Huffman
    code and a mask with a marker inside its scan."""
    need_gpp()
    by_name = {e["file"]: e for e in MANIFEST}
    mask = Image.open(io.BytesIO(blob(by_name["jpeg_marker_mid_scan.jpg"]))).convert("L")
    buf = io.BytesIO()
    mask.save(buf, "JPEG", quality=90)
    masked = bytearray(buf.getvalue())
    start = masked.index(b"\xff\xda") + 2 + int.from_bytes(masked[masked.index(b"\xff\xda") + 2:
                                                                 masked.index(b"\xff\xda") + 4],
                                                          "big")
    masked[start + (len(masked) - start) // 2:start + (len(masked) - start) // 2] = b"\xff\xd4"
    seq = write_behave_sequence(str(tmp_path), blob(by_name["jpeg_bad_huffman_code.jpg"]),
                                bytes(masked))
    t, j = T.BehaveSequence(seq), J.BehaveSequence(seq)
    for kid in range(2):
        np.testing.assert_array_equal(t.get_color_image(0, kid), j.get_color_image(0, kid))
        for ret_bool in (True, False):
            got, want = t.get_mask(0, kid, "person", ret_bool), j.get_mask(0, kid, "person",
                                                                           ret_bool)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_texture_from_damaged_jpegs(tmp_path):
    """``coma_tpu/geometry/mesh.py``'s ``map_Kd`` read (PIL) against the
    port's ``load_obj_textured``: damaged JPEG textures Pillow recovers (a
    bad code, a wrong RSTn, arithmetic data that overflows) give the same
    layers."""
    need_gpp()
    by_name = {e["file"]: e for e in MANIFEST}
    names = ["jpeg_bad_huffman_code.jpg", "jpeg_resync_next.jpg", "jpeg_arith_bad_code.jpg",
             "jpeg_progressive_marker.jpg"]
    for n in names:
        (tmp_path / n).write_bytes(blob(by_name[n]))
    (tmp_path / "m.mtl").write_text("".join(f"newmtl m{k}\nKd 0.1 0.9 0.2\nmap_Kd {n}\n"
                                            for k, n in enumerate(names)))
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    + "".join(f"usemtl m{k}\nf 1/1 2/1 3/1\n"
                                              for k in range(len(names))))
    got = t_mesh.load_obj_textured(str(tmp_path / "a.obj"), tex_size=16)
    want = j_load_obj_textured(str(tmp_path / "a.obj"), tex_size=16)
    assert len(got.textures) == len(want.textures) == len(names) + 1
    np.testing.assert_array_equal(got.textures, want.textures)
    for layer in got.textures[1:]:
        assert not np.allclose(layer, [0.1, 0.9, 0.2])
