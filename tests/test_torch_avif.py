"""The port's AVIF reader (``utils/heif.py``, ``utils/avif.py`` and the AV1
decoder of ``native/src/av1_decode.cpp``) against Pillow 12.1.0 (libavif
1.3.0 over dav1d 1.5.1 and libyuv 1909), bit for bit, with no tolerance:

- every AVIF fixture of ``tests/data/images`` in modes None, RGB and L
  through ``read_image``, against Pillow now and the manifest's hashes:
  coded-lossless frames (4:4:4, 4:2:2, 4:2:0 and 4:0:0 at full and limited
  range and odd sizes, RGBA with premultiplied and limited-range alpha,
  several tiles of uniform and explicit spacing, 128 x 128 superblocks,
  each aom tool switched off, no CDF update, a full sequence header, the
  BT.709, BT.2020 and identity matrices, the 2048 x 1536 atlas) and lossy
  ones as Pillow writes them (qualities 99, 90, 75 and 30, which are the
  four coefficient q contexts; speeds 5, 6, 7 and 10; transforms of 4 to
  64 points of both intra transform sets, 4:1 ones (4 x 16 to 32 x 8, at
  speed 4 without loop restoration) among them; TX_MODE_SELECT; delta q; the
  deblocking filter with and without sharpness; the four samplings at odd
  sizes; a lossy alpha item; tiles; 128 x 128 superblocks; the atlas) and
  restored ones (CDEF at cdef_bits 0 to 3 in the four samplings, with
  128 x 128 superblocks and tiles; Wiener, self-guided and switchable loop
  restoration on luma and chroma, mixed per plane, at qualities 30 and 90,
  over tiles; CDEF with restoration; 16 x 64 and 64 x 16 transforms; a
  restored alpha item; the atlas at speed 4) and screen content (palette
  mode at every palette size in luma and chroma in 4:2:0, 4:2:2 and 4:4:4
  and in a 4:0:0 alpha item, lossy and coded-lossless; intra block copy in
  luma and chroma, from half-sample chroma positions, with its var-tx
  splits and inter transform types, the loop filters off, with 128 x 128
  superblocks and over tiles; screen content without intra block copy;
  speeds 0 to 2 and 10; the atlas of flat shapes and text) and quantizer
  matrices and film grain (aom's still-image tune=iq in 4:2:0, 4:4:4 and
  RGBA, enable-qm at every level 0 to 14 on luma and chroma, with CDEF,
  loop restoration and 64-point and 4:1 transforms, over palettes and
  intra block copy, a coded-lossless frame at level 15, a qm_v of its own
  under separate_uv_delta_q; aom's 16 film-grain-test vectors, grain
  tables of AR lags 0 and 1, grain in 4:4:4, 4:2:2 and 4:0:0, clipped to
  restricted range, in an alpha item, from aom's denoiser, and both tools
  in one file and in the atlas);
- each tile's symbol decoder ends on the specification's padding (its exit
  process), on every fixture;
- the files Pillow reads and the port refuses, refused naming the file,
  "AVIF" and what is not read;
- truncated and damaged files, lossless, lossy, restored, screen content
  and film grain,
  each in a process of its own under a time limit: Pillow's array or a
  ``ValueError`` naming the file, never a crash or a hang;
- an OBJ whose materials take the flat and decal screen-content textures,
  and one whose materials take the tune=iq and denoised textures, loaded
  as ``coma_tpu`` loads them;
- every alpha value through libavif's limited-to-full mapping and libyuv's
  unattenuation, on files written here;
- the vectorised chroma upsampling against a row-by-row transcription of
  libyuv's C rows, and a failed native build raising with the compiler's
  stderr.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from coma_tpu_torch import native
from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import avif
from coma_tpu_torch.utils.image_io import read_image
from coma_tpu_torch.utils.modes import FormatNotRead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (array_sha, avif_alpha_limited, avif_file,  # noqa: E402
                                 avif_refused_files)

with open(os.path.join(FIXTURES, "manifest.json")) as _fh:
    ENTRIES = [e for e in json.load(_fh)["files"] if e["file"].endswith(".avif")]
NAMES = [e["file"] for e in ENTRIES]
MODES = (None, "RGB", "L")
CASE_SECONDS = 60


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        return fh.read()


def test_fixtures_cover_the_slice():
    kinds = " ".join(e["kind"] for e in ENTRIES)
    for word in ("4:4:4", "4:2:2", "4:2:0", "4:0:0", "full range", "limited range", "RGBA",
                 "two tile columns", "two by two tiles", "128 x 128 superblocks",
                 "Exif orientation", "identity", "bt709", "bt2020", "speed 0", "speed 10",
                 "disable_cdf_update", "explicit (non-uniform) spacing", "full sequence header",
                 "premultiplied alpha", "limited-range alpha item", "2048 x 1536 atlas") + tuple(f"{s}=0" for s in (
                     "enable-cfl-intra", "enable-filter-intra", "enable-intra-edge-filter",
                     "enable-smooth-intra", "enable-paeth-intra", "enable-angle-delta")):
        assert word in kinds, word
    for word in ("AVIF lossy, quality 99", "quality 90", "quality 75", "quality 30",
                 "aom speed 5", "aom speed 7", "aom speed 10", "AVIF lossy 4:4:4",
                 "AVIF lossy 4:2:2", "AVIF lossy 4:2:0", "AVIF lossy 4:0:0", "lossy alpha item",
                 "deltaq-mode=3", "reduced-tx-type-set=1", "sharpness=4",
                 "chair texture, AVIF lossy", "2048 x 1536 atlas, AVIF lossy",
                 "4 x 16, 16 x 4, 8 x 32 and 32 x 8 transforms, deblocked"):
        assert word in kinds, word
    for word in ("AVIF lossy 4:4:4, odd size, CDEF", "AVIF lossy 4:2:2, odd size, CDEF",
                 "AVIF lossy 4:2:0, odd size, CDEF", "AVIF lossy 4:0:0, odd size, CDEF",
                 "cdef_bits 1", "cdef_bits 2", "CDEF with 128 x 128 superblocks",
                 "CDEF over two by two tiles", "Wiener restoration on every plane",
                 "self-guided restoration on every plane", "mixed per plane",
                 "quality 30, aom speed 4, loop restoration",
                 "quality 90, aom speed 4, loop restoration", "loop restoration over two by two",
                 "aom speed 0, CDEF with loop restoration", "a restored alpha item",
                 "chair texture, AVIF lossy, aom speed 0", "atlas, AVIF lossy, aom speed 4",
                 "switchable loop restoration", "cdef_bits 3",
                 "16 x 64 and 64 x 16 transforms"):
        assert word in kinds, word
    for word in ("a flat 4-colour texture at Pillow's defaults", "AVIF screen content 4:4:4, a "
                 "posterised gradient at quality 90", "AVIF screen content 4:2:2, a posterised",
                 "coded-lossless (quality 100), palette", "squares of 2 to 8 colours",
                 "a palette in the alpha item", "tune-content=screen with enable-intrabc=0",
                 "4:2:0, lines of letters at quality 75", "4:4:4, lines of letters at quality 75",
                 "4:2:0, lines of letters at quality 100", "4:4:4, lines of letters at quality 100",
                 "intra block copy with 128 x 128 superblocks",
                 "intra block copy over two tile columns", "AVIF screen content, lines of "
                 "letters, aom speed 0", "aom speed 1", "aom speed 2", "lines of letters, aom "
                 "speed 10", "chair texture, AVIF screen content, flat colours",
                 "chair texture, AVIF screen content, a decal of letters",
                 "2048 x 1536 atlas, AVIF screen content",
                 "residuals over intra block copy in var-tx blocks"):
        assert word in kinds, word
    for word in ("aom tune=iq at Pillow's defaults 4:2:0", "AVIF quantizer matrices 4:4:4",
                 "AVIF quantizer matrices RGBA", "at aom speed 4, CDEF and loop restoration",
                 "64-point transforms", "separate_uv_delta_q", "intra block copy",
                 "coded-lossless with enable-qm=1", "AVIF film grain 4:4:4",
                 "AVIF film grain 4:2:2", "AVIF film grain 4:0:0", "film-grain-table",
                 "clip_to_restricted_range", "grain in the alpha item", "a denoised photograph",
                 "AVIF quantizer matrices and film grain", "chair texture, AVIF quantizer",
                 "chair texture, AVIF film grain", "2048 x 1536 atlas, AVIF quantizer matrices") + \
            tuple(f"qm-min = qm-max = {level}" for level in range(15)) + \
            tuple(f"film-grain-test {vector}" for vector in range(1, 17)):
        assert word in kinds, word
    assert len(ENTRIES) == 155 and not any(e.get("raises") for e in ENTRIES)


@pytest.mark.parametrize("entry", ENTRIES, ids=NAMES)
def test_fixture_equals_pillow(entry):
    """Modes None, RGB and L equal Pillow's arrays now and the manifest's
    hashes; Pillow's mode."""
    path = os.path.join(FIXTURES, entry["file"])
    with Image.open(path) as im:
        im.load()
        want = {m: np.asarray(im if m is None else im.convert(m)) for m in MODES}
        assert im.mode == entry["mode"]
    for m in MODES:
        got = read_image(path, m)
        assert got.dtype == want[m].dtype and got.shape == want[m].shape, m
        np.testing.assert_array_equal(got, want[m])
        assert array_sha(got) == entry["sha256"][str(m)], m


@pytest.mark.parametrize("name", NAMES)
def test_every_tile_ends_on_the_specifications_padding(name):
    """exit_symbol: each tile's trailing one bit where the symbol decoder
    stopped, zeros after it: the decoder read exactly the symbols aom
    wrote. A check of the stream's decoding, not a refusal of the reader."""
    image, color, alpha = avif.decode_avif_planes(fixture(name), name)
    for info, _, padding in (color,) + ((alpha,) if alpha else ()):
        assert len(padding) == info["tiles"] and padding.all(), (name, padding)


def test_what_the_fixtures_exercise():
    """The tiles, superblock sizes, samplings and alpha items the fixtures
    reach in the decoder (what aom chose for each)."""
    seen = {}
    for name in NAMES:
        image, (info, planes, _), alpha = avif.decode_avif_planes(fixture(name), name)
        seen[name] = (info["tiles"], info["use_128x128_superblock"], len(planes), bool(alpha),
                      info["subsampling_x"], info["subsampling_y"], info["disable_cdf_update"],
                      info["uniform_tile_spacing_flag"], info["reduced_still_picture_header"],
                      image.premultiplied, alpha[0]["color_range"] if alpha else None)
    assert seen["avif_tile_cols.avif"][0] == 2 and seen["avif_tiles_2x2.avif"][0] == 4
    assert seen["avif_sb128.avif"][1] == 1 and seen["avif_speed0.avif"][1] == 1
    assert seen["avif_400_45x31.avif"][2] == 1 and seen["avif_rgba_420.avif"][3]
    assert seen["avif_rgba_400_limited.avif"][2:4] == (1, True)
    assert seen["avif_422_43x29.avif"][4:6] == (1, 0)
    assert seen["atlas_lossless_2048x1536.avif"][:2] == (8, 1)
    assert seen["avif_no_cdf_update.avif"][6] == 1
    assert seen["avif_explicit_tiles.avif"][0] == 2 and seen["avif_explicit_tiles.avif"][7] == 0
    assert seen["avif_full_sequence_header.avif"][8] == 0
    assert sum(s[8] for s in seen.values()) == len(seen) - 1      # the rest: reduced headers
    assert [n for n, s in seen.items() if s[9]] == ["avif_rgba_premultiplied.avif"]
    assert [n for n, s in seen.items() if s[10] == 0] == ["avif_rgba_limited_alpha.avif"]


TX_64 = ("TX_64X64", "TX_32X64", "TX_64X32")
TX_4TO1 = ("TX_4X16", "TX_16X4", "TX_8X32", "TX_32X8")
TX_NAMES = codecs.TX_NAMES


def test_what_the_lossy_fixtures_exercise():
    """The header facts each lossy fixture is there for (q context,
    reduced_tx_set, TX_MODE_SELECT, a non-zero loop filter level and
    sharpness, delta q), what the decoder reached in it (the transform sizes
    that coded coefficients, 64-point ones included, the intra transform
    types, the deblocked edges), and the lossless fixtures untouched by
    either."""
    facts = {}
    for name in NAMES:
        _, (info, _, _), alpha = avif.decode_avif_planes(fixture(name), name)
        sizes = {t for k, t in enumerate(TX_NAMES) if info["tx_sizes"] >> k & 1}
        facts[name] = dict(info, sizes=sizes, alpha=alpha and alpha[0])
    lossy = [n for n in NAMES if "lossy" in n]
    assert len(lossy) == 20
    for name in set(NAMES) - set(lossy) - set(RESTORED) - set(SCREEN) - set(QM_GRAIN):  # WHT
        f = facts[name]
        assert f["base_q_idx"] == 0 and f["sizes"] <= {"TX_4X4"} and f["deblocked_edges"] == 0
    assert [facts[f"avif_lossy_q{q}_96x72.avif"]["q_context"] for q in (99, 90, 75, 30)] == \
        [0, 1, 2, 3]
    assert [facts[f"avif_lossy_q{q}_96x72.avif"]["base_q_idx"] for q in (99, 90, 75, 30)] == \
        [4, 24, 64, 176]
    assert facts["avif_lossy_q90_96x72.avif"]["loop_filter_level_0"] == 0
    assert facts["avif_lossy_q90_96x72.avif"]["deblocked_edges"] == 0
    for name in ("avif_lossy_q75_96x72.avif", "avif_lossy_q30_96x72.avif", "chair_lossy.avif",
                 "atlas_lossy_2048x1536.avif"):
        assert facts[name]["loop_filter_level_0"] > 0 and facts[name]["deblocked_edges"] > 0
    assert facts["avif_lossy_sharpness.avif"]["loop_filter_sharpness"] == 4
    assert [n for n in lossy if facts[n]["reduced_tx_set"]] == ["avif_lossy_reduced_tx_set.avif"]
    assert [n for n in lossy if facts[n]["delta_q_present"]] == ["avif_lossy_deltaq.avif"]
    assert facts["avif_lossy_deltaq.avif"]["delta_q_max"] > 0
    assert facts["atlas_lossy_2048x1536.avif"]["tx_mode_select"] == 1     # Pillow's defaults
    assert facts["avif_lossy_q75_96x72.avif"]["tx_mode_select"] == 0       # TX_MODE_LARGEST
    assert not any(facts[n]["enable_cdef"] for n in lossy)
    assert set(TX_64) <= facts["avif_lossy_speed5_224x160.avif"]["sizes"]
    assert set(TX_4TO1) <= facts["avif_lossy_tx4to1_224x160.avif"]["sizes"]
    assert facts["avif_lossy_tx4to1_224x160.avif"]["deblocked_edges"] > 0
    reached = set().union(*(facts[n]["sizes"] for n in lossy))
    assert {"TX_4X4", "TX_8X8", "TX_16X16", "TX_32X32", "TX_4X8", "TX_8X16", "TX_16X32",
            "TX_32X16"} | set(TX_64) | set(TX_4TO1) <= reached
    assert not reached & {"TX_16X64", "TX_64X16"}        # only restored fixtures reach them
    types = 0
    for name in lossy:
        types |= facts[name]["tx_types"]
    assert {t for t in range(16) if types >> t & 1} >= {0, 1, 2, 3, 9, 10, 11}  # both sets
    alpha = facts["avif_lossy_rgba.avif"]["alpha"]
    assert alpha["base_q_idx"] > 0 and alpha["deblocked_edges"] > 0
    assert facts["avif_lossy_tiles_2x2.avif"]["tiles"] == 4
    assert facts["avif_lossy_sb128.avif"]["use_128x128_superblock"] == 1


RESTORED = [n for n in NAMES if "restored" in n]
SCREEN = [e["file"] for e in ENTRIES if "screen content" in e["kind"]]
QM_GRAIN = [e["file"] for e in ENTRIES if "quantizer matrices" in e["kind"]
            or "film grain" in e["kind"]]
RESTORATION_TYPES = {"none": codecs.RESTORE_NONE, "wiener": codecs.RESTORE_WIENER,
                     "sgrproj": codecs.RESTORE_SGRPROJ, "switchable": codecs.RESTORE_SWITCHABLE}


def _restoration(info: dict) -> tuple:
    """(FrameRestorationType per plane by name, Wiener units per plane,
    self-guided units per plane) of a frame; a 4:0:0 frame has plane 0 only."""
    names = {v: k for k, v in RESTORATION_TYPES.items()}
    planes = 1 if info["mono_chrome"] else 3
    return (tuple(names[info[f"restoration_type_{p}"]] for p in range(planes)),
            tuple(info[f"wiener_units_{p}"] for p in range(planes)),
            tuple(info[f"sgrproj_units_{p}"] for p in range(planes)))


def test_what_the_restored_fixtures_exercise():
    """What each restored fixture is there for, from the header (cdef_bits,
    each plane's FrameRestorationType) and the decoder's counters (8 x 8
    blocks CDEF filtered, Wiener and self-guided units per plane): CDEF in
    each of the four samplings, at cdef_bits 0 to 3, with 128 x 128
    superblocks and tiles; Wiener and self-guided units on luma and on
    chroma; both in a switchable frame; 16 x 64 and 64 x 16 transforms; a
    restored alpha item; and the lossless, lossy and screen content
    fixtures with neither CDEF nor restoration."""
    facts, alphas = {}, {}
    for name in NAMES:
        _, (info, _, _), alpha = avif.decode_avif_planes(fixture(name), name)
        facts[name] = info
        alphas[name] = alpha and alpha[0]
    assert len(RESTORED) == 22
    for name in set(NAMES) - set(RESTORED) - set(QM_GRAIN):
        f = facts[name]
        assert f["cdef_blocks"] == 0 and _restoration(f)[0] == ("none",) * len(_restoration(f)[0])
        assert not any(_restoration(f)[1] + _restoration(f)[2]), name
    for tag, sub in (("444", (0, 0)), ("422", (1, 0)), ("420", (1, 1)), ("400", (1, 1))):
        [name] = [n for n in RESTORED if f"cdef_{tag}_" in n]
        f = facts[name]
        assert f["cdef_blocks"] > 0 and (f["subsampling_x"], f["subsampling_y"]) == sub, name
        assert f["mono_chrome"] == (tag == "400") and f["width"] % 2 and f["height"] % 2
    assert {facts[n]["cdef_bits"] for n in RESTORED if facts[n]["cdef_blocks"]} == {0, 1, 2, 3}
    for bits in (1, 3):
        f = facts[f"avif_restored_cdef_bits{bits}.avif"]
        assert f["cdef_bits"] == bits and f["cdef_blocks"] > 0
    assert facts["avif_restored_cdef_bits2_sgrproj.avif"]["cdef_bits"] == 2
    types, wiener, sgr = _restoration(facts["avif_restored_switchable.avif"])
    assert types[0] == "switchable" and wiener[0] > 0 and sgr[0] > 0
    sizes = facts["avif_restored_tx16x64.avif"]["tx_sizes"]
    assert all(sizes >> TX_NAMES.index(t) & 1 for t in ("TX_16X64", "TX_64X16"))
    f = facts["avif_restored_cdef_sb128.avif"]
    assert f["use_128x128_superblock"] == 1 and f["cdef_blocks"] > 0
    f = facts["avif_restored_cdef_tiles_2x2.avif"]
    assert f["tiles"] == 4 and f["cdef_blocks"] > 0
    assert _restoration(facts["avif_restored_wiener.avif"])[0] == ("wiener",) * 3
    assert all(_restoration(facts["avif_restored_wiener.avif"])[1])
    for name in ("avif_restored_sgrproj.avif", "avif_restored_cdef_bits2_sgrproj.avif"):
        types, _, sgr = _restoration(facts[name])
        assert types == ("sgrproj",) * 3 and all(sgr), name
    assert _restoration(facts["avif_restored_mixed_speed4.avif"])[0] == ("none", "wiener",
                                                                         "sgrproj")
    assert _restoration(facts["avif_restored_mixed_speed0.avif"])[0] == ("sgrproj", "wiener",
                                                                         "wiener")
    for name, q in (("avif_restored_q30.avif", 176), ("avif_restored_q90.avif", 24)):
        _, wiener, sgr = _restoration(facts[name])
        assert facts[name]["base_q_idx"] == q and sum(wiener + sgr) > 0, name
    f = facts["avif_restored_tiles_2x2.avif"]
    assert f["tiles"] == 4 and f["restoration_unit_size_0"] == 128    # units across tile edges
    assert _restoration(f)[1][0] >= 2
    for name in ("avif_restored_cdef_lr_270x150.avif", "chair_restored.avif",
                 "atlas_restored_2048x1536.avif"):
        _, wiener, sgr = _restoration(facts[name])
        assert facts[name]["cdef_blocks"] > 0 and sum(wiener + sgr) > 0, name
    assert facts["atlas_restored_2048x1536.avif"]["tx_sizes"] >> TX_NAMES.index("TX_64X16") & 1
    alpha = alphas["avif_restored_rgba.avif"]
    assert alpha["mono_chrome"] and _restoration(alpha)[1] == (1,)
    colour = [_restoration(facts[n]) for n in RESTORED if not facts[n]["mono_chrome"]]
    for k in (1, 2):                                     # Wiener, self-guided
        assert all(sum(r[k][p] for r in colour) for p in range(3))   # luma and chroma


def _sizes(mask: int) -> list:
    return [n for n in range(2, 9) if mask >> n & 1]


def test_what_the_screen_fixtures_exercise():
    """What each screen-content fixture is there for, from the header
    (allow_screen_content_tools, allow_intrabc, the loop filter levels,
    cdef and restoration) and the decoder's counters: palette sizes 2 to 8
    in luma and chroma in each of 4:2:0, 4:2:2 and 4:4:4, and in a 4:0:0
    alpha item; intrabc blocks in luma and in chroma, from half-sample
    chroma positions in 4:2:0; var-tx splits; no deblocking, CDEF or
    restoration under allow_intrabc; screen content tools with no intrabc;
    128 x 128 superblocks and tiles; lossless and lossy frames; and the
    lossless, lossy and restored fixtures with no screen content tool."""
    facts, alphas = {}, {}
    for name in NAMES:
        _, (info, _, _), alpha = avif.decode_avif_planes(fixture(name), name)
        facts[name] = info
        alphas[name] = alpha and alpha[0]
    assert len(SCREEN) == 23
    for name in set(NAMES) - set(SCREEN) - set(QM_GRAIN):
        assert not facts[name]["allow_screen_content_tools"], name
    for name in SCREEN:
        f = facts[name]
        if f["allow_intrabc"]:
            assert f["deblocked_edges"] == f["cdef_blocks"] == 0, name
            assert not any(f[f"loop_filter_level_{k}"] for k in range(4)), name
            assert not any(f[f"restoration_type_{p}"] for p in range(3)), name
        else:
            assert f["intrabc_blocks"] == 0, name
    for tag, sub in (("420", (1, 1)), ("422", (1, 0)), ("444", (0, 0))):
        f = facts[f"avif_screen_palette_sizes_{tag}.avif"]
        assert (f["subsampling_x"], f["subsampling_y"]) == sub
        assert _sizes(f["palette_y_sizes"]) == _sizes(f["palette_uv_sizes"]) == list(range(2, 9))
    for name in ("avif_screen_flat_420.avif", "chair_flat.avif", "avif_screen_posterised_444.avif",
                 "avif_screen_posterised_422.avif"):
        f = facts[name]
        assert f["palette_y_blocks"] and f["palette_uv_blocks"] and not f["allow_intrabc"], name
    f = facts["avif_screen_flat_lossless.avif"]
    assert f["base_q_idx"] == 0 and f["palette_y_blocks"] and f["palette_uv_blocks"]
    assert facts["avif_screen_flat_420.avif"]["base_q_idx"] == 64          # Pillow's quality 75
    assert facts["avif_screen_flat_420.avif"]["deblocked_edges"] > 0
    alpha = alphas["avif_screen_flat_rgba.avif"]
    assert alpha["mono_chrome"] and alpha["allow_screen_content_tools"]
    assert alpha["palette_y_blocks"] and not alpha["palette_uv_blocks"]
    f = facts["avif_screen_no_intrabc.avif"]
    assert f["allow_screen_content_tools"] and not f["allow_intrabc"] and f["palette_y_blocks"]
    assert f["deblocked_edges"] > 0                      # the loop filter stays on without intrabc
    for q, base in ((75, 64), (100, 0)):
        for tag in ("420", "444"):
            f = facts[f"avif_screen_glyphs_q{q}_{tag}.avif"]
            assert f["base_q_idx"] == base and f["allow_intrabc"], (q, tag)
            assert f["intrabc_blocks"] and f["intrabc_chroma_blocks"] and f["palette_y_blocks"]
    assert facts["avif_screen_glyphs_q75_420.avif"]["intrabc_half_sample"] > 0
    assert facts["avif_screen_glyphs_q75_444.avif"]["intrabc_half_sample"] == 0
    f = facts["avif_screen_glyphs_sb128.avif"]
    assert f["use_128x128_superblock"] and f["intrabc_blocks"] and f["vartx_splits"] > 0
    f = facts["avif_screen_glyphs_tiles.avif"]
    assert f["tiles"] == 2 and f["intrabc_blocks"]
    assert [n for n in SCREEN if "speed" in n and facts[n]["intrabc_blocks"]] == \
        ["avif_screen_speed1.avif", "avif_screen_speed2.avif"]
    assert facts["avif_screen_speed0.avif"]["palette_y_blocks"]
    assert not facts["avif_screen_speed10.avif"]["allow_screen_content_tools"]   # aom's speed 10
    f = facts["chair_decal.avif"]
    assert f["intrabc_blocks"] and f["intrabc_half_sample"] and f["palette_y_blocks"]
    f = facts["atlas_screen_2048x1536.avif"]
    assert f["width"] == 2048 and f["tiles"] == 8 and f["intrabc_blocks"] > 1000
    assert f["palette_y_blocks"] > 1000 and f["vartx_splits"] > 0
    f = facts["avif_screen_glyphs_residual.avif"]
    assert f["intrabc_blocks"] and f["vartx_splits"] > 0
    assert f["tx_types"] == (1 << 6) | (1 << 9)          # FLIPADST_FLIPADST and IDTX, inter sets


def test_obj_with_screen_content_textures_loads_as_coma_tpu(tmp_path, capsys):
    """An OBJ whose materials take the flat (palette) and decal (intra
    block copy) AVIF textures: every layer equal to ``coma_tpu``'s (PIL's
    decode and bilinear resize), none left at its Kd colour, no warning."""
    from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
    from coma_tpu_torch.geometry.mesh import load_obj_textured

    names = ["chair_flat.avif", "chair_decal.avif", "avif_screen_flat_420.avif"]
    for name in names:
        (tmp_path / name).write_bytes(fixture(name))
    (tmp_path / "m.mtl").write_text("".join(f"newmtl m{k}\nKd 0.1 0.9 0.2\nmap_Kd {n}\n"
                                            for k, n in enumerate(names)))
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    + "".join(f"usemtl m{k}\nf 1/1 2/1 3/1\n"
                                              for k in range(len(names))))
    got = load_obj_textured(str(tmp_path / "a.obj"), tex_size=32)
    assert "WARNING" not in capsys.readouterr().out
    want = j_load_obj_textured(str(tmp_path / "a.obj"), tex_size=32)
    np.testing.assert_array_equal(got.face_material, want.face_material)
    assert len(got.textures) == len(want.textures) == len(names) + 1
    np.testing.assert_array_equal(got.textures, want.textures)
    for layer in got.textures[1:]:
        assert not np.allclose(layer, [0.1, 0.9, 0.2])


def _qm_levels(info: dict, plane_type: int) -> set:
    """The quantizer matrix levels that weighted a coded transform block of
    luma (``plane_type`` 0) or chroma (1), at any size."""
    planes = (0,) if plane_type == 0 else (1, 2)
    return {level for p in planes for t in TX_NAMES for level in range(15)
            if info[f"qm_levels_{p}_{t}"] >> level & 1}


def _qm_sizes(info: dict) -> set:
    """The transform sizes a quantizer matrix weighted, in any plane."""
    return {t for p in range(3) for t in TX_NAMES if info[f"qm_levels_{p}_{t}"]}


def _grain_sampling(info: dict) -> str:
    """The sampling the film grain ran at ("" where it ran on no plane)."""
    if not info["grain_planes"]:
        return ""
    if info["mono_chrome"]:
        return "4:0:0"
    return {(0, 0): "4:4:4", (1, 0): "4:2:2", (1, 1): "4:2:0"}[
        (info["grain_subsampling_x"], info["grain_subsampling_y"])]


def test_what_the_qm_grain_fixtures_exercise():
    """What each quantizer-matrix and film-grain fixture is there for, from
    the header (using_qmatrix, qm_y/u/v, separate_uv_delta_q, the grain
    parameters) and the decoder's counters (the levels weighted per plane
    and transform size, the transform blocks left unweighted, the planes the
    grain ran on and its sampling): levels 0 to 14 on luma and on chroma,
    level 15 on the lossless frame, weighted 64-point and 4:1 sizes and an
    unweighted 1-D or IDTX type, a qm_v of its own, matrices under CDEF,
    loop restoration, palettes and intra block copy and in an alpha item;
    AR lags 0 to 3, chroma scaling from luma, overlap on and off, clipping
    to restricted range, grain at 4:2:0, 4:2:2, 4:4:4 and 4:0:0 and in an
    alpha item; and no earlier fixture with either tool."""
    facts, alphas = {}, {}
    for name in NAMES:
        _, (info, _, _), alpha = avif.decode_avif_planes(fixture(name), name)
        facts[name] = info
        alphas[name] = alpha and alpha[0]
    assert len(QM_GRAIN) == 54
    for name in set(NAMES) - set(QM_GRAIN):
        f = facts[name]
        assert not f["using_qmatrix"] and not f["apply_grain"] and not _qm_sizes(f), name
        assert f["grain_planes"] == 0 and f["grain_subsampling_x"] == -1, name
    qm = [n for n in QM_GRAIN if facts[n]["using_qmatrix"]]
    grain = [n for n in QM_GRAIN if facts[n]["grain_planes"]]
    assert set(qm) | set(grain) == set(QM_GRAIN)
    for plane_type in (0, 1):
        assert set().union(*(_qm_levels(facts[n], plane_type) for n in qm)) == set(range(15))
    for level in range(15):
        f = facts[f"avif_qm_level{level}.avif"]
        assert (f["qm_y"], f["qm_u"], f["qm_v"]) == (level,) * 3
        assert _qm_levels(f, 0) == _qm_levels(f, 1) == {level}
    f = facts["avif_qm_lossless.avif"]
    assert f["using_qmatrix"] and f["base_q_idx"] == 0 and f["qm_y"] < 15
    assert not _qm_sizes(f) and f["qm_unweighted_blocks"] == 0          # SegQMLevel 15
    sizes = set().union(*(_qm_sizes(facts[n]) for n in qm))
    assert {"TX_64X64", "TX_4X16", "TX_16X4"} <= sizes
    assert "TX_64X64" in _qm_sizes(facts["avif_qm_speed5_tx64.avif"])
    f = facts["avif_qm_speed4_cdef_lr.avif"]
    assert f["cdef_blocks"] and sum(f[f"sgrproj_units_{p}"] + f[f"wiener_units_{p}"]
                                    for p in range(3))
    assert _qm_sizes(f) & {"TX_4X16", "TX_16X4", "TX_8X32", "TX_32X8"}
    assert sum(facts[n]["qm_unweighted_blocks"] for n in qm) > 0        # 1-D types and IDTX
    f = facts["avif_qm_separate_uv.avif"]
    assert f["separate_uv_delta_q"] and (f["qm_y"], f["qm_u"], f["qm_v"]) == (11, 11, 3)
    assert all(f[f"qm_levels_2_{t}"] in (0, 1 << 3) for t in TX_NAMES)
    assert [n for n in NAMES if facts[n]["separate_uv_delta_q"]] == ["avif_qm_separate_uv.avif"]
    f = facts["avif_qm_screen.avif"]
    assert f["palette_y_blocks"] and f["intrabc_blocks"] and _qm_levels(f, 0)
    alpha = alphas["avif_qm_iq_rgba.avif"]
    assert alpha["mono_chrome"] and _qm_levels(alpha, 0)
    for name in ("avif_qm_iq_420.avif", "avif_qm_iq_444.avif", "chair_iq.avif"):
        assert _qm_levels(facts[name], 0) and _qm_levels(facts[name], 1), name
    assert {facts[n]["ar_coeff_lag"] for n in grain} == {0, 1, 2, 3}
    assert facts["avif_grain_table_lag0.avif"]["ar_coeff_lag"] == 0
    assert facts["avif_grain_table_lag1.avif"]["ar_coeff_lag"] == 1
    for vector in range(1, 17):
        [name] = [n for n in grain if n.startswith(f"avif_grain_test{vector}_")]
        assert _grain_sampling(facts[name]) == "4:2:0", name
    assert {_grain_sampling(facts[n]) for n in grain} == {"4:2:0", "4:2:2", "4:4:4", "4:0:0"}
    for tag, sampling in (("444", "4:4:4"), ("422", "4:2:2"), ("400", "4:0:0")):
        names = [n for n in grain if n.startswith(f"avif_grain_{tag}_")]
        assert len(names) == 2 and all(_grain_sampling(facts[n]) == sampling for n in names)
    assert facts["avif_grain_400_test2.avif"]["grain_planes"] == 1
    assert any(facts[n]["chroma_scaling_from_luma"] and facts[n]["grain_planes"] == 7
               for n in grain)
    assert {facts[n]["overlap_flag"] for n in grain} == {0, 1}
    assert [n for n in grain if facts[n]["clip_to_restricted_range"]] == \
        ["avif_grain_limited_test3.avif"]
    assert any(facts[n]["num_y_points"] and not facts[n]["num_cb_points"] and
               facts[n]["grain_planes"] == 1 for n in grain)             # luma only
    alpha = alphas["avif_grain_rgba.avif"]
    assert alpha["mono_chrome"] and alpha["grain_planes"] == 1
    for name in ("avif_grain_denoised.avif", "chair_grain.avif"):
        assert facts[name]["grain_planes"] == 7 and facts[name]["ar_coeff_lag"] == 3, name
    for name in ("avif_qm_grain_both.avif", "atlas_iq_grain_2048x1536.avif"):
        assert facts[name]["grain_planes"] and _qm_levels(facts[name], 0), name


def test_obj_with_qm_and_grain_textures_loads_as_coma_tpu(tmp_path, capsys):
    """An OBJ whose materials take a tune=iq texture (quantizer matrices)
    and denoised photographs (aom's denoiser, film grain): every layer
    equal to ``coma_tpu``'s (PIL's decode and bilinear resize), none left at
    its Kd colour, no warning."""
    from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
    from coma_tpu_torch.geometry.mesh import load_obj_textured

    names = ["chair_iq.avif", "avif_grain_denoised.avif", "chair_grain.avif",
             "avif_qm_grain_both.avif"]
    for name in names:
        (tmp_path / name).write_bytes(fixture(name))
    (tmp_path / "m.mtl").write_text("".join(f"newmtl m{k}\nKd 0.1 0.9 0.2\nmap_Kd {n}\n"
                                            for k, n in enumerate(names)))
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    + "".join(f"usemtl m{k}\nf 1/1 2/1 3/1\n"
                                              for k in range(len(names))))
    got = load_obj_textured(str(tmp_path / "a.obj"), tex_size=32)
    assert "WARNING" not in capsys.readouterr().out
    want = j_load_obj_textured(str(tmp_path / "a.obj"), tex_size=32)
    np.testing.assert_array_equal(got.face_material, want.face_material)
    assert len(got.textures) == len(want.textures) == len(names) + 1
    np.testing.assert_array_equal(got.textures, want.textures)
    for layer in got.textures[1:]:
        assert not np.allclose(layer, [0.1, 0.9, 0.2])


REFUSED = avif_refused_files()


@pytest.mark.parametrize("word", sorted(REFUSED))
def test_refused_naming_the_file_and_what_is_not_read(tmp_path, word):
    path = tmp_path / "refused.avif"
    path.write_bytes(REFUSED[word])
    with Image.open(path) as im:
        im.load()                               # Pillow reads it
    with pytest.raises(FormatNotRead, match=rf"refused\.avif: AVIF: .*{word}") as err:
        read_image(str(path), "RGB")
    assert err.value.format == "AVIF"


def test_grid_primary_item_refused(tmp_path):
    """A ``grid`` primary item (the file's item type rewritten; Pillow's
    writer makes no grid) is refused by name."""
    data = fixture("avif_420_47x35.avif")
    at = data.index(b"av01", data.index(b"infe"))
    path = tmp_path / "grid.avif"
    path.write_bytes(data[:at] + b"grid" + data[at + 4:])
    with pytest.raises(FormatNotRead, match=r"grid\.avif: AVIF: .*a grid primary item"):
        read_image(str(path))


def test_ispe_other_than_the_frame_refused(tmp_path):
    """An ``ispe`` that is not the AV1 frame's size: Pillow reads the frame
    resized to it (libavif's scaling), which the port does not do; refused
    by name."""
    data = bytearray(fixture("avif_420_47x35.avif"))
    at = data.index(b"ispe") + 8
    data[at:at + 4] = (48).to_bytes(4, "big")
    path = tmp_path / "ispe.avif"
    path.write_bytes(bytes(data))
    with Image.open(path) as im:
        im.load()
        assert im.size == (48, 35)
    with pytest.raises(FormatNotRead, match=r"ispe\.avif: AVIF: .*an ispe of 48 x 35 over an AV1 "
                                            r"frame of 47 x 35"):
        read_image(str(path))


def _rgba_of_every_alpha(seed: int) -> np.ndarray:
    """Seeded colour over every alpha value, one row each (256 x 24)."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (256, 24, 3)).astype(np.uint8)
    alpha = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 24, 1)
    return np.concatenate([rgb, alpha], -1)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_premultiplied_alpha_at_every_value(tmp_path, subsampling):
    """A prem reference: the colour taken back through libyuv's
    ``ARGBUnattenuate`` table at each of the 256 alpha values, as Pillow
    reads it."""
    path = tmp_path / "prem.avif"
    path.write_bytes(avif_file(_rgba_of_every_alpha(700), quality=100, subsampling=subsampling,
                               alpha_premultiplied=True))
    assert avif.heif.parse_avif(path.read_bytes(), "prem").premultiplied
    np.testing.assert_array_equal(read_image(str(path)), _pillow(str(path)))


def test_lossy_premultiplied_colour_over_its_alpha(tmp_path):
    """Lossy coding of a premultiplied file leaves colours above their alpha;
    over an alpha of 1 a colour of 128 or more passes 16 signed bits in
    libyuv's SIMD unattenuation and comes back 0, as Pillow reads it."""
    alpha = np.where(np.random.default_rng(700).random((96, 128, 1)) < 0.5, 0, 255)
    rgba = np.concatenate([np.full((96, 128, 3), 230), alpha], -1).astype(np.uint8)
    path = tmp_path / "prem_lossy.avif"
    path.write_bytes(avif_file(rgba, quality=3, speed=9, alpha_premultiplied=True))
    got = read_image(str(path))
    np.testing.assert_array_equal(got, _pillow(str(path)))
    _, (info, planes, _), (_, alpha, _) = avif.decode_avif_planes(path.read_bytes(), "prem")
    rgb = codecs.yuv_to_rgb(planes, info["subsampling_x"], info["subsampling_y"],
                            avif.LIBYUV_CONSTANTS[("BT.601", info["color_range"])])
    wrapped = (alpha[0] == 1)[..., None] & (rgb >= 128)
    assert wrapped.any() and (got[..., :3][wrapped] == 0).all()


def test_limited_range_alpha_at_every_value(tmp_path):
    """A limited-range alpha item: each of the 256 stored values through
    libavif's ``avifLimitedToFullY``, as Pillow reads it."""
    path = tmp_path / "limited_alpha.avif"
    path.write_bytes(avif_alpha_limited(avif_file(_rgba_of_every_alpha(701), quality=100,
                                                  subsampling="4:4:4")))
    got = read_image(str(path))
    np.testing.assert_array_equal(got, _pillow(str(path)))
    assert got[:16, :, 3].max() == 0 and got[235:, :, 3].min() == 255


def _in_child(path: str) -> subprocess.CompletedProcess:
    """``read_image(path)`` in a process of its own: its shape, or the
    ValueError's message; a crash shows as the return code."""
    code = ("import sys\nfrom coma_tpu_torch.utils.image_io import read_image\n"
            "try:\n    print('shape', read_image(sys.argv[1]).shape)\n"
            "except ValueError as err:\n    print('refused', err)\n")
    return subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                          timeout=CASE_SECONDS, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))


def _pillow(path: str):
    try:
        with Image.open(path) as im:
            im.load()
            return np.asarray(im)
    except Exception:                           # noqa: BLE001 - any refusal of Pillow's
        return None


DAMAGED = ("avif_tiles_2x2.avif", "avif_lossy_tiles_2x2.avif",
           "avif_restored_cdef_lr_270x150.avif", "avif_screen_glyphs_sb128.avif",
           "avif_grain_rgba.avif")
SHAPES = {e["file"]: tuple(e["shape"]) for e in ENTRIES}


@pytest.mark.parametrize("name", DAMAGED)
@pytest.mark.parametrize("k", range(10))
def test_truncated_file_refused_or_equal_never_crashes(tmp_path, k, name):
    """A seeded cut of a fixture (lossless; lossy with its large transforms
    and the deblocking filter; with CDEF and loop restoration, which read
    past unit and stripe edges; screen content, palettes and intra block
    copy; and film grain, whose parameters end the frame header, in both
    items): Pillow's array, or a ValueError
    naming the file (libavif refuses every cut inside the item's data),
    within the time limit and without a crash."""
    data = fixture(name)
    cut = int(np.random.default_rng(500 + k).integers(1, len(data)))
    path = tmp_path / f"cut{k}.avif"
    path.write_bytes(data[:cut])
    result = _in_child(str(path))
    assert result.returncode == 0, result.stderr[-2000:]
    want = _pillow(str(path))
    if want is None:
        assert result.stdout.startswith("refused") and f"cut{k}.avif" in result.stdout, \
            result.stdout
    else:
        np.testing.assert_array_equal(read_image(str(path)), want)


@pytest.mark.parametrize("name", DAMAGED)
@pytest.mark.parametrize("k", range(10))
def test_damaged_tile_data_never_crashes(tmp_path, k, name):
    """Seeded bytes of a fixture's tiles changed: an image of the file's
    size or a ValueError naming the file, within the time limit and without
    a crash (every read of the symbol decoder stays inside its tile; the
    transforms, the predictors, the deblocking filter, CDEF and loop
    restoration stay inside their buffers on damaged coefficients and
    filter parameters, intra block copy inside the frame on a damaged
    displacement, a palette's colour map inside its block, the grain
    synthesis inside its templates on damaged grain parameters)."""
    data = bytearray(fixture(name))
    rng = np.random.default_rng(600 + k)
    start = data.index(b"mdat") + 40
    for at in rng.integers(start, len(data), 1 + k % 4):
        data[at] = int(rng.integers(0, 256))
    path = tmp_path / f"damaged{k}.avif"
    path.write_bytes(bytes(data))
    result = _in_child(str(path))
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.startswith((f"shape {SHAPES[name]}", "refused")), result.stdout
    if result.stdout.startswith("refused"):
        assert f"damaged{k}.avif" in result.stdout and "AVIF" in result.stdout


def _linear_rows(s: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ``ScaleRowUp2_Linear_Any_C``, element by element."""
    d = np.zeros(w, int)
    d[0] = s[0]
    for x in range(((w - 1) & ~1) // 2):
        d[1 + 2 * x] = (3 * int(s[x]) + int(s[x + 1]) + 2) >> 2
        d[2 + 2 * x] = (int(s[x]) + 3 * int(s[x + 1]) + 2) >> 2
    d[w - 1] = s[(w - 1) // 2]
    return d


def _bilinear_rows(s: np.ndarray, t: np.ndarray, w: int) -> tuple:
    """libyuv's ``ScaleRowUp2_Bilinear_Any_C``, element by element."""
    s, t = s.astype(int), t.astype(int)
    da, db = np.zeros(w, int), np.zeros(w, int)
    da[0], db[0] = (3 * s[0] + t[0] + 2) >> 2, (s[0] + 3 * t[0] + 2) >> 2
    for x in range(((w - 1) & ~1) // 2):
        da[1 + 2 * x] = (s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4
        da[2 + 2 * x] = (s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4
        db[1 + 2 * x] = (s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4
        db[2 + 2 * x] = (s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4
    j = (w - 1) // 2
    da[w - 1], db[w - 1] = (3 * s[j] + t[j] + 2) >> 2, (s[j] + 3 * t[j] + 2) >> 2
    return da, db


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (3, 5), (6, 7), (9, 4), (11, 13)])
def test_chroma_upsampling_equals_libyuvs_rows(h, w):
    """``I420ToARGBMatrixBilinear``'s and ``I422ToARGBMatrixLinear``'s row
    order, element by element, against the vectorised upsampling."""
    rng = np.random.default_rng(h * 31 + w)
    c420 = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
    want = [_linear_rows(c420[0], w)]
    k = 0
    while len(want) < h - 1:
        want += list(_bilinear_rows(c420[k], c420[k + 1], w))
        k += 1
    if len(want) < h:
        want.append(_linear_rows(c420[k], w))
    np.testing.assert_array_equal(avif.upsample_chroma(c420, w, h, 1, 1), np.array(want[:h]))
    c422 = rng.integers(0, 256, (h, (w + 1) // 2)).astype(np.uint8)
    np.testing.assert_array_equal(avif.upsample_chroma(c422, w, h, 1, 0),
                                  np.array([_linear_rows(r, w) for r in c422]))


@pytest.mark.parametrize("name", NAMES)
def test_native_and_plain_conversion_agree(name):
    """``native/src/av1_decode.cpp``'s libyuv rows against the numpy twin on
    the fixture's planes, at every matrix and range libavif sends to
    libyuv."""
    _, (info, planes, _), _ = avif.decode_avif_planes(fixture(name), name)
    if len(planes) == 1:
        return
    sx, sy = info["subsampling_x"], info["subsampling_y"]
    for (matrix, full), constants in avif.LIBYUV_CONSTANTS.items():
        np.testing.assert_array_equal(codecs.yuv_to_rgb(planes, sx, sy, constants),
                                      avif.yuv_to_rgb_plain(planes, sx, sy, matrix, full))


def test_failed_build_raises_naming_the_source(tmp_path):
    """The AV1 decoder has no plain fallback: a source that does not build
    raises ``native.BuildError`` naming it, with the compiler's stderr."""
    src = tmp_path / "broken_av1.cpp"
    src.write_text('extern "C" int av1_probe( { return 0; }\n')
    with pytest.raises(native.BuildError, match=r"broken_av1\.cpp: the native build failed: "
                                                r"(?s:.*)error"):
        native.require_library(src, lambda lib: None)


def test_pillow_reports_orientation_and_leaves_the_pixels(tmp_path):
    """Exif orientation 6 is written as an irot property; Pillow reports it
    in its Exif and returns the pixels unturned, as the port does."""
    name = "avif_exif_orientation6.avif"
    with Image.open(os.path.join(FIXTURES, name)) as im:
        assert im.getexif().get(0x0112) == 6
        assert im.size == (39, 27)
    data = fixture(name)
    assert b"irot" in data
    assert read_image(os.path.join(FIXTURES, name)).shape == (27, 39, 3)
