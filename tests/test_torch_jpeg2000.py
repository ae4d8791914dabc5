"""The port's JPEG 2000 reader (``utils/jp2.py`` over ``utils/j2k.py``,
``utils/j2k_t1.py`` and ``utils/j2k_dwt.py``, with its C++ twin
``native/src/j2k_decode.cpp``) against Pillow 12.1.0 with OpenJPEG 2.5.4,
bit for bit, with no tolerance, on the plain and the native paths:

- Pillow-written files at test time: reversible and irreversible, the five
  progressions, resolutions, code-block and precinct sizes, tiles with tile
  and image offsets, quality layers by rate and by dB, no MCT, signed, PLT,
  L, LA, RGB, RGBA and I;16;
- libopenjp2-written files (``tools/make_image_fixtures.openjpeg_encode``,
  through ctypes on Pillow's bundled library): every code-block style and
  some together, reversible and irreversible, POC changes, 4:2:0 and 4:2:2
  components in every progression as codestreams and JP2s, ROI, SOP/EPH,
  precisions from 4 to 16 bits, signed, CMYK, subsampled alpha;
- Pillow's packets repacked into PPM and PPT headers, an HTJ2K code-block
  style (refused naming the format), files cut short or damaged (refused
  where Pillow refuses them);
- the committed fixtures and the two 2048 x 1536 atlases against their
  manifest hashes.
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

from coma_tpu_torch.native import codecs
from coma_tpu_torch.utils import j2k_dwt, j2k_t1, jp2
from coma_tpu_torch.utils.image_io import decode_image, read_image
from coma_tpu_torch.utils.modes import FormatNotRead, to_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_fixtures import (array_sha, jp2_file, openjpeg_encode,  # noqa: E402
                                 repack_headers, seeded_rgb, with_cblk_style)

NATIVE = shutil.which("g++") is not None
PATHS = (False, True) if NATIVE else (False,)
with open(os.path.join(FIXTURES, "manifest.json")) as _fh:
    MANIFEST = {e["file"]: e for e in json.load(_fh)["files"]}
J2K_FIXTURES = sorted(n for n in MANIFEST if n.endswith((".jp2", ".j2k"))
                      and not n.startswith("atlas"))


def pil_j2k(image, **kw) -> bytes:
    buf = io.BytesIO()
    (image if isinstance(image, Image.Image) else Image.fromarray(image)).save(buf, "JPEG2000",
                                                                               **kw)
    return buf.getvalue()


def check(data: bytes, name: str = "case.j2k") -> None:
    """Pillow's array and mode, modes None/RGB/L through ``to_mode``, on
    every path; where Pillow refuses the file, every path refuses it naming
    the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.load()
            want = {m: np.asarray(im if m is None else im.convert(m)) for m in (None, "RGB", "L")}
            mode = im.mode
    except (OSError, SyntaxError, ValueError):
        for native in PATHS:
            with pytest.raises(ValueError, match=re.escape(name)):
                jp2.decode_jp2(data, name, native=native)
        return
    for native in PATHS:
        got = jp2.decode_jp2(data, name, native=native)
        assert got.mode == mode, (native, got.mode, mode)
        for m, w in want.items():
            g = to_mode(got, m)
            assert g.shape == w.shape and g.dtype == w.dtype, (native, m, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"native={native} mode={m}")


RGB = seeded_rgb((37, 53), 300, noise=14)
SMALL = seeded_rgb((23, 29), 301, noise=14)

PILLOW_CASES = {
    "default": dict(),
    "irreversible": dict(irreversible=True),
    "one_resolution": dict(num_resolutions=1),
    "four_resolutions": dict(num_resolutions=4),
    "codeblock_8": dict(codeblock_size=(8, 8)),
    "codeblock_16x32": dict(codeblock_size=(16, 32), irreversible=True),
    "precinct_32": dict(precinct_size=(32, 32)),
    "tiles": dict(tile_size=(16, 16)),
    "tiles_offsets": dict(tile_size=(20, 12), tile_offset=(3, 5), offset=(7, 9),
                          num_resolutions=3),
    "tiles_offsets_irreversible": dict(tile_size=(16, 16), offset=(3, 3), irreversible=True,
                                       num_resolutions=3),
    "layers_db": dict(quality_mode="dB", quality_layers=[30, 40, 50]),
    "layers_rates": dict(quality_mode="rates", quality_layers=[40, 20, 1]),
    "layers_rates_irreversible": dict(quality_mode="rates", quality_layers=[60, 20, 8],
                                      irreversible=True),
    "no_mct": dict(mct=0),
    "no_mct_irreversible": dict(mct=0, irreversible=True),
    "codestream": dict(no_jp2=True),
    "plt": dict(plt=True),
}
for _prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
    PILLOW_CASES[f"prog_{_prog}"] = dict(progression=_prog, precinct_size=(16, 16),
                                         num_resolutions=3, quality_mode="rates",
                                         quality_layers=[20, 6, 2])
    PILLOW_CASES[f"prog_{_prog}_irreversible_tiles"] = dict(
        progression=_prog, irreversible=True, tile_size=(32, 24), quality_mode="rates",
        quality_layers=[20, 10, 5], num_resolutions=3)


@pytest.mark.parametrize("name", list(PILLOW_CASES))
def test_pillow_written_rgb_equals_pillow(name):
    check(pil_j2k(RGB, **PILLOW_CASES[name]), f"{name}.jp2")


@pytest.mark.parametrize("mode,irreversible", [
    ("L", False), ("L", True), ("LA", False), ("LA", True), ("RGBA", False), ("RGBA", True),
    ("I;16", False), ("I;16", True), ("signed", False)])
def test_pillow_written_modes_equal_pillow(mode, irreversible):
    if mode == "I;16":
        image = Image.frombytes("I;16", (29, 23), (SMALL[..., 0].astype("<u2") * 257).tobytes())
    elif mode == "signed":
        image = Image.fromarray(SMALL[..., 1])
    else:
        image = Image.fromarray(SMALL).convert(mode)
    kw = dict(signed=True) if mode == "signed" else {}
    check(pil_j2k(image, irreversible=irreversible, **kw), f"{mode}.jp2")


PLANES = [RGB[..., c].astype(np.int32) for c in range(3)]
STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32, "all": 63,
          "bypass_termall": 5, "bypass_pterm": 17, "reset_vsc_segsym": 42}


@pytest.mark.parametrize("irreversible", [0, 1], ids=["5-3", "9-7"])
@pytest.mark.parametrize("style", list(STYLES))
def test_codeblock_styles_equal_pillow(style, irreversible):
    check(openjpeg_encode(PLANES, mode=STYLES[style], mct=1, irreversible=irreversible,
                          rates=(30, 10, 1)), f"style_{style}.j2k")


@pytest.mark.parametrize("pocs", [
    [(0, 0, 2, 2, 3, 2), (0, 0, 3, 4, 3, 3)],
    [(0, 0, 3, 4, 2, 1), (0, 2, 3, 4, 3, 4)],
    [(0, 0, 1, 4, 3, 0), (0, 0, 3, 4, 3, 2)],
    [(0, 0, 2, 2, 3, 2), (0, 0, 3, 4, 2, 3), (1, 2, 3, 4, 3, 4)],   # both refuse it
], ids=["rpcl_pcrl", "rlcp_cprl", "lrcp_rpcl", "uncovered"])
def test_poc_changes_equal_pillow(pocs):
    check(openjpeg_encode(PLANES, rates=(20, 5, 1), numresolution=4, precincts=[(16, 16)] * 4,
                          mct=1, pocs=pocs), "poc.j2k")


@pytest.mark.parametrize("jp2_box", [False, True], ids=["j2k", "jp2"])
@pytest.mark.parametrize("prog", range(5), ids=["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_subsampled_components_equal_pillow(prog, jp2_box):
    """4:2:0 chroma in every progression (OpenJPEG's position steps with
    subsampled components), sYCC by the JP2's colr box or Pillow's guess."""
    planes = [PLANES[0], PLANES[1][::2, ::2], PLANES[2][::2, ::2]]
    check(openjpeg_encode(planes, sub=[(1, 1), (2, 2), (2, 2)], prog_order=prog,
                          numresolution=3, precincts=[(16, 16), (8, 8), (16, 8)],
                          rates=(12, 1), color_space=3, jp2=jp2_box), "sub.jp2")


def test_subsampled_422_with_offsets_equal_pillow():
    planes = [PLANES[0][:32], PLANES[1][:32, ::2], PLANES[2][:32, ::2]]
    check(openjpeg_encode(planes, sub=[(1, 1), (2, 1), (2, 1)], prog_order=2, offset=(3, 2),
                          precincts=[(8, 8)] * 6, color_space=3), "sub422.j2k")


def test_subsampled_alpha_equal_pillow():
    planes = [PLANES[0][:20, :30], PLANES[1][:20:2, :30:2], PLANES[2][:20:2, :30:2],
              PLANES[0][:20, :30] // 2]
    check(openjpeg_encode(planes, sub=[(1, 1), (2, 2), (2, 2), (1, 1)], numresolution=3),
          "sub_alpha.j2k")


@pytest.mark.parametrize("case", ["roi", "roi_irreversible", "sop_eph", "signed12", "prec4",
                                  "signed4", "prec12_rgb", "gray16_irreversible", "cmyk",
                                  "codeblock_1024x4", "codeblock_4", "nine_layers"])
def test_openjpeg_written_features_equal_pillow(case):
    rng = np.random.default_rng(302)
    gray = lambda lo, hi: [rng.integers(lo, hi, (20, 30))]  # noqa: E731
    kw = {
        "roi": dict(planes=PLANES, roi_compno=0, roi_shift=5, mct=1),
        "roi_irreversible": dict(planes=PLANES, roi_compno=1, roi_shift=3, irreversible=1,
                                 mct=1, rates=(20, 1)),
        "sop_eph": dict(planes=PLANES, csty=6, mct=1, rates=(20, 5, 1)),
        "signed12": dict(planes=gray(-2048, 2048), prec=12, sgnd=True, numresolution=3),
        "prec4": dict(planes=gray(0, 16), prec=4, numresolution=3),
        "signed4": dict(planes=gray(-8, 8), prec=4, sgnd=True, numresolution=3),
        "prec12_rgb": dict(planes=[rng.integers(0, 4096, (20, 30)) for _ in range(3)], prec=12,
                           mct=1, numresolution=3),
        "gray16_irreversible": dict(planes=gray(0, 65536), prec=16, irreversible=1,
                                    numresolution=3),
        "cmyk": dict(planes=[SMALL[..., c].astype(np.int32) for c in (0, 1, 2, 0)], jp2=True,
                     color_space=5, numresolution=3),
        "codeblock_1024x4": dict(planes=PLANES, cblockw_init=1024, cblockh_init=4, mct=1,
                                 numresolution=2),
        "codeblock_4": dict(planes=PLANES, cblockw_init=4, cblockh_init=4, mct=1,
                            numresolution=3, irreversible=1, rates=(15, 5)),
        "nine_layers": dict(planes=PLANES, mct=1, rates=(80, 60, 40, 30, 20, 10, 5, 2, 1)),
    }[case]
    check(openjpeg_encode(kw.pop("planes"), **kw), f"{case}.j2k")


@pytest.mark.parametrize("where", ["ppm", "ppt"])
def test_packet_headers_in_ppm_and_ppt_equal_pillow(where):
    """Pillow's packets (three layers, RLCP, four tiles) with their headers
    moved into the main header's PPM markers or each tile's PPT markers."""
    stream = pil_j2k(RGB, no_jp2=True, progression="RLCP", precinct_size=(16, 16),
                     num_resolutions=3, quality_mode="rates", quality_layers=[30, 10, 3],
                     tile_size=(32, 32))
    repacked = repack_headers(stream, where)
    assert repacked != stream
    check(repacked, f"{where}.j2k")


@pytest.mark.parametrize("columns", [3, 1, 2, 4, 5])
def test_palette_jp2_equals_pillow(columns):
    """A pclr box: Pillow's "P" with the palette's repeated colour dropped
    and entries of other than three columns packed as ``getcolor`` packs
    them; OpenJPEG's tile path gives the indices."""
    rng = np.random.default_rng(303)
    idx = (SMALL[..., 0] // 32).astype(np.uint8)
    pal = rng.integers(0, 256, (8, columns)).astype(np.uint8)
    pal[6] = pal[1]
    check(jp2_file(pil_j2k(idx, no_jp2=True), 23, 29, 1, 8, palette=pal), "palette.jp2")


def test_htj2k_codeblocks_are_refused_naming_the_format():
    data = with_cblk_style(pil_j2k(SMALL, no_jp2=True), 0x40)
    with Image.open(io.BytesIO(data)) as im:
        assert im.size == (29, 23)
    for native in PATHS:
        with pytest.raises(FormatNotRead, match=r"ht\.j2k.*HTJ2K \(JPEG 2000 Part 15\)"):
            jp2.decode_jp2(data, "ht.j2k", native=native)


@pytest.mark.parametrize("cut", [1, 2, 30, 200, 1000, 2000])
def test_truncated_files_as_pillow_takes_them(cut):
    data = pil_j2k(RGB, no_jp2=True, quality_mode="rates", quality_layers=[20, 5, 1])
    check(data[:-cut], f"cut{cut}.j2k")
    jp2_data = pil_j2k(SMALL)
    check(jp2_data[:-cut], f"cut{cut}.jp2")


@pytest.mark.parametrize("seed", range(6))
def test_damaged_bytes_as_pillow_takes_them(seed):
    """Bytes of the packet data flipped: OpenJPEG decodes what it reads, or
    fails, and so does the port."""
    rng = np.random.default_rng(310 + seed)
    data = bytearray(pil_j2k(SMALL, no_jp2=True, irreversible=bool(seed & 1)))
    for at in rng.integers(len(data) // 2, len(data) - 2, 3):
        data[at] = rng.integers(0, 256)
    check(bytes(data), f"damaged{seed}.j2k")


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_committed_fixtures_equal_pillow_hashes(name):
    """Every committed JPEG 2000 fixture through ``read_image`` and on the
    plain path: the manifest's Pillow hashes, or refused naming the file."""
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as fh:
        data = fh.read()
    if entry.get("raises"):
        for native in PATHS:
            with pytest.raises(ValueError, match=re.escape(name)):
                jp2.decode_jp2(data, name, native=native)
        return
    for mode in (None, "RGB", "L"):
        assert array_sha(read_image(path, mode)) == entry["sha256"][str(mode)], mode
    plain = jp2.decode_jp2(data, name, native=False)
    for mode in (None, "RGB", "L"):
        assert array_sha(to_mode(plain, mode)) == entry["sha256"][str(mode)], mode


@pytest.mark.parametrize("name", ["atlas_lossless_2048x1536.jp2", "atlas_lossy_2048x1536.j2k"])
def test_atlases_equal_pillow_hashes(name):
    """The 2048 x 1536 atlas as a lossless JP2 (5/3, RCT, 6 resolutions,
    LRCP) and a lossy J2K (9/7, ICT, 512² tiles, precincts, 3 layers, RPCL)
    through the native decoder (the plain tier-1 would take minutes)."""
    if not NATIVE:
        pytest.skip("no g++ on this host: the native decoder cannot be built")
    entry = MANIFEST[name]
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        data = fh.read()
    decoded = decode_image(data, name)
    assert list(decoded.pixels.shape) == entry["shape"] == [1536, 2048, 3]
    for mode in (None, "RGB", "L"):
        assert array_sha(to_mode(decoded, mode)) == entry["sha256"][str(mode)], mode


def test_icns_jpeg2000_members_equal_pillow(tmp_path):
    for name in ("icns_jp2_member.icns", "icns_j2k_gray_member.icns"):
        entry = MANIFEST[name]
        path = os.path.join(FIXTURES, name)
        for mode in (None, "RGB", "L"):
            assert array_sha(read_image(path, mode)) == entry["sha256"][str(mode)], (name, mode)


@pytest.mark.parametrize("orient", range(4))
@pytest.mark.parametrize("style", [0, 1, 8, 63])
def test_tier1_native_equals_plain_on_random_segments(orient, style):
    """Random bytes as MQ and raw segments (markers, 0xFF runs, data ending
    mid-pass): the C++ tier-1 decodes what the plain one decodes."""
    if not NATIVE:
        pytest.skip("no g++ on this host: the native decoder cannot be built")
    rng = np.random.default_rng(320 + orient * 7 + style)
    step_bits = int(np.float32(2.0).view(np.uint32))   # 0.5 * 2 keeps the decoded integers
    for w, h in ((13, 9), (32, 32), (5, 17)):
        raw = rng.integers(0, 256, 400).astype(np.uint8)
        raw[rng.integers(0, 400, 20)] = 0xFF
        # the segments tier-2 cuts: one a pass (TERMALL), 10 then 2, 1, 2, 1... (BYPASS)
        passes = [1] * 15 if style & 4 else ([10, 2, 1, 2, 1, 2] if style & 1 else [7, 3, 9])
        lens = rng.multinomial(400, np.ones(len(passes)) / len(passes))
        segments, at = [], 0
        for n, length in zip(passes, lens):
            segments.append((raw[at:at + length].tobytes(), n))
            at += length
        want = j2k_t1.decode_cblk(segments, w, h, orient, 9, 0, style)
        blocks = np.array([[0, 0, w, h, orient, 9, len(passes), 0, 0, step_bits]])
        got = codecs.j2k_reconstruct_comp(raw.tobytes(), blocks, lens, passes, 0, style, w, h,
                                          [(0, 0, w, h)], False)
        np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("n,cas", [(1, 0), (1, 1), (2, 0), (2, 1), (5, 0), (5, 1), (8, 1),
                                   (9, 1), (16, 0)])
def test_lifting_native_equals_plain(n, cas):
    """One level of each wavelet on a resolution of ``n`` samples starting
    at parity ``cas``, rows then columns, through ``j2k_reconstruct_comp``
    with no code-blocks."""
    if not NATIVE:
        pytest.skip("no g++ on this host: the native decoder cannot be built")
    rng = np.random.default_rng(330 + n * 3 + cas)
    low = (-(-(cas + n) // 2)) - (-(-cas // 2))
    dims = [(0, 0, low, low), (cas, cas, cas + n, cas + n)]
    for reversible in (True, False):
        coeffs = (rng.integers(-300, 300, (n, n)).astype(np.int32) if reversible
                  else rng.normal(0, 80, (n, n)).astype(np.float32))
        want = j2k_dwt.idwt2d(coeffs, dims, reversible)
        out = coeffs.copy()
        dims_a = np.ascontiguousarray(dims, np.int32)
        none = np.zeros(1, np.int64)
        assert codecs._j2k_lib().j2k_reconstruct_comp(
            b"", none.ctypes.data, none.ctypes.data, none.ctypes.data, none.ctypes.data,
            none.ctypes.data, 0, 0, 0, int(reversible), n, n, 2, dims_a.ctypes.data,
            out.ctypes.data) == 0
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("mct", [1, 0])
def test_poc_leaving_out_high_resolutions_equals_pillow(mct):
    """A POC whose second progression starts past the last resolution: the
    components keep OpenJPEG's ``resno_decoded`` (resolution 1 here) and
    come out at that size, as Pillow shows them."""
    stream = bytearray(openjpeg_encode(PLANES, rates=(20, 5, 1), numresolution=4,
                                       precincts=[(16, 16)] * 4, mct=1,
                                       pocs=[(0, 0, 2, 2, 3, 2), (0, 0, 3, 4, 3, 3)]))
    at = stream.index(b"\xff\x5f\x00\x10")
    stream[at + 4 + 7] = 164                       # the second POC's RSpoc
    if not mct:
        stream[stream.index(b"\xff\x52") + 8] = 0
    check(bytes(stream), "poc_low.j2k")


@pytest.mark.parametrize("where", ["sot", "sot_segment", "tile_header_marker"])
def test_stream_ending_at_a_marker_as_pillow(where):
    """A codestream that ends right after a marker's code (OpenJPEG's NEOC:
    no error, the tiles read so far) or inside a marker segment (an error),
    as Pillow takes them."""
    data = pil_j2k(RGB, no_jp2=True, tile_size=(32, 32), num_resolutions=3)
    sot = data.index(b"\xff\x90")
    cut = {"sot": sot + 2, "sot_segment": sot + 7,
           "tile_header_marker": data.index(b"\xff\x93", sot) + 2}[where]
    check(data[:cut], f"{where}.j2k")
