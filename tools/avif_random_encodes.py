#!/usr/bin/env python3
"""Hold the port's AVIF reader against Pillow on seeded random encodes.

    python3 tools/avif_random_encodes.py [--count 300] [--seed 0] [--max-side 96]
        [--lossy | --restored | --screen | --qm-grain]

Each case draws a size (1 to ``--max-side`` on a side), a subsampling
(4:4:4, 4:2:2, 4:2:0, 4:0:0), a range, an image (smooth plus noise, flat,
or uniform noise), an alpha plane or none (premultiplied, or its item set
to limited range where the colour is not 4:0:0, at random), tile columns
and rows, and writes it with Pillow. By default at ``quality=100``
(coded-lossless AV1) with an aom speed of 0 to 10 and one of aom's intra
tool switches off; with ``--lossy`` at a quality of 0 to 99 and a speed of
5 to 10 (Pillow's lossy files without CDEF, loop restoration or quantizer
matrices), with aom's deltaq-mode=3, sb-size=128, reduced-tx-type-set=1
or a loop filter sharpness at random; with ``--restored`` the same at a
speed of 0 to 4 (where aom turns loop restoration on) with aom's
enable-cdef=1 on half the cases (CDEF; speeds 5 to 10 leave it off); with
``--screen`` an image of screen content (flat colours, a posterised
gradient, lines of letters, squares of 2 to 8 colours; up to 256 samples
on a side by default, so that intra block copy has room) at a quality of 0
to 100 and a speed of 0 to 10, with aom's sb-size=128, tune-content=screen,
enable-intrabc=0 or enable-palette=0 at random, which aom codes with
palette mode and intra block copy where it finds them worth it; with
``--qm-grain`` a smooth-plus-noise image or a seeded patchwork at a quality
of 0 to 100 and a speed of 0 to 10, with quantizer matrices (aom's
tune=iq, or enable-qm=1 with a random qm-min and qm-max) in three cases of
four and film grain (aom's film-grain-test 1 to 16, or denoise-noise-level
of 5 to 50) in three of four, alone or together. It
compares ``coma_tpu_torch``'s
reader (``utils/avif.decode_avif`` and ``to_mode``, as ``read_image`` runs
them) with Pillow's array in modes None, RGB and L, to the byte. A file the
port refuses by name is counted apart, and so is a file Pillow fails to
decode (aom 3.12.1's denoiser writes a few that dav1d refuses, in 4:0:0
over two tile columns) where the port refuses it as damaged too. Prints one JSON line: the counts of equal, refused,
refused by both and differing cases (with ``--screen`` also how many equal
cases reached screen content tools, palettes and intra block copy, and the
luma transform types read in frames with intra block copy; with
``--qm-grain`` the quantizer matrix levels weighted and the grain's AR lags
and subsamplings), and the first
differing cases' parameters. Needs Pillow
with AVIF (libavif over aom and dav1d) and ``g++``; runs on the host.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_image_fixtures import (AVIF_TOOL_SWITCHES, avif_alpha_limited,  # noqa: E402
                                 seeded_flat, seeded_glyphs, seeded_patchwork,
                                 seeded_patchwork_palette, seeded_posterised, seeded_rgb)

SUBSAMPLINGS = ("4:4:4", "4:2:2", "4:2:0", "4:0:0")
# (subsampling_x, subsampling_y) -> the sampling's name
SAMPLINGS = {(0, 0): "4:4:4", (1, 0): "4:2:2", (1, 1): "4:2:0"}
# aom options of lossy files the port reads, each drawn with probability 0.2
LOSSY_OPTIONS = (("deltaq-mode", "3"), ("sb-size", "128"), ("reduced-tx-type-set", "1"),
                 ("sharpness", "3"))
# aom options of screen content, each drawn with probability 0.15
SCREEN_OPTIONS = (("sb-size", "128"), ("tune-content", "screen"), ("enable-intrabc", "0"),
                  ("enable-palette", "0"))


def qm_grain_options(rng: np.random.Generator, quality: int) -> dict:
    """aom options of quantizer matrices and film grain: tune=iq (not at
    quality 100: aom refuses its chroma delta q in a lossless frame) or
    enable-qm=1 with a random qm-min <= qm-max in three cases of four, and
    film-grain-test 1 to 16 or denoise-noise-level 5 to 50 in three of four
    (at least one of the two)."""
    advanced = {}
    draw_qm, draw_grain = rng.random() < 0.75, rng.random() < 0.75
    if not (draw_qm or draw_grain):
        draw_qm = draw_grain = True
    if draw_qm:
        if rng.random() < 0.3 and quality < 100:
            advanced["tune"] = "iq"
        else:
            lo, hi = sorted(int(v) for v in rng.integers(0, 16, 2))
            advanced.update({"enable-qm": "1", "qm-min": str(lo), "qm-max": str(hi)})
    if draw_grain:
        if rng.random() < 0.5:
            advanced["film-grain-test"] = str(int(rng.integers(1, 17)))
        else:
            advanced["denoise-noise-level"] = str(int(rng.integers(5, 51)))
    return advanced


def draw_screen(rng: np.random.Generator, k: int, max_side: int) -> np.ndarray:
    """A seeded screen-content image of case ``k``, (H, W, 3) uint8."""
    h, w = (int(v) for v in rng.integers(1, max_side + 1, 2))
    kind = rng.choice(["flat", "posterised", "glyphs", "glyphs", "squares"])
    if kind == "flat":
        return seeded_flat((h, w), 2000 + k, int(rng.integers(2, 9)))
    if kind == "posterised":
        return seeded_posterised((h, w), 2000 + k, int(rng.integers(3, 9)),
                                 int(rng.integers(16, 128)))
    if kind == "squares":
        return seeded_patchwork_palette((h, w), 2000 + k)
    ink, paper = rng.integers(0, 256, (2, 3))
    return seeded_glyphs((h, w), 2000 + k, int(rng.integers(2, 27)),
                         (int(rng.integers(8, 13)), int(rng.integers(6, 9))), tuple(ink),
                         tuple(paper))


def draw(rng: np.random.Generator, k: int, max_side: int, lossy: bool = False,
         restored: bool = False, screen: bool = False, qm_grain: bool = False) -> tuple:
    """(the image, Pillow's save options, whether to set the alpha item to
    limited range) of case ``k``; ``restored``: lossy at speeds 0 to 4, CDEF
    on in half the cases; ``screen``: screen content at any quality and
    speed; ``qm_grain``: quantizer matrices or film grain or both at any
    quality and speed."""
    lossy = lossy or restored
    if screen:
        rgb = draw_screen(rng, k, max_side)
        h, w = rgb.shape[:2]
    elif qm_grain and rng.random() < 0.25:
        side = int(rng.integers(1, max_side + 1))
        rgb = seeded_patchwork(side, k, float(rng.uniform(0, 30)))
        h = w = side
    else:
        h, w = (int(v) for v in rng.integers(1, max_side + 1, 2))
        kind = rng.choice(["smooth", "smooth", "flat", "noise"])
        if kind == "noise":
            rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        else:
            rgb = seeded_rgb((h, w), 1000 + k, noise=0.5 if kind == "flat" else 8)
    options = dict(quality=int(rng.integers(0, 101 if screen or qm_grain else 100))
                   if lossy or screen or qm_grain else 100,
                   subsampling=str(rng.choice(SUBSAMPLINGS)),
                   range=str(rng.choice(["full", "limited"])),
                   speed=int(rng.integers(0, 5) if restored else
                             rng.integers(5, 11) if lossy else rng.integers(0, 11)))
    if rng.random() < 0.3:
        options.update(tile_cols=int(rng.integers(0, 2)), tile_rows=int(rng.integers(0, 2)))
    if screen:
        advanced = {key: value for key, value in SCREEN_OPTIONS if rng.random() < 0.15}
        if advanced:
            options["advanced"] = advanced
    elif qm_grain:
        options["advanced"] = qm_grain_options(rng, options["quality"])
    elif lossy:
        advanced = {key: value for key, value in LOSSY_OPTIONS if rng.random() < 0.2}
        if restored and rng.random() < 0.5:
            advanced["enable-cdef"] = "1"
        if advanced:
            options["advanced"] = advanced
    elif rng.random() < 0.4:
        options["advanced"] = {str(rng.choice(AVIF_TOOL_SWITCHES)): "0"}
    limited_alpha = False
    if rng.random() < 0.4:
        if screen:        # flat alpha: the alpha item's palettes
            alpha = draw_screen(rng, k + 1, max_side)[..., :1]
            alpha = np.resize(alpha, (h, w, 1))
        else:
            alpha = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        rgb = np.concatenate([rgb, alpha], -1)
        options["alpha_premultiplied"] = bool(rng.random() < 0.3)
        limited_alpha = bool(rng.random() < 0.3) and options["subsampling"] != "4:0:0"
    return rgb, options, limited_alpha


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-side", type=int, default=None,
                        help="the largest side (96; 256 with --screen)")
    parser.add_argument("--lossy", action="store_true",
                        help="lossy encodes (quality 0-99, speed 5-10) instead of quality=100")
    parser.add_argument("--restored", action="store_true",
                        help="lossy encodes at speeds 0-4 (loop restoration), CDEF on in half")
    parser.add_argument("--screen", action="store_true",
                        help="screen content (palette, intra block copy) at any quality and speed")
    parser.add_argument("--qm-grain", action="store_true",
                        help="quantizer matrices and film grain at any quality and speed")
    args = parser.parse_args()
    if args.max_side is None:
        args.max_side = 256 if args.screen else 96
    from PIL import Image

    from coma_tpu_torch.utils.avif import decode_avif, decode_avif_planes
    from coma_tpu_torch.utils.modes import FormatNotRead, to_mode

    rng = np.random.default_rng(args.seed)
    equal, refused, differ, both_refuse = 0, [], [], 0
    reached = dict(screen_content_tools=0, palette=0, intrabc=0)
    intrabc_tx_types = 0      # the luma transform types of the frames with intrabc blocks
    qm_levels, grain = [0, 0], dict(ar_coeff_lag=set(), subsampling=set(), alpha=0)
    for k in range(args.count):
        image, options, limited_alpha = draw(rng, k, args.max_side, args.lossy, args.restored,
                                             args.screen, args.qm_grain)
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, "AVIF", **options)
        data = avif_alpha_limited(buf.getvalue()) if limited_alpha else buf.getvalue()
        case = dict(k=k, shape=list(image.shape), limited_alpha=limited_alpha, **options)
        try:
            got = decode_avif(data, f"case{k}.avif")
        except FormatNotRead as err:
            refused.append(dict(case, reason=str(err)))
            continue
        except ValueError as err:          # damaged: equal where Pillow refuses the file too
            try:
                with Image.open(io.BytesIO(data)) as im:
                    im.load()
            except (OSError, RuntimeError, ValueError):
                both_refuse += 1
            else:
                differ.append(dict(case, reason=str(err)))
            continue
        with Image.open(io.BytesIO(data)) as im:
            im.load()
            same = all(np.array_equal(to_mode(got, m),
                                      np.asarray(im if m is None else im.convert(m)))
                       for m in (None, "RGB", "L"))
        if same:
            equal += 1
            if args.screen:
                _, (info, _, _), _ = decode_avif_planes(data, f"case{k}.avif")
                reached["screen_content_tools"] += info["allow_screen_content_tools"]
                reached["palette"] += info["palette_y_blocks"] + info["palette_uv_blocks"] > 0
                reached["intrabc"] += info["intrabc_blocks"] > 0
                if info["intrabc_blocks"]:
                    intrabc_tx_types |= info["tx_types"]
            if args.qm_grain:
                _, (info, _, _), alpha = decode_avif_planes(data, f"case{k}.avif")
                for name, mask in info.items():
                    if name.startswith("qm_levels_"):
                        qm_levels[name[10] != "0"] |= mask
                for item in (info,) + ((alpha[0],) if alpha else ()):
                    if item["grain_planes"]:
                        grain["ar_coeff_lag"].add(item["ar_coeff_lag"])
                        grain["subsampling"].add("4:0:0" if item["mono_chrome"] else SAMPLINGS[
                            item["grain_subsampling_x"], item["grain_subsampling_y"]])
                grain["alpha"] += bool(alpha and alpha[0]["grain_planes"])
        else:
            differ.append(case)
    print(json.dumps(dict(count=args.count, seed=args.seed, lossy=args.lossy,
                          restored=args.restored, screen=args.screen, max_side=args.max_side,
                          equal=equal,
                          **(dict(equal_cases_reaching=reached, tx_types_with_intrabc=[
                              t for t in range(16) if intrabc_tx_types >> t & 1])
                             if args.screen else {}),
                          **(dict(qm_grain=True, qm_levels_weighted=dict(
                              luma=[v for v in range(15) if qm_levels[0] >> v & 1],
                              chroma=[v for v in range(15) if qm_levels[1] >> v & 1]),
                              grain_ar_coeff_lags=sorted(grain["ar_coeff_lag"]),
                              grain_subsamplings=sorted(grain["subsampling"]),
                              grain_alpha_items=grain["alpha"]) if args.qm_grain else {}),
                          refused=len(refused), both_refuse=both_refuse, differ=len(differ),
                          first_differing=differ[:5],
                          first_refused=refused[:5])))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
