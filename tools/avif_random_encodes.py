#!/usr/bin/env python3
"""Hold the port's AVIF reader against Pillow on seeded random encodes.

    python3 tools/avif_random_encodes.py [--count 300] [--seed 0] [--max-side 96]
        [--lossy | --restored]

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
enable-cdef=1 on half the cases (CDEF; speeds 5 to 10 leave it off). It
compares ``coma_tpu_torch``'s
reader (``utils/avif.decode_avif`` and ``to_mode``, as ``read_image`` runs
them) with Pillow's array in modes None, RGB and L, to the byte. A file the
port refuses by name (aom chose screen content tools for a flat image) is
counted apart. Prints one JSON line: the counts of equal, refused and
differing cases, and the first differing cases' parameters. Needs Pillow
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
                                 seeded_rgb)

SUBSAMPLINGS = ("4:4:4", "4:2:2", "4:2:0", "4:0:0")
# aom options of lossy files the port reads, each drawn with probability 0.2
LOSSY_OPTIONS = (("deltaq-mode", "3"), ("sb-size", "128"), ("reduced-tx-type-set", "1"),
                 ("sharpness", "3"))


def draw(rng: np.random.Generator, k: int, max_side: int, lossy: bool = False,
         restored: bool = False) -> tuple:
    """(the image, Pillow's save options, whether to set the alpha item to
    limited range) of case ``k``; ``restored``: lossy at speeds 0 to 4, CDEF
    on in half the cases."""
    lossy = lossy or restored
    h, w = (int(v) for v in rng.integers(1, max_side + 1, 2))
    kind = rng.choice(["smooth", "smooth", "flat", "noise"])
    if kind == "noise":
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        rgb = seeded_rgb((h, w), 1000 + k, noise=0.5 if kind == "flat" else 8)
    options = dict(quality=int(rng.integers(0, 100)) if lossy else 100,
                   subsampling=str(rng.choice(SUBSAMPLINGS)),
                   range=str(rng.choice(["full", "limited"])),
                   speed=int(rng.integers(0, 5) if restored else
                             rng.integers(5, 11) if lossy else rng.integers(0, 11)))
    if rng.random() < 0.3:
        options.update(tile_cols=int(rng.integers(0, 2)), tile_rows=int(rng.integers(0, 2)))
    if lossy:
        advanced = {key: value for key, value in LOSSY_OPTIONS if rng.random() < 0.2}
        if restored and rng.random() < 0.5:
            advanced["enable-cdef"] = "1"
        if advanced:
            options["advanced"] = advanced
    elif rng.random() < 0.4:
        options["advanced"] = {str(rng.choice(AVIF_TOOL_SWITCHES)): "0"}
    limited_alpha = False
    if rng.random() < 0.4:
        alpha = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        rgb = np.concatenate([rgb, alpha], -1)
        options["alpha_premultiplied"] = bool(rng.random() < 0.3)
        limited_alpha = bool(rng.random() < 0.3) and options["subsampling"] != "4:0:0"
    return rgb, options, limited_alpha


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-side", type=int, default=96)
    parser.add_argument("--lossy", action="store_true",
                        help="lossy encodes (quality 0-99, speed 5-10) instead of quality=100")
    parser.add_argument("--restored", action="store_true",
                        help="lossy encodes at speeds 0-4 (loop restoration), CDEF on in half")
    args = parser.parse_args()
    from PIL import Image

    from coma_tpu_torch.utils.avif import decode_avif
    from coma_tpu_torch.utils.modes import FormatNotRead, to_mode

    rng = np.random.default_rng(args.seed)
    equal, refused, differ = 0, [], []
    for k in range(args.count):
        image, options, limited_alpha = draw(rng, k, args.max_side, args.lossy, args.restored)
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, "AVIF", **options)
        data = avif_alpha_limited(buf.getvalue()) if limited_alpha else buf.getvalue()
        case = dict(k=k, shape=list(image.shape), limited_alpha=limited_alpha, **options)
        try:
            got = decode_avif(data, f"case{k}.avif")
        except FormatNotRead as err:
            refused.append(dict(case, reason=str(err)))
            continue
        with Image.open(io.BytesIO(data)) as im:
            im.load()
            same = all(np.array_equal(to_mode(got, m),
                                      np.asarray(im if m is None else im.convert(m)))
                       for m in (None, "RGB", "L"))
        if same:
            equal += 1
        else:
            differ.append(case)
    print(json.dumps(dict(count=args.count, seed=args.seed, lossy=args.lossy,
                          restored=args.restored, max_side=args.max_side, equal=equal,
                          refused=len(refused), differ=len(differ), first_differing=differ[:5],
                          first_refused=refused[:5])))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
