#!/usr/bin/env python3
"""Time the host decode of the two 2048 x 1536 JPEG 2000 atlases.

    python3 tools/time_jpeg2000_decode.py [--reps 5] [--root REPO]

For each of ``tests/data/images/atlas_lossless_2048x1536.jp2`` (5/3, RCT,
6 resolutions, LRCP) and ``atlas_lossy_2048x1536.j2k`` (9/7, ICT, 512²
tiles, precincts, 3 layers, RPCL): the median and every time of ``--reps``
decodes through ``utils/image_io.decode_image`` (the native decoder where
``g++`` builds it), after one untimed decode that builds it, and, where
Pillow is installed, of ``np.asarray(Image.open(f))`` (OpenJPEG 2.5.4).
``--root`` times the port of another checkout (a parent's, unpacked with
``git archive``). Prints one JSON object.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import time

ATLASES = ("atlas_lossless_2048x1536.jp2", "atlas_lossy_2048x1536.j2k")


def timed(fn, reps: int) -> dict:
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(median_ms=statistics.median(ms), all_ms=ms)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    from coma_tpu_torch.utils.image_io import decode_image

    try:
        import numpy as np
        from PIL import Image
    except ImportError:
        Image = None
    out = {}
    for name in ATLASES:
        with open(os.path.join(args.root, "tests", "data", "images", name), "rb") as fh:
            data = fh.read()
        decode_image(data, name)
        out[name] = dict(bytes=len(data), port=timed(lambda: decode_image(data, name), args.reps))
        if Image is not None:
            out[name]["pillow"] = timed(lambda: np.asarray(Image.open(io.BytesIO(data))),
                                        args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
