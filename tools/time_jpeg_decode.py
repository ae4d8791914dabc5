#!/usr/bin/env python3
"""Time the native JPEG decoder of a ``coma_tpu_torch`` tree on the host.

    python3 tools/time_jpeg_decode.py [--root DIR] [--reps 7]

Imports ``coma_tpu_torch`` from ``--root`` (default: this checkout; another
commit's tree unpacked with ``git archive`` compares two versions in one
run: parent, change, change, parent), builds its native decoder with ``g++``
there, and decodes the committed 2048 x 1536 BEHAVE colour frame (baseline
4:2:0, q90) ``--reps`` times: the entropy decode (``decode_coefficients``)
and the reconstruction (``reconstruct``), median and spread in ms. Prints one
JSON line with the root, the CPU count and the machine's card (``nvidia-smi``)
where it has one; the decoder runs on the host either way.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = os.path.join(REPO, "tests", "data", "images", "behave_color_2048x1536.jpg")


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "none"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "none"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from coma_tpu_torch.utils import jpeg

    if not jpeg.native_available():
        print("time_jpeg_decode: the native decoder did not build", file=sys.stderr)
        return 1
    with open(FRAME, "rb") as fh:
        data = fh.read()
    frame = jpeg.decode_coefficients(data, FRAME, native=True)      # warm-up
    entropy, recon = [], []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        frame = jpeg.decode_coefficients(data, FRAME, native=True)
        t1 = time.perf_counter()
        jpeg.reconstruct(frame, native=True)
        entropy.append((t1 - t0) * 1e3)
        recon.append((time.perf_counter() - t1) * 1e3)
    print(json.dumps(dict(root=os.path.abspath(args.root), cpus=os.cpu_count(), card=card(),
                          entropy_ms=statistics.median(entropy), entropy_ms_all=entropy,
                          reconstruct_ms=statistics.median(recon), reconstruct_ms_all=recon)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
