#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the images ``coma_tpu`` reads through
PIL, on the card's machine.

    python3 tools/phase16_torch.py

Builds the CUDA kernels (the inpainting batch runs K3), then runs
``chip_smoke.phase16``: (a) every fixture of ``tests/data/images/`` through
``read_image`` (the native JPEG decoder and image codecs, TIFF's CCITT and
Zstandard decoders and the JPEG 2000 decoder among them, built with ``g++``
at first use) against
Pillow's hashes, with the 2048 x 1536 decodes timed (the JPEG 2000 atlases
among them); (b) the BEHAVE reader on JPEG colour frames and masks; (c) a
chair textured in forty-nine files (twenty-seven formats, TIFFs in six more
compressions and a 1-bit tiled one, JPEG 2000, Lab, PFM, XPM, FTEX, GBR,
PIXAR, FLC, PhotoCD, McIdas, FITS, XV thumbnail, IPTC/NAA, lossless AVIF,
lossy AVIF at Pillow's defaults, AVIF with CDEF and loop restoration,
AVIF of screen content in palette mode and intra block copy, and AVIF with
quantizer matrices (tune=iq) and with film grain (a denoised photograph))
through stage 1 at
384² and one inpainting batch of 4 at 512², with the same checks and kernel
counters as the full script; (d) the seeded
step-video GIF written as PIL writes it. Needs a card; prints its name and
power limit. For measuring a change to these paths without the other phases.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from coma_tpu_torch.ops import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("phase16_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    out = cs.phase16(label)
    out["stage1"] = {k: v for k, v in out["stage1"].items() if k != "kept"}
    print(json.dumps(out))
    print(f"phase 16 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
