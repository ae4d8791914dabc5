#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: stage 2 (3D lifting) on the card.

    python3 tools/stage2_torch.py

Writes its own inputs under ``_smoke/`` (git-ignored): a seeded SMPL-X-shaped
npz at the published widths (``chip_smoke.write_smplx_npz``: 10475 vertices,
55 joints) and four random 512² PNGs standing in for phase 6's inpaintings;
then runs ``chip_smoke.stage2_phase``: ``cli/predict_human`` with a seeded
Hand4Whole at the published widths (one patch held against the CPU), and
``cli/generate_3d_hoi_samples`` on the 8-view 512² lifting tree with neural
COAP, with the same checks, timings and kernel counters as the full script.
Needs a card; prints its name and power limit. For measuring a change to
stage 2 without the other phases (≈ 1.5 minutes on the card, set-up included).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from coma_tpu_torch.utils.png import write_png  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("stage2_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    root = tempfile.mkdtemp(prefix="stage2_", dir=cs.SCRATCH)
    npz = f"{root}/smplx.npz"
    cs.write_smplx_npz(npz, np.random.default_rng(cs.SEED + 3))
    images = f"{root}/images/{cs.SC}/{cs.CAT}/{cs.ASSET}/view:00000/0/{cs.PROMPT}"
    os.makedirs(images)
    rng = np.random.default_rng(cs.SEED)
    for i in range(cs.INPAINT_IMAGES):
        write_png(f"{images}/{i:05d}.png", np.uint8(rng.uniform(size=(cs.INPAINT_RES,) * 2 + (3,))
                                                    * 255))
    out = cs.stage2_phase(f"{root}/images", npz, label)
    print({k: v for k, v in out["lift"].items()}, flush=True)
    print(f"stage 2 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
