#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: stage 1 (object renders, candidate
masks, prompts, one inpainting batch) on the card.

    python3 tools/stage1_torch.py

Builds the CUDA kernels (the inpainting batch runs K3), then runs
``chip_smoke.stage1_phase``: ``cli/generate_2d_hoi_images`` on a synthetic
textured chair (20,736 faces, a 512² ``map_Kd`` texture) at
``render_objects``' defaults and the Chair camera config, 8 views at 512²,
with the same checks, timings and kernel counters as the full script. Needs
a card; prints its name and power limit. For measuring a change to stage 1
without the other phases.
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
        print("stage1_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    out = cs.stage1_phase(label)
    print(json.dumps({k: v for k, v in out.items() if k != "kept"}))
    print(f"stage 1 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
