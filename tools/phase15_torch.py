#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone: ``--mesh`` inpainting over two ranks
(K3), the 2-D aggregation over four ranks (K1) and the weights-readiness
check, on the card.

    python3 tools/phase15_torch.py

Builds the CUDA kernels, then runs ``chip_smoke.phase15``, which writes its
own seeded inputs, with the same checks, timings and per-rank kernel
counters. Needs a card; prints its name and power limit. For measuring a
change to these paths without the other phases.
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
        print("phase15_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    out = cs.phase15(label)
    print(json.dumps(out))
    print(f"phase 15 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
