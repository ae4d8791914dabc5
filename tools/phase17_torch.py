#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: ``coma_tpu_torch.benchkit``, the
bench's measured entry points, on the card.

    python3 tools/phase17_torch.py

Builds the CUDA kernels, then runs ``chip_smoke.phase17``: K3 against its
plain version at the pipeline suite's batch-16 shapes, then every key of
``bench.py``'s sections coma, pipe_suite, torch_baselines, dp_scaling and
extract_production through ``coma_tpu_torch.benchkit``, with each kernel's
counter from 0 before each path, and the device's idle share of the CFG UNet
step and of each segmenter's provoke call. Needs a card; prints its name and
power limit, then one JSON line of the bench's keys. For measuring a change
to these paths without the other phases.
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
        print("phase17_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    out = cs.phase17(label)
    print(json.dumps({"bench": out["bench"], "launches": out["launches"]}))
    print(f"phase 17 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
