#!/usr/bin/env python3
"""K3's float32 kernel alone on the card: ``chip_smoke.py`` phase 5's float32 rows.

    python3 tools/k3_f32_torch.py [--root DIR] [--out FILE]

Builds ``csrc/flash_attention.cu`` of the ``coma_tpu_torch`` package under
``--root`` (default: this checkout; another checkout, e.g. a ``git archive``
of an earlier commit unpacked into a git-ignored directory, times that
commit's kernel with the same script), prints the compiler's registers and
spills, then runs ``chip_smoke.check_k3`` at every float32 shape of phase 5
(``K3_F32_SHAPES`` and the tiny loop's shapes): the kernel against its plain
version (within 1e-4), the kernel's, the plain version's and SDPA's ms per
call (CUDA events), the bound and the share of it, SDPA's backend and the
instance's rows and dynamic shared memory. One line per shape, then the
card's name and power limit, then one JSON line of the results (also written
to ``--out``). Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose coma_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_f32_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)   # coma_tpu_torch from --root, chip_smoke from this checkout
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from coma_tpu_torch.ops import attention, build

    if not build.CSRC_DIR.is_relative_to(root):
        raise AssertionError(f"coma_tpu_torch came from {build.CSRC_DIR}, not from {root}")
    if not hasattr(attention, "f32_tile"):   # a checkout before the instances were reported
        attention.f32_tile = lambda bh, lq, d: (None, None, None)
    label = cs.card_label()
    t0 = time.perf_counter()
    build.build_all(["flash_attention"])
    print(f"built {build.CSRC_DIR}/flash_attention.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in build.log_path("flash_attention").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {line.strip()}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    results = []
    for shape in cs.K3_F32_SHAPES + tuple(cs.tiny_k3_shapes()):
        r = cs.check_k3(rng, *shape[:6], torch.float32, rows=shape[6])
        results.append(r)
        cs.log_k3_f32(r, label)
    print(label)
    line = json.dumps({"root": root, "card": label, "k3_f32": results})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
