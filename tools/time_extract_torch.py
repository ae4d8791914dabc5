#!/usr/bin/env python3
"""Wall clock of ``cli/extract_coma`` on one card, to compare two checkouts.

    python3 tools/time_extract_torch.py [--root DIR] [--runs 3]

Writes ``chip_smoke.py``'s synthetic results tree (a 10475-vertex body, 64
posed samples, a backpack; numpy seed 1) under ``DIR/_smoke``, makes the
CUDA context and loads K1 and K2 (built from DIR's sources, outside the
timed window), then runs the extraction at ``qual:backpack_human_contact``
and ``qual:backpack_occupancy`` ``--runs`` times each, alternating, every run
with a new state as the CLI makes it. The first contact run of the process
pays what a fresh CLI process pays once (K1's splat plan, where the
checkout has one). ``coma_tpu_torch`` is imported from DIR (default: this
checkout), so a parent commit unpacked into a directory can be timed
against this one in one call: run this script once per checkout, in turns.
Prints one line per run and, last, a JSON summary with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("qual:backpack_human_contact", "qual:backpack_occupancy")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_extract_torch: needs a card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from coma_tpu_torch.cli import extract_coma
    from coma_tpu_torch.ops import build

    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.zeros(1, device="cuda")
    for name in ("contact_splat", "occupancy_hits"):
        build.load(name)
    times = {key: [] for key in KEYS}
    os.makedirs(os.path.join(root, "_smoke"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="time_", dir=os.path.join(root, "_smoke")) as tmp:
        paths = smoke.write_tree(tmp, np.random.default_rng(smoke.SEED + 1))
        for run in range(args.runs):
            for key in KEYS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                extract_coma.main([
                    "--human_sample_dir", f"{paths['tree'].root}/generation/human_sample",
                    "--constants_mesh_dir", paths["constants"], "--hyperparams_key", key,
                    "--device", "cuda",
                ])
                torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
                print(f"run {run} {key}: {times[key][-1]:.3f} s [{root}; {label}]", flush=True)
    print(json.dumps({"root": root, "card": label, "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
