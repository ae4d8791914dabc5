#!/usr/bin/env python3
"""Time the host AVIF decode of two checkouts of this repository in
alternating runs, so that a drift of the host's speed falls on both.

    python3 tools/avif_decode_pairs.py --other DIR [--pairs 6] [--reps 5]
        [--out FILE] [NAME ...]

Each run is a process of its own that imports ``coma_tpu_torch`` from one
checkout (which builds that checkout's ``native/src/av1_decode.cpp`` with
``g++`` at first use, before any timing), reads each named fixture of this
checkout's ``tests/data/images`` (default: the two 2048 x 1536 AVIF
atlases), decodes it once through ``utils.image_io.decode_image`` and checks
the pixels against the manifest's hash of Pillow's array, then decodes it
``--reps`` times and prints the median. The runs go other, this, this,
other, ... for ``--pairs`` pairs. A fixture the other checkout refuses (a
lossy AVIF before it read one) is timed for this checkout only.

Prints, per fixture, each checkout's per-run medians and their median, and
the median of the per-pair ratios (this / other); with ``--out``, the same
as JSON. The card's name and power limit head the output where
``nvidia-smi`` answers (the decode runs on the host; no card is needed).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
DEFAULT = ("atlas_lossless_2048x1536.avif", "atlas_lossy_2048x1536.avif")


def child(root: str, names: list, reps: int) -> int:
    """One run: ``root``'s decoder on each fixture, as a JSON line of
    {name: median ms, or the refusal's text}."""
    import time

    import numpy as np

    sys.path.insert(0, os.path.abspath(root))
    from coma_tpu_torch.utils.image_io import decode_image

    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        manifest = {e["file"]: e for e in json.load(fh)["files"]}
    out = {}
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as fh:
            data = fh.read()
        try:
            first = decode_image(data, name)
        except ValueError as err:
            out[name] = f"refused: {err}"
            continue
        pixels = np.ascontiguousarray(first.pixels)
        if hashlib.sha256(pixels.tobytes()).hexdigest() != manifest[name]["sha256"]["None"]:
            raise AssertionError(f"{root}: {name} differs from Pillow's")
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            decode_image(data, name)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(ms)
    print(json.dumps(out))
    return 0


def run(root: str, names: list, reps: int) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", root, "--reps", str(reps), *names]
    done = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


def card() -> str:
    if not shutil.which("nvidia-smi"):
        return "no card"
    done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout else "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(DEFAULT))
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(a.child, a.names, a.reps)
    if not a.other:
        ap.error("--other DIR is needed")
    roots = {"other": os.path.abspath(a.other), "this": REPO}
    label = card()
    print(f"card: {label}; host: {os.uname().nodename}, {os.cpu_count()} cores", flush=True)
    runs = {"other": [], "this": []}
    for k in range(a.pairs):
        for who in (("other", "this") if k % 2 == 0 else ("this", "other")):
            runs[who].append(run(roots[who], a.names, a.reps))
    report = dict(card=label, pairs=a.pairs, reps=a.reps, other=roots["other"], files={})
    for name in a.names:
        this = [r[name] for r in runs["this"]]
        other = [r[name] for r in runs["other"]]
        entry = dict(this_ms=this, this_median_ms=statistics.median(this))
        if all(isinstance(v, float) for v in other):
            ratios = [t / o for t, o in zip(this, other)]
            entry.update(other_ms=other, other_median_ms=statistics.median(other),
                         ratio_median=statistics.median(ratios), ratios=ratios)
            print(f"{name}: this {entry['this_median_ms']:.3f} ms, other "
                  f"{entry['other_median_ms']:.3f} ms (medians of {a.pairs} runs, each the median "
                  f"of {a.reps}); this / other, median of the pairs: {entry['ratio_median']:.4f} "
                  f"[{label}]")
        else:
            entry.update(other=other[0])
            print(f"{name}: this {entry['this_median_ms']:.3f} ms (median of {a.pairs} runs, each "
                  f"the median of {a.reps}); other: {other[0][:120]} [{label}]")
        report["files"][name] = entry
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
