#!/usr/bin/env python3
"""Pick the float32 K3 kernel's tiles on the card: time variants of its split.

    python3 tools/k3_f32_tiles.py [--variant D:TR,TN,TM,NSTAGE,PARTS ...] [--source FILE]
                                  [--out FILE]

Each variant is a copy of ``coma_tpu_torch/csrc/flash_attention.cu`` (or of
``--source``, another version of that file) whose
``Split<D>`` line is replaced by the given (TR lanes per row, TN keys per
lane, TM rows per lane of the wide instance, NSTAGE ring stages, PARTS
partial sums); the source's own split is the first variant of each head dim.
All variants are built at once (one ``nvcc`` each, the package's flags) into
a temporary directory and loaded with ctypes. Each is held against the plain
version (within 1e-4) and timed at its head dim's float32 shape of
``chip_smoke.py`` phase 5 (CUDA events around 20 launches after a warm-up,
the launches alone, no wrapper), then run for about a second while
``nvidia-smi`` samples the SM clock and the power drawn. Printed per
variant: registers and spills of its instances, rows and dynamic shared
memory per block, ms per launch, the share of the bound, the median SM clock
and power; then the card's name and power limit and one JSON line (also
written to ``--out``). Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import PEAK_F32_OPS, card_label  # noqa: E402
from coma_tpu_torch.ops import build  # noqa: E402
from coma_tpu_torch.ops.attention import LOG2E, attention_reference  # noqa: E402

SHAPES = {  # head dim -> (B, H, Lq, Lk): phase 5's float32 shape of that head dim
    40: (8, 8, 4096, 4096), 80: (8, 8, 1024, 1024), 160: (8, 8, 256, 256), 512: (4, 1, 4096, 4096),
}
VARIANTS = [  # D:TR,TN,TM,NSTAGE,PARTS tried beside the source's own split
    "80:4,8,4,2,1", "80:4,4,4,3,1", "80:2,16,2,3,1", "80:4,8,2,3,1",
    "40:2,16,4,2,1", "40:2,8,4,3,1", "40:2,16,2,3,1", "40:1,32,2,3,1",
    "160:8,4,4,2,1", "160:4,8,2,3,1", "160:8,4,2,3,1",
    "512:8,2,1,2,4", "512:16,1,2,2,1", "512:16,1,1,2,4",
]
SPLIT = re.compile(r"template <> struct Split<(\d+)> *\{[^}]*\};")


def source_splits(text: str) -> dict:
    out = {}
    for m in SPLIT.finditer(text):
        vals = dict(re.findall(r"(\w+) = (\d+)", m.group(0)))
        out[int(m.group(1))] = ",".join(vals[k] for k in ("TR", "TN", "TM", "NSTAGE", "PARTS"))
    return out


def variant_source(text: str, d: int, split: str) -> str:
    tr, tn, tm, ns, parts = split.split(",")
    line = (f"template <> struct Split<{d}> {{ static constexpr int TR = {tr}, TN = {tn}, "
            f"TM = {tm}, NSTAGE = {ns}, PARTS = {parts}; }};")
    return SPLIT.sub(lambda m: line if int(m.group(1)) == d else m.group(0), text)


def sampled_clock(call, launches: int):
    """Median SM clock (MHz) and power (W) that ``nvidia-smi`` reads every
    100 ms while ``launches`` calls run back to back."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(launches):
            call()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=10)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines() if line.strip()]
    if not rows:
        return None, None
    return float(np.median([r[0] for r in rows])), float(np.median([r[1] for r in rows]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=None,
                    help="D:TR,TN,TM,NSTAGE,PARTS (repeatable; default: a built-in list)")
    ap.add_argument("--source", default=None, help="a version of csrc/flash_attention.cu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_f32_tiles: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    text = open(args.source or build.CSRC_DIR / "flash_attention.cu").read()
    own = source_splits(text)
    wanted = args.variant or VARIANTS
    dims = sorted({int(v.split(":")[0]) for v in wanted})
    variants = [f"{d}:{own[d]}" for d in dims] + [v for v in wanted if v not in
                                                   {f"{d}:{own[d]}" for d in dims}]
    tmp = tempfile.mkdtemp(prefix="k3_tiles_")
    procs = []
    for n, spec in enumerate(variants):
        d, split = spec.split(":")
        src = os.path.join(tmp, f"v{n}.cu")
        with open(src, "w") as fh:
            fh.write(variant_source(text, int(d), split))
        log = open(os.path.join(tmp, f"v{n}.log"), "w")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"v{n}.so"), src]
        procs.append((spec, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, n))
    label = card_label()
    results = []
    for spec, proc, log, n in procs:
        rc = proc.wait()
        log.close()
        d, split = int(spec.split(":")[0]), spec.split(":")[1]
        ptxas = open(os.path.join(tmp, f"v{n}.log")).read()
        # registers of this head dim's instances: the entry names carry Tile<D, TR, TM, ...>
        regs = []
        for entry in ptxas.split("Compiling entry function")[1:]:
            if f"TileILi{d}E" in entry.split("'")[1]:
                spill = re.search(r"(\d+) bytes spill stores", entry)
                used = re.search(r"Used (\d+) registers", entry)
                regs.append((int(spill.group(1)) if spill else None,
                             int(used.group(1)) if used else None))
        r = dict(variant=spec, source_split=split == own[d], built=rc == 0,
                 spill_and_registers=regs)
        results.append(r)
        if rc != 0:
            print(f"{spec}: build failed\n{ptxas[-2000:]}", flush=True)
            continue
        lib = ctypes.CDLL(os.path.join(tmp, f"v{n}.so"))
        fn, tile = lib.coma_flash_attention_f32, lib.coma_flash_attention_f32_tile
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [P] * 4 + [I] * 4 + [ctypes.c_float, P], I
        tile.argtypes, tile.restype = [I, I, I, ctypes.POINTER(I), ctypes.POINTER(I)], I
        B, H, Lq, Lk = SHAPES[d]
        rng = np.random.default_rng(d)
        q, k, v = (torch.from_numpy(np.float32(rng.normal(size=(B, H, n_, d)))).cuda()
                   for n_ in (Lq, Lk, Lk))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, Lq, Lk, d,
                      LOG2E / math.sqrt(d), stream)
            if code:
                raise RuntimeError(f"{spec}: CUDA error {code}")

        call()
        torch.cuda.synchronize()
        sel = slice(0, 1)
        err = float((o[sel] - attention_reference(q[sel], k[sel], v[sel])).abs().max())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        clock_mhz, power_w = sampled_clock(call, max(20, int(1000 / ms)))
        rows, per_sm = I(0), I(0)
        smem = tile(B * H, Lq, d, ctypes.byref(rows), ctypes.byref(per_sm))
        bound_ms = 4.0 * B * H * Lq * Lk * d / PEAK_F32_OPS * 1e3
        r.update(shape=[B, H, Lq, Lk, d], ms=ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
                 max_abs_err=err, block_rows=rows.value, dynamic_smem_bytes=smem,
                 blocks_per_sm=per_sm.value, sm_clock_mhz=clock_mhz, power_w=power_w)
        print(f"{spec}{' (the source)' if r['source_split'] else ''}: (spills, registers) "
              f"{r['spill_and_registers']}, {rows.value} rows a block, {smem} B, {per_sm.value} "
              f"block(s) an SM; ({B}, {H}, {Lq}, {Lk}, {d}) {ms:.4f} ms, share of bound "
              f"{bound_ms / ms:.3f}, max abs err {err:.3e}; SM clock {clock_mhz} MHz, "
              f"{power_w} W [{label}]", flush=True)
        if err > 1e-4:
            print(f"{spec}: disagrees with the plain version", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    print(label)
    line = json.dumps({"card": label, "variants": results})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
