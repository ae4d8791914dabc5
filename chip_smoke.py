#!/usr/bin/env python3
"""Smoke run of coma_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. Device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit.
2. Kernels: build the CUDA kernels from ``coma_tpu_torch/csrc/`` (one
   ``nvcc`` per source, started together; the compiler's registers and
   spills, the bf16 attention kernel's dynamic shared memory per head dim,
   and its count of ``wgmma`` (HGMMA) and TMA-load (UTMALDG) instructions in
   the compiled code are printed), then hold K1 and K2 against their plain
   PyTorch version on the card — K1 (contact splat) at the qual
   (10475x180x250), object-contact (1000x1500x250) and quant:full
   (750x2048x250) shapes, K2 (occupancy hits) at H=10475, R=30 — with a
   batch the slab does not divide, a padded slot, a zero normal and a pair on
   the singular branch. K1 tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain|
   (the kernel splats with the TPU kernel's theta^2 polynomial where sigma
   gives one, <= ~3e-7 from the exact splat, and forms t = 1 - c.g with
   fused multiply-adds); K2: equal hit counts. At the qual shape the contact
   map and the min-max-normalised orientation score of the two states are
   held against each other too (within 1e-4 of the map's maximum, within
   1e-3). Then, at the main path's slab of 32 samples, each K1 shape's
   route (polynomial or exact), the share of (h, o, sample, direction,
   patch) groups the warp-skip mask keeps, the kernel's time, the plain
   version's and the bound; K2 on a slab of i.i.d. Gaussian vertices: equal hits, its
   time, the share of tests its brick cull keeps and of accumulator elements
   it touches, and the bound of that work beside the dense bound. First, the
   host's time to make K1's splat plan for the 250-point grid (the first
   call in a process: the fit and the patch partition; then a second call).
   A kernel's time is its device time alone (``torch.profiler``); the
   wrapper's whole call, timed by CUDA events, is printed beside it.
3. Extraction: a synthetic results tree made from a numpy seed (a 10475-vertex
   human surface, 64 posed samples, a 180-point / 1500-vertex backpack) goes
   through ``coma_tpu_torch.cli.extract_coma`` at ``qual:backpack_human_contact``
   and ``qual:backpack_occupancy``. Before it, K2 runs on the tree's first 32
   posed samples as the extraction prepares them (equal hits, time, kept
   share, touched share, bounds: the main path's data). The launch counters
   are set to 0 just before the extraction and read just after; each kernel
   must have launched.
4. Inference: ``coma_tpu_torch.cli.inference`` for all four products; the
   outputs must be finite with maxima 1.0 (contact, orientation) or 0.7
   (occupancy).
4b. learn_coma: ``coma_tpu_torch.cli.learn_coma`` on a second synthetic tree
   at the published qual widths — a seeded SMPL-X-shaped npz in the official
   key layout (phase 3's 10475-vertex body and its faces, 55 joints) for
   ``downsample_human`` at 1000/1500/2000/2048/20000 points, a backpack OBJ
   downsampled at 2048/1500/180, 72 human samples carrying ``IoU``,
   ``interscetion_ratio`` and ``num_inliers`` (64 survive; 3, 2 and 2 are
   rejected by the three thresholds; one sentinel) and the four default qual
   extractions — with every kernel's counter set to 0 just before and read
   just after (K1 and K2 must launch, K3 must not). Checks: the filter's counts, the star-pose
   vertices written from the card against the CPU's LBS (within 1e-5),
   ``used_count`` 64 in each pickle, the four products' rules. Printed: each
   stage's wall clock, the card's SMPL-X forward in ms, the poisson-disk path
   (native or Python). Then phase 3's two extractions on two ranks through
   ``cli/extract_coma --multihost``, one process each: under gloo with both
   ranks on card 0 (torchrun's variables), and under NCCL with a card per rank
   where the machine has two (``COMA_*`` variables). Each is held against phase
   3's one-rank pickle (contact within 1e-5 + 1e-4 |x|; occupancy hits,
   ``used_count`` and anchor equal) and every rank must launch its kernel;
   each rank's wall clock, wait for the other rank (its first collective),
   all-reduce ms and bytes, peak device memory and launches of every kernel
   are printed beside the one-rank wall clock.
5. K3 (flash attention) against its plain version computed in fp32 from the
   same inputs, at every shape phase 6 gives it, (B, heads, Lq, Lk, D): the
   UNet's under classifier-free guidance (batch 8 for 4 images) at the 64²,
   32², 16² and 8² levels, self (8, 8, L, L, D) and cross (8, 8, L, 77, D)
   with (L, D) = (4096, 40), (1024, 80), (256, 160) and (64, 160), and the
   VAE mid block's (4, 1, 4096, 4096, 512), in bf16 on the tensor-core
   kernel ``csrc/flash_attention_sm90.cu`` (|kernel - plain| <= 5e-4 + 8e-3
   |plain|: the output is rounded to bf16 once, a relative error of at most
   2^-8, and P enters the tensor cores as two bf16 terms), and (8, 8, 1024,
   1024, 80) in float32 on ``csrc/flash_attention.cu`` (within 1e-4). A
   non-finite output raises. Then the kernel's time, the plain version's,
   ``F.scaled_dot_product_attention``'s as a yardstick (the port never calls
   it), the bound, the kernel's share of the bound (bound / kernel) and its
   ratio to SDPA (kernel / SDPA).
6. Inpainting: ``coma_tpu_torch.cli.inpaint`` at full width (SD-1.x UNet and
   VAE in bf16, CLIP ViT-L, the person segmenter; 512², 50 DDIM steps,
   guidance 7.5, mode ``p``, ``--random_weights``) on one batch of 4 images
   of a synthetic tree. The K3 counters are set to 0 just before and read
   just after: 1644 launches (16 transformer blocks x 2 attentions x 50
   steps, plus 44 VAE mid-block calls), every one of them on the bf16
   tensor-core kernel. The 4 images must be finite, in [0, 1], and
   written as 512x512 RGB PNGs. Then the tiny loop (64², f32) runs on the
   card and on the CPU from the same weights and noise and must agree within
   1e-3.

After the phases come three lines: ``{"kernels": [...]}``, the card's name
and power limit as ``nvidia-smi`` gives them, and last ``{"ok": true,
"device": {...}}``. Without a card, or without the package beside this file,
the script fails before printing any of them.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, "_smoke")  # the synthetic tree, removed at the end
DEVICE = "cuda"
SEED = 0
N_SAMPLES = 64
SLAB = 32             # the extraction's batch: one kernel launch per batch
H_FULL = 10475        # SMPL-X vertex count
OCC_O, OCC_R = 1500, 30  # qual:backpack_occupancy object vertices, voxels per side
PEAK_F32_OPS = 67e12  # H100 SXM, FP32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
K1_OPS_PER_SPLAT = 12  # dot 5, clamp 2, arccos 1, square 1, scale 1, exp 1, add 1
K2_OPS_PER_TEST = 9    # cross 5, doubling 1, subtract 1, add 1, compare 1
K1_RTOL, K1_ATOL = 1e-4, 1e-5

K1_SHAPES = (  # (name, H, O, N, hyperparameter key)
    ("qual", 10475, 180, 250, "qual:backpack_human_contact"),
    ("object_contact", 1000, 1500, 250, "qual:backpack_object_contact"),
    ("quant_full", 750, 2048, 250, "quant:full"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int):
    """(ms per call from CUDA events; device ms per call of the kernels whose
    name holds ``kernel``, and device operations per call, both from
    ``torch.profiler``), after one warm-up call. A call's events also hold
    its wrapper's other launches and, where the host issues more slowly
    than the card runs, the host's time."""
    from torch.profiler import ProfilerActivity, profile

    call_ms = cuda_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events if kernel in e.key) / reps / 1e3
    if not device_ms > 0:
        raise AssertionError(f"the profiler saw no device time of {kernel}")
    return call_ms, device_ms, sum(e.count for e in events) / reps


def bound(ops: float, nbytes: float, peak: float = PEAK_F32_OPS):
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sass_counts(source: str) -> str:
    """Tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in a built library."""
    from coma_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(source))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return f"{sass.count('HGMMA')} HGMMA, {sass.count('UTMALDG')} UTMALDG"


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def contact_inputs(rng, B, H, O):
    """Samples with a zero human normal and both singular branches."""
    hv = rng.normal(size=(B, H, 3)) * 0.3
    ov = rng.normal(size=(B, O, 3)) * 0.3
    hn = unit(rng.normal(size=(B, H, 3)))
    on = unit(rng.normal(size=(B, O, 3)))
    hn[:, 0] = 0.0
    on[:, 1] = (0.0, 0.0, -1.0)
    hn[:, 2] = (0.0, 0.0, -1.0)
    return [torch.from_numpy(np.float32(a)).to(DEVICE) for a in (hv, hn, ov, on)]


def product_diffs(kern, plain):
    """Largest difference of the contact map (relative to its maximum) and
    of the min-max-normalised orientation score between two states."""
    from coma_tpu_torch.affordance.contact import contact_map, orientational_tendency

    cm_k, cm_p = contact_map(kern, "human")["human"], contact_map(plain, "human")["human"]
    map_err = float((cm_k - cm_p).abs().max()) / float(cm_p.abs().max())
    del cm_k, cm_p
    ot_k, ot_p = orientational_tendency(kern), orientational_tendency(plain)
    orient_err = float((ot_k - ot_p).abs().max())
    if not (map_err <= 1e-4 and orient_err <= 1e-3) or not torch.isfinite(ot_k).all():
        raise AssertionError(f"K1 products: contact map differs by {map_err:.3e} of its maximum "
                             f"(limit 1e-4), orientation score by {orient_err:.3e} (limit 1e-3)")
    return map_err, orient_err


def check_k1(rng, name, H, O, N, key, products=False):
    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.affordance.state import init_coma_state
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops.contact_kernel import (fused_contact_update_batch, mask_keep_share,
                                                   polynomial_route)

    hp = get_hyperparams(key)
    init = lambda: init_coma_state(
        H, O, N, hp["spatial_grid_size"], hp["spatial_grid_thres"],
        hp["normal_gaussian_sigma"], hp["principle_vec"], hp["sub_principle_vec"],
        hp["eps"], device=DEVICE,
    )
    poly = polynomial_route(float(hp["normal_gaussian_sigma"])) is not None
    # 6 samples in slabs of 4 (4 + 2), sample 4 padded and holding NaN
    args = contact_inputs(rng, 6, H, O)
    args[0][4] = float("nan")
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32, device=DEVICE)
    kern, plain = init(), init()
    fused_contact_update_batch(kern, *args, valid=valid, slab=4)
    contact_update_batch(plain, *args, valid=valid)
    torch.cuda.synchronize()
    max_abs, max_rel, bad = 0.0, 0.0, []
    for f in ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
              "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
              "significant_contact_count", "used_count"):
        k, p = getattr(kern, f), getattr(plain, f)
        err = (k - p).abs()
        if not torch.isfinite(k).all() or bool((err > K1_ATOL + K1_RTOL * p.abs()).any()):
            bad.append(f)
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / p.abs().clamp(min=1e-6)).max()))
    if bad:
        raise AssertionError(f"K1 {name}: kernel disagrees with plain in {bad} "
                             f"(max abs {max_abs:.3e})")
    map_err, orient_err = product_diffs(kern, plain) if products else (None, None)
    del kern, plain
    torch.cuda.empty_cache()

    # timing at the main path's slab: 32 valid samples, one launch per call
    slab = contact_inputs(rng, SLAB, H, O)
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    acc = init()
    call_ms, ms, ops_per_call = kernel_ms(
        lambda: fused_contact_update_batch(acc, *slab, valid=ones, slab=SLAB),
        "contact_splat_kernel", reps=3)
    keep_share = mask_keep_share(acc, slab[1], slab[3], ones)
    plain_acc = init()
    plain_ms = cuda_ms(lambda: contact_update_batch(plain_acc, *slab, valid=ones), reps=1)
    del acc, plain_acc
    torch.cuda.empty_cache()
    splats = 2.0 * SLAB * H * O * N
    nbytes = 4.0 * (2 * 2 * H * O * N + 3 * 2 * H * O + 2 * SLAB * (H + O) * 3 + 3 * N + SLAB)
    bound_ms, bound_by = bound(K1_OPS_PER_SPLAT * splats, nbytes)
    return dict(shape=f"{name} H={H} O={O} N={N} slab={SLAB}",
                route="polynomial" if poly else "exact", mask_keep_share=keep_share,
                max_abs_err=max_abs, max_rel_err=max_rel, contact_map_err=map_err,
                orientation_err=orient_err, ms=ms, call_ms=call_ms,
                device_ops_per_call=ops_per_call, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def init_k2():
    from coma_tpu_torch.affordance.state import init_occupancy_state

    return init_occupancy_state(H_FULL, OCC_O, OCC_R, scale_tolerance=3.0, device=DEVICE)


def check_k2(rng):
    """Equal hits on 6 samples in slabs of 4 with a padded NaN sample; then
    :func:`k2_slab` on 32 i.i.d. Gaussian samples."""
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch

    inputs = lambda B: [torch.from_numpy(np.float32(rng.normal(size=(B, n, 3)) * 0.6))
                        .to(DEVICE) for n in (H_FULL, OCC_O)]
    hv, ov = inputs(6)
    hv[4] = float("nan")
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32, device=DEVICE)
    kern, plain = init_k2(), init_k2()
    fused_occupancy_update_batch(kern, hv, ov, valid=valid, slab=4)
    occupancy_update_batch(plain, hv, ov, valid=valid)
    torch.cuda.synchronize()
    differing = int((kern.spatial_occupancy_grids != plain.spatial_occupancy_grids).sum())
    max_abs = float((kern.spatial_occupancy_grids - plain.spatial_occupancy_grids).abs().max())
    hits = float(kern.spatial_occupancy_grids.sum())
    if differing or hits == 0 or not torch.equal(kern.anchor_vert, plain.anchor_vert) \
            or float(kern.used_count) != 5.0:
        raise AssertionError(f"K2: {differing} differing cells, {hits} hits, anchors "
                             f"{kern.anchor_vert.tolist()} vs {plain.anchor_vert.tolist()}")
    del kern, plain
    return dict(k2_slab(*inputs(SLAB), "i.i.d. Gaussian vertices"), max_abs_err=max_abs)


def k2_slab(hv, ov, inputs: str):
    """K2 on one slab of 32 valid samples: hits equal to the plain
    version's, both times, the tests the cull keeps and the accumulator
    elements the kernel reads and writes, and the bound of that work beside
    the dense bound."""
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch, kept_work

    H, L = H_FULL, OCC_R ** 3
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    kern, plain = init_k2(), init_k2()
    fused_occupancy_update_batch(kern, hv, ov, valid=ones, slab=SLAB)
    occupancy_update_batch(plain, hv, ov, valid=ones)
    torch.cuda.synchronize()
    differing = int((kern.spatial_occupancy_grids != plain.spatial_occupancy_grids).sum())
    if differing or float(kern.spatial_occupancy_grids.sum()) == 0:
        raise AssertionError(f"K2 on {inputs}: {differing} differing cells")
    call_ms, ms, ops_per_call = kernel_ms(
        lambda: fused_occupancy_update_batch(kern, hv, ov, valid=ones, slab=SLAB),
        "occupancy_hits_kernel", reps=5)
    plain_ms = cuda_ms(lambda: occupancy_update_batch(plain, hv, ov, valid=ones), reps=1)
    kept, dense, touched = kept_work(kern, hv, ov, ones)
    del kern, plain
    torch.cuda.empty_cache()
    inputs_bytes = 4.0 * (SLAB * H * 4 + 4 * L + SLAB)   # x and ||x||^2, grid and ||g||^2, valid
    bound_ms, bound_by = bound(K2_OPS_PER_TEST * kept, 8.0 * touched + inputs_bytes)
    dense_bound_ms, dense_bound_by = bound(K2_OPS_PER_TEST * dense, 8.0 * H * L + inputs_bytes)
    return dict(shape=f"H={H} R={OCC_R} slab={SLAB}, {inputs}", differing_cells=differing,
                kept_tests=kept, dense_tests=dense, kept_share=kept / dense,
                touched_share=touched / (H * L), ms=ms, call_ms=call_ms,
                device_ops_per_call=ops_per_call, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, dense_bound_ms=dense_bound_ms, dense_bound_by=dense_bound_by)


def log_k2(r, label):
    log(f"K2 {r['shape']}: {r['differing_cells']} differing cells; the cull keeps "
        f"{r['kept_tests']} of {r['dense_tests']} tests ({r['kept_share']:.4f}) and touches "
        f"{r['touched_share']:.4f} of the accumulator; kernel {r['ms']:.3f} ms (the wrapper's "
        f"call {r['call_ms']:.3f} ms, {r['device_ops_per_call']:.0f} device operations), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}, the kept work) "
        f"against {r['dense_bound_ms']:.3f} ms ({r['dense_bound_by']}, dense), share of bound "
        f"{r['bound_ms'] / r['ms']:.3f} [{label}]")


def time_splat_plan(key: str):
    """Host ms of K1's splat plan for the 250-point grid at ``key``'s σ: the
    first call in the process (the fit, its check and the patch partition),
    then a second call (the fit cached)."""
    from coma_tpu_torch.affordance.sphere import fibonacci_sphere
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops.contact_kernel import splat_plan

    grid = fibonacci_sphere(250).astype(np.float32)
    sigma = float(get_hyperparams(key)["normal_gaussian_sigma"])
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        splat_plan(grid, sigma)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# ---------------------------------------------------------------------------
# Phase 3: a synthetic results tree
# ---------------------------------------------------------------------------

SC, CAT, ASSET, PROMPT = "BEHAVE", "backpack", "behave_asset", "a person wearing a backpack"
RINGS, AROUND = 25, 419   # 25 x 419 = 10475 vertices


def human_template():
    """A closed-around body surface: 25 rings of 419 vertices, outward faces."""
    z = np.linspace(0.0, 1.7, RINGS)
    theta = np.linspace(0.0, 2 * np.pi, AROUND, endpoint=False)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7)
    verts = np.stack([
        radius[:, None] * np.cos(theta)[None, :],
        radius[:, None] * np.sin(theta)[None, :],
        np.broadcast_to(z[:, None], (RINGS, AROUND)),
    ], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(RINGS - 1), np.arange(AROUND), indexing="ij")
    v00, v01 = i * AROUND + j, i * AROUND + (j + 1) % AROUND
    v10, v11 = v00 + AROUND, v01 + AROUND
    faces = np.concatenate([
        np.stack([v00, v01, v11], -1).reshape(-1, 3),
        np.stack([v00, v11, v10], -1).reshape(-1, 3),
    ])
    return verts, faces.astype(np.int64)


def backpack(rng, n):
    """``n`` points on a patch 2 cm behind the body's back, normals outward."""
    theta = np.pi + rng.uniform(-0.6, 0.6, n)
    z = rng.uniform(0.8, 1.4, n)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7) + 0.02
    pts = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], -1)
    normals = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], -1)
    return pts, normals


def write_tree(root: str, rng) -> dict:
    def dump(path, payload):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(payload, fh)

    from coma_tpu_torch.core.paths import ResultsTree, SampleKey, smplx_downsample_path

    tree = ResultsTree(f"{root}/results")
    constants = f"{root}/constants/mesh"
    verts, faces = human_template()
    dump(smplx_downsample_path("FULL", constants), dict(
        N=H_FULL, N_raw=H_FULL, downsample_indices=np.arange(H_FULL)))

    obj_verts, obj_normals = backpack(rng, 2000)  # the OBJ the 1500 indices pick from
    raw_pts, raw_normals = backpack(rng, 180)
    for res, n in (("180", 180), (str(OCC_O), OCC_O)):
        dump(tree.asset_downsample(SC, CAT, ASSET, res), dict(
            obj_vertices_original=obj_verts, obj_vertex_normals_original=obj_normals,
            downsample_indices=np.sort(rng.choice(2000, n, replace=False)), N=n,
            downsampled_pcd_points_raw=raw_pts, downsampled_pcd_normal_raw=raw_normals,
            N_raw=180,
        ))

    whitelist, keys = [], []
    for k in range(N_SAMPLES):
        key = SampleKey(SC, CAT, ASSET, f"{k // 16:03d}", "0", PROMPT, f"{k % 16:05d}")
        yaw = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        posed = verts @ rot.T + rng.normal(scale=0.005, size=3) \
            + rng.normal(scale=0.002, size=verts.shape)
        dump(tree.human_sample(key), dict(verts=posed, faces=faces))
        keys.append(key)
        whitelist.append([key.view_id, key.asset_mask_id, key.prompt, key.inpaint_id])
    wl = tree.postfilter_json(SC, CAT, ASSET, PROMPT)
    os.makedirs(os.path.dirname(wl), exist_ok=True)
    with open(wl, "w") as fh:
        json.dump(whitelist, fh)
    return dict(tree=tree, constants=constants, keys=keys)


def posed_slab(paths, key: str):
    """The tree's first 32 samples as the extraction prepares them for
    ``key``: (human verts, object verts) on the card."""
    from coma_tpu_torch.affordance.io import load_pickle
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.core.paths import smplx_downsample_path
    from coma_tpu_torch.pipelines.affordance_inputs import prepare_affordance_extraction_inputs

    hp, tree = get_hyperparams(key), paths["tree"]
    human = load_pickle(smplx_downsample_path("FULL", paths["constants"]))
    obj = load_pickle(tree.asset_downsample(SC, CAT, ASSET, hp["object_res"]))
    samples = [prepare_affordance_extraction_inputs(
        tree.human_sample(k), human, obj, hp["human_use_downsample_pcd_raw"],
        hp["object_use_downsample_pcd_raw"], hp["eps"]) for k in paths["keys"][:SLAB]]
    return [torch.from_numpy(np.stack([d[f] for d in samples])).to(DEVICE)
            for f in ("human_verts", "obj_verts")]


def extract(paths, key: str, label: str):
    from coma_tpu_torch.cli import extract_coma

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    extract_coma.main([
        "--human_sample_dir", f"{paths['tree'].root}/generation/human_sample",
        "--constants_mesh_dir", paths["constants"], "--hyperparams_key", key,
        "--device", DEVICE,
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pickle_path = paths["tree"].coma_pickle(SC, CAT, ASSET, key, PROMPT)
    with open(pickle_path, "rb") as fh:
        d = pickle.load(fh)
    if d["used_count"] != N_SAMPLES:
        raise AssertionError(f"{key}: used_count {d['used_count']} != {N_SAMPLES}")
    for k, v in d.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"{key}: non-finite values in {k}")
    log(f"extract {key}: {N_SAMPLES} samples in {seconds:.3f} s = "
        f"{N_SAMPLES / seconds:.2f} samples/s (CLI wall clock: load, prep, aggregate, "
        f"export, product), peak device memory {peak_gb:.3f} GB [{label}]")
    return pickle_path, seconds


def infer(paths, coma_path, visualize_type, key, res, out_dir):
    from coma_tpu_torch.cli import inference

    return inference.main([
        "--supercategory", SC, "--category", CAT, "--coma_path", coma_path,
        "--visualize_type", visualize_type, "--hyperparams_key", key,
        "--asset_downsample_pth", paths["tree"].asset_downsample(SC, CAT, ASSET, res),
        "--output_dir", f"{out_dir}/{visualize_type}", "--device", DEVICE,
    ])


def check_product(visualize_type: str, path: str, n: int) -> str:
    """The rules for one product file: finite, max 1.0 over ``n`` human
    vertices (contact, orientation); ``n`` object points, one with the colour
    of 1.0 (object contact); an R³ field with max 0.7 (occupancy)."""
    from coma_tpu_torch.utils.colormap import jet_rgb
    from coma_tpu_torch.utils.ply import read_ply_pointcloud

    if visualize_type in ("aggr-human-contact", "orientation"):
        arr = np.load(path)
        if arr.shape != (n,) or not np.isfinite(arr).all() or arr.max() != 1.0:
            raise AssertionError(f"{visualize_type}: shape {arr.shape}, max {arr.max()}")
        return f"shape {arr.shape}, max {arr.max()}, mean {arr.mean():.4f}"
    if visualize_type == "aggr-object-contact":
        points, normals, colors = read_ply_pointcloud(path)
        top = np.round(jet_rgb(np.float32([1.0])) * 255) / 255
        if points.shape != (n, 3) or not np.isfinite(colors).all() \
                or not np.isclose(colors, top).all(-1).any():
            raise AssertionError(f"{visualize_type}: no point carries the colour of 1.0")
        return f"{len(points)} points, colour of 1.0 present"
    field = np.load(path, allow_pickle=True).item()["prob_field"]
    if field.shape != (OCC_R,) * 3 or not np.isfinite(field).all() \
            or not np.isclose(field.max(), 0.7):
        raise AssertionError(f"occupancy: shape {field.shape}, max {field.max()}")
    return f"shape {field.shape}, max {field.max()}"


def check_products(paths, contact_pickle, occupancy_pickle, out_dir):
    for vt, key in (("aggr-human-contact", "qual:backpack_human_contact"),
                    ("orientation", "qual:backpack_orientation")):
        path = infer(paths, contact_pickle, vt, key, "180", out_dir)
        log(f"inference {vt}: {check_product(vt, path, H_FULL)}")
    ply = infer(paths, contact_pickle, "aggr-object-contact", "qual:backpack_object_contact",
                "180", out_dir)
    log(f"inference aggr-object-contact: {check_product('aggr-object-contact', ply, 180)}")
    occ = infer(paths, occupancy_pickle, "occupancy", "qual:backpack_occupancy", str(OCC_O),
                out_dir)
    log(f"inference occupancy: {check_product('occupancy', occ, 0)}")


# ---------------------------------------------------------------------------
# Phase 4b: learn_coma through the CLI; phase 3's extractions on two ranks
# ---------------------------------------------------------------------------

# SMPL-X's kinematic tree (55 joints: body, jaw and eyes, 2 x 15 hand joints)
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
                 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53]
LEARN_METRICS = (  # (IoU, interscetion_ratio, num_inliers, samples): survivors, then rejects
    (0.9, 0.01, 5, N_SAMPLES), (0.5, 0.01, 5, 3), (0.9, 0.2, 5, 2), (0.9, 0.01, 0, 2))
LEARN_KEYS = ("qual:backpack_human_contact", "qual:backpack_object_contact",
              "qual:backpack_occupancy", "qual:backpack_orientation")
STAR_ATOL = 1e-5
RANK_RTOL, RANK_ATOL = 1e-4, 1e-5
RANK_TIMEOUT_S = 600


def write_smplx_npz(path: str, rng) -> None:
    """A seeded SMPL-X-shaped model in the official npz layout at the
    published widths: the phase 3 body (10475 vertices and its faces), 55
    joints, 400 shape and expression directions, posedirs (10475, 3, 486),
    12 hand PCA components. Skinning weights lean on the root (0.9), so the
    star pose bends the surface without tearing it."""
    verts, faces = human_template()
    V, J = len(verts), len(SMPLX_PARENTS)
    weights = 0.1 * rng.dirichlet(np.ones(J), size=V)
    weights[:, 0] += 0.9
    np.savez(
        path, v_template=verts, shapedirs=np.float32(rng.normal(size=(V, 3, 400)) * 1e-3),
        posedirs=np.float32(rng.normal(size=(V, 3, 486)) * 1e-3),
        J_regressor=rng.dirichlet(np.ones(V), size=J), weights=weights,
        kintree_table=np.stack([SMPLX_PARENTS, np.arange(J)]).astype(np.int64),
        hands_meanl=rng.normal(size=45) * 0.1, hands_meanr=rng.normal(size=45) * 0.1,
        hands_componentsl=rng.normal(size=(12, 45)), hands_componentsr=rng.normal(size=(12, 45)),
        f=faces.astype(np.uint32),
    )


def backpack_mesh(n_around: int = 40, n_up: int = 30):
    """The phase 3 backpack patch as a mesh 2 cm behind the body's back,
    faces wound outward."""
    theta = np.linspace(np.pi - 0.6, np.pi + 0.6, n_around)
    z = np.linspace(0.8, 1.4, n_up)
    radius = 0.3 + 0.05 * np.sin(np.pi * z / 1.7) + 0.02
    verts = np.stack([radius[:, None] * np.cos(theta), radius[:, None] * np.sin(theta),
                      np.broadcast_to(z[:, None], (n_up, n_around))], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_up - 1), np.arange(n_around - 1), indexing="ij")
    v00, v01 = i * n_around + j, i * n_around + j + 1
    v10, v11 = v00 + n_around, v01 + n_around
    faces = np.concatenate([np.stack([v00, v01, v11], -1).reshape(-1, 3),
                            np.stack([v00, v11, v10], -1).reshape(-1, 3)])
    return verts, faces


def write_learn_tree(root: str, rng) -> dict:
    """The learn_coma inputs under ``root``: ``smplx.npz``, ``backpack.obj``
    and the human samples with their filter metrics, one sentinel among them."""
    from coma_tpu_torch.geometry.mesh import save_obj

    write_smplx_npz(f"{root}/smplx.npz", rng)
    save_obj(f"{root}/backpack.obj", *backpack_mesh())
    verts, faces = human_template()
    samples = [m[:3] for m in LEARN_METRICS for _ in range(m[3])] + [None]
    for k, metrics in enumerate(samples):
        d = f"{root}/results/generation/human_sample/{SC}/{CAT}/{ASSET}/{k // 16:03d}/0/{PROMPT}"
        os.makedirs(d, exist_ok=True)
        yaw = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        payload = "NO HUMANS" if metrics is None else dict(
            verts=verts @ rot.T + rng.normal(scale=0.005, size=3)
            + rng.normal(scale=0.002, size=verts.shape), faces=faces,
            IoU=metrics[0], interscetion_ratio=metrics[1], num_inliers=metrics[2])
        with open(f"{d}/{k % 16:05d}.pickle", "wb") as fh:
            pickle.dump(payload, fh)
    return dict(root=root, samples=len(samples))


def star_pose_check(npz: str, star_pickle: str, label: str):
    """The star template learn_coma wrote (from the card) against the CPU's
    LBS on the same npz, within 1e-5; then the card's SMPL-X forward in ms."""
    from coma_tpu_torch.models.smplx import SMPLXModel, star_pose_vertices

    with open(star_pickle, "rb") as fh:
        card = pickle.load(fh)["vertices"]
    cpu = star_pose_vertices(SMPLXModel.from_npz(npz, device="cpu")).numpy()
    err = float(np.abs(card - cpu).max())
    if card.shape != (H_FULL, 3) or not err <= STAR_ATOL:
        raise AssertionError(f"star pose: card vs CPU max abs {err:.3e} (limit {STAR_ATOL:.0e})")
    model = SMPLXModel.from_npz(npz, device=DEVICE)
    ms = cuda_ms(lambda: star_pose_vertices(model), reps=10)
    log(f"SMPL-X star pose (V={H_FULL}, 55 joints, posedirs {tuple(model.posedirs.shape)}): card "
        f"vs CPU max abs {err:.3e} (limit {STAR_ATOL:.0e}); forward {ms:.3f} ms on the card [{label}]")
    return err, ms


def learn_coma(root: str, label: str) -> dict:
    """``cli/learn_coma`` on the tree, every kernel's counter from 0; the
    checks: the filter's rejections, K1 and K2 launched and K3 not, the star
    pose, ``used_count`` equal to the survivors in each pickle, the four
    products' rules."""
    from coma_tpu_torch import native
    from coma_tpu_torch.cli import learn_coma as cli
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel

    cwd = os.getcwd()
    os.chdir(root)
    try:
        contact_kernel.launches = 0
        occupancy_kernel.launches = 0
        attention.launches = 0
        t0 = time.perf_counter()
        out = cli.main(["--smplx_model_path", "smplx.npz", "--obj_pth", "backpack.obj",
                        "--supercategory", SC, "--category", CAT, "--asset_id", ASSET,
                        "--device", DEVICE])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"contact_splat": contact_kernel.launches,
                    "occupancy_hits": occupancy_kernel.launches,
                    "flash_attention": attention.launches}
    finally:
        os.chdir(cwd)
    survivors = LEARN_METRICS[0][3]
    want = dict(rejected_iou=LEARN_METRICS[1][3], rejected_intersection=LEARN_METRICS[2][3],
                rejected_inliers=LEARN_METRICS[3][3])
    if {k: out["filter"][k] for k in want} != want or out["filter"]["leftover"] != survivors:
        raise AssertionError(f"filter: {out['filter']}, expected {want}")
    if not (launches["contact_splat"] and launches["occupancy_hits"]) \
            or launches["flash_attention"]:
        raise AssertionError(f"learn_coma must launch K1 and K2, not K3: {launches}")
    log(f"learn_coma: {seconds:.3f} s, stages " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out["seconds"].items()) + f"; poisson-disk elimination: "
        f"{native.path_name()}; filter {out['filter']}; launches {launches} [{label}]")
    star = star_pose_check(f"{root}/smplx.npz", f"{root}/constants/mesh/smplx_star.pickle",
                           label)
    tree = f"{root}/results/coma"
    for key in LEARN_KEYS:
        with open(f"{tree}/extracted_coma/{SC}/{CAT}/{ASSET}/{key}:{PROMPT}.pickle", "rb") as fh:
            d = pickle.load(fh)
        if d["used_count"] != survivors:
            raise AssertionError(f"learn_coma {key}: used_count {d['used_count']} != {survivors}")
        (product,) = out[f"extract ({key})"]
        vt = get_hyperparams(key)["visualize_type"]
        n = d["obj_res"] if vt == "aggr-object-contact" else d["human_res"]
        log(f"learn_coma {key}: used_count {d['used_count']}, H={d['human_res']}, "
            f"O={d['obj_res']}; {vt}: {check_product(vt, os.path.join(root, product), n)} "
            f"[{label}]")
        del d
    return dict(seconds=seconds, stage_seconds=out["seconds"], launches=launches,
                star_pose_max_abs_err=star[0], smplx_forward_ms=star[1],
                native=native.path_name())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def extract_on_ranks(paths, key: str, backend: str, world: int, style: str, label: str):
    """``cli/extract_coma --multihost`` in ``world`` processes (launch
    variables of ``style``: torchrun's or COMA_*); returns (wall clock of the
    processes, each rank's report)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO)
        if style == "torchrun":
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        else:
            env.update(COMA_COORDINATOR=f"localhost:{port}", COMA_NUM_PROCESSES=str(world),
                       COMA_PROCESS_ID=str(rank))
        cmd = [sys.executable, "-m", "coma_tpu_torch.cli.extract_coma", "--multihost",
               "--dist_backend", backend, "--device", DEVICE,
               "--human_sample_dir", f"{paths['tree'].root}/generation/human_sample",
               "--constants_mesh_dir", paths["constants"], "--hyperparams_key", key]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{world} ranks ({backend}) {key} failed:\n" + "\n".join(
            o[-3000:] for o in outs))
    reports = []
    for out in outs:
        lines = [json.loads(l)["extract_rank"] for l in out.splitlines()
                 if l.startswith('{"extract_rank"')]
        if len(lines) != 1:
            raise AssertionError(f"a rank printed {len(lines)} reports:\n{out[-3000:]}")
        reports.append(lines[0])
    return seconds, sorted(reports, key=lambda r: r["rank"])


def compare_rank_pickle(key: str, got_path: str, want_path: str) -> dict:
    """The ranks' pickle against the single process's: contact fields within
    1e-5 + 1e-4 |x| (on the card), occupancy hits, counts and anchor equal."""
    with open(got_path, "rb") as fh:
        got = pickle.load(fh)
    with open(want_path, "rb") as fh:
        want = pickle.load(fh)
    if got["used_count"] != want["used_count"]:
        raise AssertionError(f"{key}: used_count {got['used_count']} != {want['used_count']}")
    if "spatial_occupancy_grids" in want:
        differing = int((got["spatial_occupancy_grids"] != want["spatial_occupancy_grids"]).sum())
        if differing or not np.array_equal(got["debug_obj_vert"], want["debug_obj_vert"]):
            raise AssertionError(f"{key}: {differing} differing occupancy cells, anchors "
                                 f"{got['debug_obj_vert']} vs {want['debug_obj_vert']}")
        return dict(differing_cells=0, max_abs_err=0.0)
    worst = 0.0
    for f in ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
              "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
              "significant_contact_count"):
        a = torch.from_numpy(got[f]).to(DEVICE)
        b = torch.from_numpy(want[f]).to(DEVICE)
        err = (a - b).abs()
        if bool((err > RANK_ATOL + RANK_RTOL * b.abs()).any()) or not torch.isfinite(a).all():
            raise AssertionError(f"{key}: the ranks' {f} differs by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        del a, b, err
    return dict(max_abs_err=worst)


def extractions_on_two_ranks(paths, single: dict, label: str) -> list:
    """Phase 3's two extractions on two ranks, each against phase 3's pickle:
    under gloo with both ranks on card 0, and under NCCL with a card per
    rank where the machine has two. Every rank must launch its kernel."""
    runs = [("gloo", "torchrun")] + ([("nccl", "coma")] if torch.cuda.device_count() >= 2 else [])
    if len(runs) == 1:
        log(f"NCCL on two ranks: skipped, {torch.cuda.device_count()} card(s) on this machine "
            f"[{label}]")
    results = []
    for backend, style in runs:
        for key, kernel in (("qual:backpack_human_contact", "contact_splat"),
                            ("qual:backpack_occupancy", "occupancy_hits")):
            seconds, reports = extract_on_ranks(paths, key, backend, 2, style, label)
            launches = [r["launches"][kernel] for r in reports]
            if len(reports) != 2 or not all(n > 0 for n in launches):
                raise AssertionError(f"{backend} {key}: {kernel} launches per rank {launches}")
            diff = compare_rank_pickle(key, single[key]["path"], single[key]["single_path"])
            one = single[key]["seconds"]
            log(f"2 ranks ({backend}, {style} variables) {key}: processes {seconds:.3f} s, "
                f"in-process CLI " + ", ".join(f"rank {r['rank']} {r['seconds']:.3f} s" for r in reports)
                + f" against one rank's {one:.3f} s (phase 3); equal to one rank's pickle "
                f"({diff}); " + "; ".join(
                    f"rank {r['rank']} on {r['device']}: launches {r['launches']}, "
                    f"waited {r['wait_ms']:.3f} ms for the other rank (the sample count's "
                    f"all-reduce), then all-reduce "
                    f"{r['allreduce_ms']:.3f} ms for {r['allreduce_bytes']} bytes, "
                    f"peak device memory {r['peak_device_gb']} GB" for r in reports)
                + f" [{label}]")
            results.append(dict(backend=backend, key=key, seconds=seconds, one_rank_seconds=one,
                                ranks=reports, **diff))
    return results


# ---------------------------------------------------------------------------
# Phase 5: K3 (flash attention) against its plain version
# ---------------------------------------------------------------------------

PEAK_BF16_OPS = 989e12   # H100 SXM, dense bf16 tensor cores (data sheet)
K3_SHAPES = (  # (name, B, H, Lq, Lk, D, dtype): phase 6's, CFG doubling the UNet's batch
    ("unet_self_64x64", 8, 8, 4096, 4096, 40, torch.bfloat16),
    ("unet_cross_64x64", 8, 8, 4096, 77, 40, torch.bfloat16),
    ("unet_self_32x32", 8, 8, 1024, 1024, 80, torch.bfloat16),
    ("unet_cross_32x32", 8, 8, 1024, 77, 80, torch.bfloat16),
    ("unet_self_16x16", 8, 8, 256, 256, 160, torch.bfloat16),
    ("unet_cross_16x16", 8, 8, 256, 77, 160, torch.bfloat16),
    ("unet_mid_self_8x8", 8, 8, 64, 64, 160, torch.bfloat16),
    ("unet_mid_cross_8x8", 8, 8, 64, 77, 160, torch.bfloat16),
    ("vae_mid", 4, 1, 4096, 4096, 512, torch.bfloat16),
    ("unet_self_32x32_f32", 8, 8, 1024, 1024, 80, torch.float32),
)
K3_BF16_ATOL, K3_BF16_RTOL, K3_F32_ATOL = 5e-4, 8e-3, 1e-4


def check_k3(rng, name, B, H, Lq, Lk, D, dtype):
    """Kernel vs the plain version computed in fp32 from the same inputs;
    times of the kernel, the plain version (in the input dtype) and SDPA."""
    import torch.nn.functional as F

    from coma_tpu_torch.ops.attention import KERNELS, attention_reference, scaled_dot_attention

    q, k, v = (torch.from_numpy(np.float32(rng.normal(size=(B, H, n, D)))).to(DEVICE, dtype)
               for n in (Lq, Lk, Lk))
    out = scaled_dot_attention(q, k, v)
    want = attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    rtol = K3_BF16_RTOL if dtype == torch.bfloat16 else 0.0
    atol = K3_BF16_ATOL if dtype == torch.bfloat16 else K3_F32_ATOL
    max_abs = float(err.max())
    atol_used = float((err - rtol * want.abs()).max())   # the least atol that passes
    if atol_used > atol or not torch.isfinite(out).all():
        raise AssertionError(f"K3 {name}: kernel disagrees with plain (max abs {max_abs:.3e}, "
                             f"needs atol {atol_used:.3e} > {atol:.0e} with rtol {rtol:.0e})")
    del out, want, err
    ms = cuda_ms(lambda: scaled_dot_attention(q, k, v), reps=10)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=10)
    torch.cuda.empty_cache()
    size = torch.finfo(dtype).bits // 8
    nbytes = size * B * H * (2 * Lq + 2 * Lk) * D
    peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
    bound_ms, bound_by = bound(4.0 * B * H * Lq * Lk * D, nbytes, peak)
    return dict(shape=f"{name} ({B}, {H}, {Lq}, {Lk}, {D}) {str(dtype)[6:]}",
                source=f"coma_tpu_torch/csrc/{KERNELS[dtype][0]}.cu",
                max_abs_err=max_abs, atol_used=atol_used, atol=atol, rtol=rtol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, ratio_to_sdpa=ms / library_ms)


# ---------------------------------------------------------------------------
# Phase 6: inpainting through the CLI, and a tiny loop against the CPU
# ---------------------------------------------------------------------------

INPAINT_RES, INPAINT_IMAGES = 512, 4   # 1 mask x 1 prompt x 2 view texts x 2 seeds
K3_LAUNCHES_PER_BATCH = 50 * 32 + 44   # UNet: 16 blocks x 2 attentions x 50 steps; VAE: 44


def write_inpaint_tree(root: str, rng) -> None:
    """A render, an asset mask, its valid-mask pickle and one prompt."""
    from coma_tpu_torch.utils.png import write_png

    res, view = INPAINT_RES, "view:00000"
    g = f"{root}/results/generation"
    base = f"{SC}/{CAT}/{ASSET}"
    for d in (f"renders/{base}", f"valid_masks/{base}", f"prompts/{base}",
              f"asset_masks/{base}/{view}"):
        os.makedirs(f"{g}/{d}", exist_ok=True)
    yy, xx = np.mgrid[:res, :res] / res
    render = np.stack([yy, xx, 0.5 + 0.5 * np.sin(6 * xx)], -1) * 200 \
        + rng.integers(0, 55, size=(res, res, 3))
    write_png(f"{g}/renders/{base}/{view}.png", np.uint8(render))
    mask = np.zeros((res, res), np.uint8)
    mask[res // 8: 7 * res // 8, res // 4: 3 * res // 4] = 255
    write_png(f"{g}/asset_masks/{base}/{view}/0.png", mask)
    with open(f"{g}/valid_masks/{base}/{view}.pickle", "wb") as fh:
        pickle.dump({"valid_mask_ids": [0]}, fh)
    with open(f"{g}/prompts/{base}/prompts.pickle", "wb") as fh:
        pickle.dump({"prompts": [PROMPT]}, fh)


def inpaint(root: str, label: str):
    """``cli/inpaint`` at full width; returns (seconds, peak GB, outputs)."""
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.models.diffusion.pipeline import AdaptiveMaskInpaintPipeline
    from coma_tpu_torch.utils.png import read_png

    outputs, generate = [], AdaptiveMaskInpaintPipeline.generate

    def kept(self, *args, **kwargs):     # keep the float images for the finiteness check
        out = generate(self, *args, **kwargs)
        outputs.append(out.float().cpu())
        return out

    AdaptiveMaskInpaintPipeline.generate = kept
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(["--random_weights", "--device", DEVICE, "--num_img_per_combination", "2",
                  "--batch_size", str(INPAINT_IMAGES), "--adaptive_mask_model_type", "p"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        AdaptiveMaskInpaintPipeline.generate = generate
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pngs = sorted(Path(root, "results", "generation", "inpaintings").rglob("*.png"))
    if len(pngs) != INPAINT_IMAGES or len(outputs) != 1:
        raise AssertionError(f"inpaint wrote {len(pngs)} images in {len(outputs)} batches")
    for p in pngs:
        img = read_png(str(p))
        if img.shape != (INPAINT_RES, INPAINT_RES, 3):
            raise AssertionError(f"{p}: shape {img.shape}")
    out = outputs[0]
    if out.shape != (INPAINT_IMAGES, 3, INPAINT_RES, INPAINT_RES) or not torch.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"inpaint output: shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    log(f"inpaint {INPAINT_IMAGES} images at {INPAINT_RES}², bf16, 50 steps, mode p: "
        f"{seconds:.3f} s = {INPAINT_IMAGES / seconds:.4f} images/s (CLI wall clock: models "
        f"made from a seed, prompts, the loop, PNGs), peak device memory {peak_gb:.3f} GB "
        f"[{label}]")
    return seconds, peak_gb, out


def tiny_loop_against_cpu():
    """The tiny f32 loop ('baseline' mode, no segmenter) on the card, K3
    included, against the same loop on the CPU with the plain attention; the
    same weights and noise. cuDNN's TF32 is switched off for this comparison."""
    import copy

    from coma_tpu_torch.models.diffusion import pipeline, unet, vae
    from coma_tpu_torch.models.layers import init_flax_default_

    g = torch.Generator().manual_seed(SEED)
    models = [init_flax_default_(unet.UNet2DCondition(unet.tiny_unet_config()), g),
              init_flax_default_(vae.Encoder(vae.tiny_vae_config()), g),
              init_flax_default_(vae.Decoder(vae.tiny_vae_config()), g)]
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(np.float32(rng.uniform(-1, 1, size=(2, 3, 64, 64))))
    mask = torch.zeros(2, 64, 64)
    mask[:, 8:56, 12:52] = 1.0
    ctx = torch.from_numpy(np.float32(rng.normal(size=(2, 7, 32))))
    outs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", DEVICE):
            m = [copy.deepcopy(x).to(dev).eval() for x in models]
            pipe = pipeline.AdaptiveMaskInpaintPipeline(
                *m, None, pipeline.AdaptiveMaskConfig(use_adaptive_mask=False))
            noise = pipeline.TorchNoise(torch.Generator().manual_seed(SEED + 1))
            outs.append(pipe.generate(image.to(dev), mask.to(dev), ctx.to(dev),
                                      ctx.to(dev) * 0, noise=noise).cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((outs[0] - outs[1]).abs().max())
    if not torch.isfinite(outs[1]).all() or err > 1e-3:
        raise AssertionError(f"tiny loop: card vs CPU max abs {err:.3e} (limit 1e-3)")
    log(f"tiny loop (64², f32, 50 steps) on the card vs the CPU: max abs {err:.3e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "coma_tpu_torch")):
        print("chip_smoke: coma_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from coma_tpu_torch.ops import attention, build, contact_kernel, occupancy_kernel

    # phase 1: device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    label = card_label()
    log(f"device: {name}, count {count}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build, then kernels against their plain versions
    t0 = time.perf_counter()
    build.build_all()
    log(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src in build.SOURCES:
        if build.log_path(src).exists():
            for line in build.log_path(src).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    log("  flash_attention_sm90 dynamic shared memory per block: " + ", ".join(
        f"D={d} {attention.shared_memory_bytes(d)} B" for d in attention.HEAD_DIMS))
    log(f"  flash_attention_sm90 compiled code: {sass_counts('flash_attention_sm90')}")
    plan_ms = time_splat_plan(K1_SHAPES[0][4])
    log(f"K1 splat plan, 250-point grid, host: {plan_ms[0]:.3f} ms on the first call in the "
        f"process (fit, check, partition), {plan_ms[1]:.3f} ms on a second")
    rng = np.random.default_rng(SEED)
    k1 = []
    for shape in K1_SHAPES:
        r = check_k1(rng, *shape, products=shape[0] == "qual")
        k1.append(r)
        log(f"K1 {r['shape']}: {r['route']} route, max abs err {r['max_abs_err']:.3e}, "
            f"max rel err {r['max_rel_err']:.3e}; mask keeps {r['mask_keep_share']:.4f} of the "
            f"(h, o, sample, direction, patch) groups; kernel {r['ms']:.3f} ms (the wrapper's "
            f"call {r['call_ms']:.3f} ms, {r['device_ops_per_call']:.0f} device operations), "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"share of bound {r['bound_ms'] / r['ms']:.3f} [{label}]")
        if r["contact_map_err"] is not None:
            log(f"K1 {r['shape']}: kernel vs plain state, contact map max diff "
                f"{r['contact_map_err']:.3e} of its maximum (limit 1e-4), orientation score "
                f"max diff {r['orientation_err']:.3e} (limit 1e-3)")
    k2_iid = check_k2(rng)
    log_k2(k2_iid, label)

    # phase 3: K2 on the extraction's posed samples, then the extraction
    # through the CLI with the launch counters from 0
    os.makedirs(SCRATCH, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tree_", dir=SCRATCH) as tmp:
        paths = write_tree(tmp, np.random.default_rng(SEED + 1))
        k2 = k2_slab(*posed_slab(paths, "qual:backpack_occupancy"),
                     "the extraction's first 32 posed samples")
        log_k2(k2, label)
        contact_kernel.launches = 0
        occupancy_kernel.launches = 0
        single = {key: dict(zip(("path", "seconds"), extract(paths, key, label)))
                  for key in ("qual:backpack_human_contact", "qual:backpack_occupancy")}
        launches = {"contact_splat": contact_kernel.launches,
                    "occupancy_hits": occupancy_kernel.launches}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        log(f"launches on the extraction path: {launches}")

        # phase 4: inference for all four products
        check_products(paths, single["qual:backpack_human_contact"]["path"],
                       single["qual:backpack_occupancy"]["path"], f"{tmp}/output")

        # phase 4b: learn_coma through the CLI (K1/K2 counters from 0), then
        # phase 3's extractions on two ranks against phase 3's pickles
        with tempfile.TemporaryDirectory(prefix="learn_", dir=SCRATCH) as learn_tmp:
            write_learn_tree(learn_tmp, np.random.default_rng(SEED + 3))
            learned = learn_coma(learn_tmp, label)
        for run in single.values():
            run["single_path"] = run["path"] + ".one_rank"
            os.replace(run["path"], run["single_path"])
        ranked = extractions_on_two_ranks(paths, single, label)
        per_rank = {kernel: [dict(backend=r["backend"], key=r["key"], rank=rank["rank"],
                                  launches=rank["launches"][kernel])
                             for r in ranked for rank in r["ranks"]]
                    for kernel in ("contact_splat", "occupancy_hits", "flash_attention")}

    # phase 5: K3 against its plain version
    k3 = []
    for shape in K3_SHAPES:
        r = check_k3(rng, *shape)
        k3.append(r)
        log(f"K3 {r['shape']}: max abs err {r['max_abs_err']:.3e}, least passing atol "
            f"{r['atol_used']:.3e} (limit {r['atol']:.0e} + {r['rtol']:.0e} |plain|); "
            f"kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
            f"{r['share_of_bound']:.3f}, kernel/SDPA {r['ratio_to_sdpa']:.3f} [{label}]")

    # phase 6: inpainting through the CLI, the K3 counter from 0; then the
    # tiny loop on the card against the CPU
    with tempfile.TemporaryDirectory(prefix="inpaint_", dir=SCRATCH) as tmp:
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2))
        attention.launches = 0
        for src in attention.source_launches:
            attention.source_launches[src] = 0
        inpaint(tmp, label)
        launches["flash_attention"] = attention.launches
        by_source = dict(attention.source_launches)
    log(f"launches on the inpainting path: flash_attention {launches['flash_attention']} "
        f"({by_source})")
    if launches["flash_attention"] != K3_LAUNCHES_PER_BATCH \
            or by_source["flash_attention_sm90"] != K3_LAUNCHES_PER_BATCH:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"({by_source}), expected {K3_LAUNCHES_PER_BATCH}, all bf16")
    tiny_loop_against_cpu()

    k1_main = k1[0]
    kernels = [
        dict(name="contact_splat", route="cuda", source="coma_tpu_torch/csrc/contact_splat.cu",
             replaces="coma_tpu/ops/contact_kernel.py:405",
             launches=launches["contact_splat"],
             max_abs_err=max(r["max_abs_err"] for r in k1),
             max_rel_err=max(r["max_rel_err"] for r in k1),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=None, shape=k1_main["shape"], shapes=k1,
             launches_learn_coma=learned["launches"]["contact_splat"],
             launches_per_rank=per_rank["contact_splat"]),
        dict(name="occupancy_hits", route="cuda", source="coma_tpu_torch/csrc/occupancy_hits.cu",
             replaces="coma_tpu/ops/occupancy_kernel.py:77",
             launches=launches["occupancy_hits"], max_abs_err=k2_iid["max_abs_err"],
             differing_cells=k2["differing_cells"] + k2_iid["differing_cells"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"], bound_by=k2["bound_by"],
             library_ms=None, dense_bound_ms=k2["dense_bound_ms"], kept_share=k2["kept_share"],
             touched_share=k2["touched_share"], shape=k2["shape"], shapes=[k2, k2_iid],
             launches_learn_coma=learned["launches"]["occupancy_hits"],
             launches_per_rank=per_rank["occupancy_hits"]),
        dict(name="flash_attention", route="cuda",
             source="coma_tpu_torch/csrc/flash_attention_sm90.cu",
             replaces="coma_tpu/ops/attention.py:41",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k3),
             ms=k3[0]["ms"], plain_ms=k3[0]["plain_ms"], bound_ms=k3[0]["bound_ms"],
             bound_by=k3[0]["bound_by"], library_ms=k3[0]["library_ms"], shape=k3[0]["shape"],
             launches_by_source=by_source, shapes=k3,
             launches_learn_coma=learned["launches"]["flash_attention"],
             launches_per_rank=per_rank["flash_attention"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
