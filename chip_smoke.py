#!/usr/bin/env python3
"""Smoke run of coma_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. Device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit.
2. Kernels: build both CUDA kernels from ``coma_tpu_torch/csrc/`` (one
   ``nvcc`` per source, started together) and hold each against its plain
   PyTorch version on the card — K1 (contact splat) at the qual
   (10475x180x250), object-contact (1000x1500x250) and quant:full
   (750x2048x250) shapes, K2 (occupancy hits) at H=10475, R=30 — with a
   batch the slab does not divide, a padded slot, a zero normal and a pair on
   the singular branch. K1 tolerance: |kernel - plain| <= 1e-5 + 1e-4 |plain|
   (the kernel may fuse multiply-adds in the canonicalization); K2: equal
   hit counts. Then the kernel's time (CUDA events, after a warm-up), the
   plain version's and the bound, at the main path's slab of 32 samples.
3. Extraction: a synthetic results tree made from a numpy seed (a 10475-vertex
   human surface, 64 posed samples, a 180-point / 1500-vertex backpack) goes
   through ``coma_tpu_torch.cli.extract_coma`` at ``qual:backpack_human_contact``
   and ``qual:backpack_occupancy``. The launch counters are set to 0 just
   before and read just after; each kernel must have launched.
4. Inference: ``coma_tpu_torch.cli.inference`` for all four products; the
   outputs must be finite with maxima 1.0 (contact, orientation) or 0.7
   (occupancy).
5. K3 (flash attention, ``csrc/flash_attention.cu``) against its plain
   version computed in fp32 from the same inputs, at every shape phase 6
   gives it, (B, heads, Lq, Lk, D): the UNet's under classifier-free
   guidance (batch 8 for 4 images) at the 64², 32², 16² and 8² levels,
   self (8, 8, L, L, D) and cross (8, 8, L, 77, D) with (L, D) = (4096, 40),
   (1024, 80), (256, 160) and (64, 160), and the VAE mid block's (4, 1, 4096,
   4096, 512), in bf16 (|kernel - plain| <= 5e-4 + 8e-3 |plain|: the output
   is rounded to bf16 once, a relative error of at most 2^-8), and (8, 8,
   1024, 1024, 80) in float32 (within 1e-4). Then the kernel's time, the
   plain version's, ``F.scaled_dot_product_attention``'s as a yardstick (the
   port never calls it) and the bound.
6. Inpainting: ``coma_tpu_torch.cli.inpaint`` at full width (SD-1.x UNet and
   VAE in bf16, CLIP ViT-L, the person segmenter; 512², 50 DDIM steps,
   guidance 7.5, mode ``p``, ``--random_weights``) on one batch of 4 images
   of a synthetic tree. The K3 counter is set to 0 just before and read just
   after: it must be 1644 (16 transformer blocks x 2 attentions x 50 steps,
   plus 44 VAE mid-block calls). The 4 images must be finite, in [0, 1], and
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


def bound(ops: float, nbytes: float, peak: float = PEAK_F32_OPS):
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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


def check_k1(rng, name, H, O, N, key):
    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.affordance.state import init_coma_state
    from coma_tpu_torch.config.hyperparams import get_hyperparams
    from coma_tpu_torch.ops.contact_kernel import fused_contact_update_batch

    hp = get_hyperparams(key)
    init = lambda: init_coma_state(
        H, O, N, hp["spatial_grid_size"], hp["spatial_grid_thres"],
        hp["normal_gaussian_sigma"], hp["principle_vec"], hp["sub_principle_vec"],
        hp["eps"], device=DEVICE,
    )
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
    del kern, plain
    if bad:
        raise AssertionError(f"K1 {name}: kernel disagrees with plain in {bad} "
                             f"(max abs {max_abs:.3e})")

    # timing at the main path's slab: 32 valid samples, one launch per call
    slab = contact_inputs(rng, SLAB, H, O)
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    acc = init()
    ms = cuda_ms(lambda: fused_contact_update_batch(acc, *slab, valid=ones, slab=SLAB), reps=3)
    plain_acc = init()
    plain_ms = cuda_ms(lambda: contact_update_batch(plain_acc, *slab, valid=ones), reps=1)
    del acc, plain_acc
    torch.cuda.empty_cache()
    splats = 2.0 * SLAB * H * O * N
    nbytes = 4.0 * (2 * 2 * H * O * N + 3 * 2 * H * O + 2 * SLAB * (H + O) * 3 + 3 * N + SLAB)
    bound_ms, bound_by = bound(K1_OPS_PER_SPLAT * splats, nbytes)
    return dict(shape=f"{name} H={H} O={O} N={N} slab={SLAB}", max_abs_err=max_abs,
                max_rel_err=max_rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_k2(rng):
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
    from coma_tpu_torch.affordance.state import init_occupancy_state
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch

    H, O, R = H_FULL, OCC_O, OCC_R
    init = lambda: init_occupancy_state(H, O, R, scale_tolerance=3.0, device=DEVICE)
    inputs = lambda B: [torch.from_numpy(np.float32(rng.normal(size=(B, n, 3)) * 0.6))
                        .to(DEVICE) for n in (H, O)]
    hv, ov = inputs(6)
    hv[4] = float("nan")
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32, device=DEVICE)
    kern, plain = init(), init()
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

    hv, ov = inputs(SLAB)
    ones = torch.ones(SLAB, dtype=torch.float32, device=DEVICE)
    acc = init()
    ms = cuda_ms(lambda: fused_occupancy_update_batch(acc, hv, ov, valid=ones, slab=SLAB), reps=5)
    plain_acc = init()
    plain_ms = cuda_ms(lambda: occupancy_update_batch(plain_acc, hv, ov, valid=ones), reps=1)
    del acc, plain_acc
    torch.cuda.empty_cache()
    L = R ** 3
    nbytes = 4.0 * (2 * H * L + SLAB * H * 4 + 4 * L + SLAB)
    bound_ms, bound_by = bound(K2_OPS_PER_TEST * SLAB * H * L, nbytes)
    return dict(shape=f"H={H} R={R} slab={SLAB}", max_abs_err=max_abs, differing_cells=differing,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


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

    whitelist = []
    for k in range(N_SAMPLES):
        key = SampleKey(SC, CAT, ASSET, f"{k // 16:03d}", "0", PROMPT, f"{k % 16:05d}")
        yaw = rng.uniform(-0.1, 0.1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        posed = verts @ rot.T + rng.normal(scale=0.005, size=3) \
            + rng.normal(scale=0.002, size=verts.shape)
        dump(tree.human_sample(key), dict(verts=posed, faces=faces))
        whitelist.append([key.view_id, key.asset_mask_id, key.prompt, key.inpaint_id])
    wl = tree.postfilter_json(SC, CAT, ASSET, PROMPT)
    os.makedirs(os.path.dirname(wl), exist_ok=True)
    with open(wl, "w") as fh:
        json.dump(whitelist, fh)
    return dict(tree=tree, constants=constants)


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
    return pickle_path


def infer(paths, coma_path, visualize_type, key, res, out_dir):
    from coma_tpu_torch.cli import inference

    return inference.main([
        "--supercategory", SC, "--category", CAT, "--coma_path", coma_path,
        "--visualize_type", visualize_type, "--hyperparams_key", key,
        "--asset_downsample_pth", paths["tree"].asset_downsample(SC, CAT, ASSET, res),
        "--output_dir", f"{out_dir}/{visualize_type}", "--device", DEVICE,
    ])


def check_products(paths, contact_pickle, occupancy_pickle, out_dir):
    from coma_tpu_torch.utils.colormap import jet_rgb
    from coma_tpu_torch.utils.ply import read_ply_pointcloud

    for vt, key in (("aggr-human-contact", "qual:backpack_human_contact"),
                    ("orientation", "qual:backpack_orientation")):
        arr = np.load(infer(paths, contact_pickle, vt, key, "180", out_dir))
        if arr.shape != (H_FULL,) or not np.isfinite(arr).all() or arr.max() != 1.0:
            raise AssertionError(f"{vt}: shape {arr.shape}, max {arr.max()}")
        log(f"inference {vt}: shape {arr.shape}, max {arr.max()}, mean {arr.mean():.4f}")
    ply = infer(paths, contact_pickle, "aggr-object-contact", "qual:backpack_object_contact",
                "180", out_dir)
    points, normals, colors = read_ply_pointcloud(ply)
    top = np.round(jet_rgb(np.float32([1.0])) * 255) / 255
    if points.shape != (180, 3) or not np.isfinite(colors).all() \
            or not np.isclose(colors, top).all(-1).any():
        raise AssertionError("aggr-object-contact: no point carries the colour of 1.0")
    log(f"inference aggr-object-contact: {len(points)} points, colour of 1.0 present")
    occ = np.load(infer(paths, occupancy_pickle, "occupancy", "qual:backpack_occupancy",
                        str(OCC_O), out_dir), allow_pickle=True).item()
    field = occ["prob_field"]
    if field.shape != (OCC_R,) * 3 or not np.isfinite(field).all() \
            or not np.isclose(field.max(), 0.7):
        raise AssertionError(f"occupancy: shape {field.shape}, max {field.max()}")
    log(f"inference occupancy: shape {field.shape}, max {field.max()}")


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

    from coma_tpu_torch.ops.attention import attention_reference, scaled_dot_attention

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
                max_abs_err=max_abs, atol_used=atol_used, atol=atol, rtol=rtol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


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
    rng = np.random.default_rng(SEED)
    k1 = []
    for shape in K1_SHAPES:
        r = check_k1(rng, *shape)
        k1.append(r)
        log(f"K1 {r['shape']}: max abs err {r['max_abs_err']:.3e}, max rel err "
            f"{r['max_rel_err']:.3e}; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}) [{label}]")
    k2 = check_k2(rng)
    log(f"K2 {k2['shape']}: {k2['differing_cells']} differing cells; kernel {k2['ms']:.3f} ms, "
        f"plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms ({k2['bound_by']}) "
        f"[{label}]")

    # phase 3: extraction through the CLI, with the launch counters from 0
    os.makedirs(SCRATCH, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tree_", dir=SCRATCH) as tmp:
        paths = write_tree(tmp, np.random.default_rng(SEED + 1))
        contact_kernel.launches = 0
        occupancy_kernel.launches = 0
        contact_pickle = extract(paths, "qual:backpack_human_contact", label)
        occupancy_pickle = extract(paths, "qual:backpack_occupancy", label)
        launches = {"contact_splat": contact_kernel.launches,
                    "occupancy_hits": occupancy_kernel.launches}
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        log(f"launches on the extraction path: {launches}")

        # phase 4: inference for all four products
        check_products(paths, contact_pickle, occupancy_pickle, f"{tmp}/output")

    # phase 5: K3 against its plain version
    k3 = []
    for shape in K3_SHAPES:
        r = check_k3(rng, *shape)
        k3.append(r)
        log(f"K3 {r['shape']}: max abs err {r['max_abs_err']:.3e}, least passing atol "
            f"{r['atol_used']:.3e} (limit {r['atol']:.0e} + {r['rtol']:.0e} |plain|); "
            f"kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{label}]")

    # phase 6: inpainting through the CLI, the K3 counter from 0; then the
    # tiny loop on the card against the CPU
    with tempfile.TemporaryDirectory(prefix="inpaint_", dir=SCRATCH) as tmp:
        write_inpaint_tree(tmp, np.random.default_rng(SEED + 2))
        attention.launches = 0
        inpaint(tmp, label)
        launches["flash_attention"] = attention.launches
    log(f"launches on the inpainting path: flash_attention {launches['flash_attention']}")
    if launches["flash_attention"] != K3_LAUNCHES_PER_BATCH:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times, "
                             f"expected {K3_LAUNCHES_PER_BATCH}")
    tiny_loop_against_cpu()

    k1_main = k1[0]
    kernels = [
        dict(name="contact_splat", route="cuda", source="coma_tpu_torch/csrc/contact_splat.cu",
             replaces="coma_tpu/ops/contact_kernel.py:405",
             launches=launches["contact_splat"],
             max_abs_err=max(r["max_abs_err"] for r in k1),
             max_rel_err=max(r["max_rel_err"] for r in k1),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=None, shape=k1_main["shape"]),
        dict(name="occupancy_hits", route="cuda", source="coma_tpu_torch/csrc/occupancy_hits.cu",
             replaces="coma_tpu/ops/occupancy_kernel.py:77",
             launches=launches["occupancy_hits"], max_abs_err=k2["max_abs_err"],
             differing_cells=k2["differing_cells"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             shape=k2["shape"]),
        dict(name="flash_attention", route="cuda",
             source="coma_tpu_torch/csrc/flash_attention.cu",
             replaces="coma_tpu/ops/attention.py:41",
             launches=launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k3),
             ms=k3[0]["ms"], plain_ms=k3[0]["plain_ms"], bound_ms=k3[0]["bound_ms"],
             bound_by=k3[0]["bound_by"], library_ms=k3[0]["library_ms"], shape=k3[0]["shape"],
             shapes=k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
