"""Benchmark entry points: the measured runs of the system's main paths.

Counterpart of ``coma_tpu/benchkit.py``, with its function names (``_tpu``
dropped), its constants and the keys it emits. Each ``bench_*`` function
builds its inputs and models from seeds, runs on ``device`` (default
``"cuda"``; it raises without a card) and returns what ``coma_tpu``'s
returns. Times are host wall clocks around back-to-back launches, each
region ending in ``torch.cuda.synchronize()``. The two ``*_torch_cpu``
baselines run on the CPU by design. Where ``coma_tpu`` hard-codes a full
size, a size argument defaults to it, so that the tests can run the same
code tiny; the pipeline's sizes and model configs are the module's
constants and config functions.

Reference workload being measured: ``src/generation/inpaint.py:367,120,127``
(50 DDIM steps, 21 provoke rounds) + ``utils/adaptive_mask_inpainting.py:
732-1109`` (the adaptive-mask loop) and ``src/coma/extract_coma.py:383-426``
(ComA aggregation at the ``constants/coma/qual.py`` grid shapes).

- ComA: K1 (``bench_coma``, the contact splat) and K2 (``bench_occupancy``,
  the occupancy hits) on one state updated in place, at the rate of a chain
  of steps with the fixed cost differenced out.
- The flagship: the adaptive-mask inpainting of 16 images at 512², SD-1.x in
  bf16 from seeded weights, with the U-Net person segmenter or PointRend, in
  its variants (``bench_pipe_suite``), and the CFG UNet step with its share
  of the H100's bf16 peak (``bench_unet_step``). K3 runs every attention.
- ``bench_dp_scaling``: weak scaling of the tiny pipeline over ranks, one
  process each (``parallel/distributed.py``, ``parallel/flagship.py``).
- ``bench_extract_production``: the extraction of a fabricated results tree
  at the qual shape through ``run_affordance_extraction``, phase by phase.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from coma_tpu_torch.device import resolve_device

# ---------------------------------------------------------------- ComA

H, O, N = 10475, 180, 250
SIGMA, GRID_SIZE, THRES, EPS = 0.25, 0.07, 0.03, 1e-10
ITERS = 32
BASELINE_ITERS = 2
OCC_RES, OCC_SCALE_TOLERANCE = 30, 1.5   # constants/coma/qual.py's occupancy grid

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet); used only for the MFU figure
H100_BF16_PEAK = 989.4e12


def make_samples(b, h=H, o=O):
    rng = np.random.default_rng(0)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    return (
        (rng.normal(size=(b, h, 3)) * 0.3).astype(np.float32),
        unit(rng.normal(size=(b, h, 3))).astype(np.float32),
        (rng.normal(size=(b, o, 3)) * 0.3).astype(np.float32),
        unit(rng.normal(size=(b, o, 3))).astype(np.float32),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def coma_inputs(h, o, iters, device):
    """(state, (hv, hn, ov, on)): a zeroed (h, o, N) ComA state and ``iters``
    seeded i.i.d. samples, on ``device``."""
    from coma_tpu_torch.affordance.state import init_coma_state

    samples = tuple(torch.from_numpy(a).to(device) for a in make_samples(iters, h, o))
    state = init_coma_state(h, o, N, GRID_SIZE, THRES, SIGMA, eps=EPS, device=device)
    return state, samples


def bench_coma(h=H, o=O, iters=ITERS, device="cuda"):
    """(samples/s, {"w1_s", "w2_s"}) of K1 at (h, o, N), ``iters`` samples a step."""
    from coma_tpu_torch.ops.contact_kernel import fused_contact_update_batch

    device = resolve_device(device)
    state, samples = coma_inputs(h, o, iters, device)
    return _sustained_rate(fused_contact_update_batch, state, samples, iters, device)


def _sustained_rate(step_fn, state, step_args, iters, device):
    """(rate, raw chain times) with the fixed cost differenced out.

    Production (extract_coma) runs many batch steps back to back and
    synchronises once, so the rate is the sustained time per step: a chain
    of 1 step and a chain of 2, each ending in one synchronisation (best of
    2 after a warm-up), differenced; that removes the launch and sync
    overhead. Each step updates the one ``state`` in place, so the chains
    hold one state; the rate does not depend on what it has accumulated. The
    raw chain wall clocks ride along so a reader can check the subtraction."""
    def chain(k):
        def run():
            for _ in range(k):
                step_fn(state, *step_args)
            _sync(device)

        run()  # warm-up: the kernel's build and load, the plan
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best

    w1 = chain(1)
    w2 = chain(2)
    rate = iters / max(w2 - w1, 1e-9)
    return rate, {"w1_s": round(w1, 4), "w2_s": round(w2, 4)}


def occupancy_inputs(h, o, iters, device):
    """(state, (hv, ov)): a zeroed (h, 30³) occupancy state and ``iters``
    seeded i.i.d. samples, on ``device``."""
    from coma_tpu_torch.affordance.state import init_occupancy_state

    state = init_occupancy_state(h, o, spatial_res=OCC_RES,
                                 scale_tolerance=OCC_SCALE_TOLERANCE, device=device)
    rng = np.random.default_rng(0)
    hv = torch.from_numpy(np.float32(rng.normal(size=(iters, h, 3)) * 0.3)).to(device)
    ov = torch.from_numpy(np.float32(rng.normal(size=(iters, o, 3)) * 0.3)).to(device)
    return state, (hv, ov)


def bench_occupancy(h=H, o=O, iters=ITERS, device="cuda"):
    """Occupancy-voxel aggregation (K2) at reference scale (H=10475, 30³ grid,
    ``constants/coma/qual.py`` occupancy config)."""
    from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch

    device = resolve_device(device)
    state, samples = occupancy_inputs(h, o, iters, device)
    return _sustained_rate(fused_occupancy_update_batch, state, samples, iters, device)


def bench_coma_torch_cpu(h=H, o=O) -> float:
    """Reference-style torch update on host CPU (the measurable baseline)."""
    grid_np = _fibonacci(N)
    grid = torch.tensor(grid_np, dtype=torch.float32)
    p = torch.tensor([0.0, 0.0, 1.0])
    ph = torch.zeros(h, o, N)
    po = torch.zeros(h, o, N)
    nom = torch.zeros(h, o)
    sig = torch.zeros(h, o)

    def canon(a, b):
        c = b @ p
        w = torch.cross(b, p.expand_as(b), dim=-1)
        a_dot_w = a @ w.T
        out = (
            a_dot_w[:, :, None] * w[None] / (1.0 + c)[None, :, None]
            + c[None, :, None] * a[:, None, :]
            + (a @ b.T)[:, :, None] * p[None, None, :]
            - (a @ p)[:, None, None] * b[None, :, :]
        )
        return out / out.norm(dim=-1, keepdim=True)

    def splat(d):
        cos = torch.einsum("hok,nk->hon", d, grid).clamp(-1 + EPS, 1 - EPS)
        return torch.exp(-torch.arccos(cos) ** 2 / SIGMA**2)

    hv, hn, ov, on = (torch.tensor(x) for x in make_samples(BASELINE_ITERS, h, o))
    hn = torch.where(hn[..., 2:3] < -0.99, -hn, hn)
    on = torch.where(on[..., 2:3] < -0.99, -on, on)

    t0 = time.perf_counter()
    for i in range(BASELINE_ITERS):
        d = (hv[i][:, None, :] - ov[i][None, :, :]).square().sum(-1).sqrt()
        sig += (d < THRES).float()
        nom += torch.exp(-d / GRID_SIZE)
        ph += splat(canon(hn[i], on[i]))
        po += splat(canon(on[i], hn[i]).permute(1, 0, 2))
    dt = time.perf_counter() - t0
    return BASELINE_ITERS / dt


def _fibonacci(n):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1
    ).astype(np.float32)


# ----------------------------------------------------- flagship: 2D HOI

RES, LAT, BATCH, STEPS = 512, 64, 16, 50
# a typical person-extent default mask (~200 px tall -> latent bucket 40):
# rows, then columns, of its box at RES
CROP_BOX = (156, 356, 132, 316)


def unet_config():
    from coma_tpu_torch.models.diffusion.unet import UNetConfig

    return UNetConfig(dtype=torch.bfloat16)


def vae_config():
    from coma_tpu_torch.models.diffusion.vae import VAEConfig

    return VAEConfig(dtype=torch.bfloat16)


def pointrend_config():
    """The in-loop detector at the pipeline's native 512 px scale."""
    from coma_tpu_torch.models.pointrend import PointRendConfig

    return PointRendConfig(test_size=512, pre_nms_topk=256, post_nms_topk=128,
                           box_candidates=64, max_detections=8)


def _build_pipeline(provoke_decode_factor: int = 1, segmenter: str = "unet",
                    pointrend_fast: bool = False, provoke_crop_latent: int = 0,
                    shared: dict = None, device="cuda"):
    """Build one flagship pipeline variant on ``device``; returns
    (pipeline, unet_fn, UNet config).

    ``shared`` (optional dict) caches the models ACROSS variants within one
    process: every variant uses the identical SD UNet/VAE and both PointRend
    variants the identical PointRend (throughput is weight-independent).
    Weights are seeded: the SD trio and the U-Net segmenter from one
    generator on ``device`` seeded 0, PointRend from a CPU generator seeded
    2."""
    from coma_tpu_torch.models.diffusion.pipeline import (
        AdaptiveMaskConfig,
        AdaptiveMaskInpaintPipeline,
    )
    from coma_tpu_torch.models.diffusion.unet import UNet2DCondition
    from coma_tpu_torch.models.diffusion.vae import Decoder, Encoder
    from coma_tpu_torch.models.layers import init_flax_default_

    device = resolve_device(device)
    shared = {} if shared is None else shared
    ucfg, vcfg = unet_config(), vae_config()
    g = torch.Generator(device).manual_seed(0)
    if "sd" not in shared:
        shared["sd"] = tuple(init_flax_default_(m, g).eval() for m in (
            UNet2DCondition(ucfg, device=device), Encoder(vcfg, device=device),
            Decoder(vcfg, device=device)))
    unet, enc, dec = shared["sd"]

    if segmenter == "pointrend":
        # the reference's in-loop segmenter family (PointRendPredictor,
        # adaptive_mask_inpainting.py:1182-1243)
        from coma_tpu_torch.models.pointrend import PointRendModel, make_pointrend_segment_fn

        if "pointrend" not in shared:
            shared["pointrend"] = init_flax_default_(
                PointRendModel(pointrend_config()), torch.Generator().manual_seed(2)
            ).to(device).eval()
        person_fn = make_pointrend_segment_fn(
            shared["pointrend"],
            compute_dtype=torch.bfloat16 if pointrend_fast else None,
            paste_stride=4 if pointrend_fast else 1,
        )
    else:
        from coma_tpu_torch.models.segmentation import PersonSegmenter, probs_to_mask

        if "segmenter" not in shared:
            shared["segmenter"] = init_flax_default_(PersonSegmenter(device=device), g).eval()
        seg = shared["segmenter"]
        person_fn = lambda imgs: probs_to_mask(seg(imgs))

    unet_fn = lambda lat, t, ctx: unet(lat.to(ucfg.dtype), t, ctx.to(ucfg.dtype)).float()
    pipe = AdaptiveMaskInpaintPipeline(
        unet_fn=unet_fn,
        vae_encode_fn=lambda img: enc(img.to(vcfg.dtype)).float(),
        vae_decode_fn=lambda lat: dec(lat.to(vcfg.dtype)).float(),
        segment_fn=person_fn,
        config=AdaptiveMaskConfig(
            num_inference_steps=STEPS,
            provoke_decode_factor=provoke_decode_factor,
            provoke_crop_latent=provoke_crop_latent,
        ),
    )
    return pipe, unet_fn, ucfg


@torch.no_grad()
def _warm(pipe, img, ctx) -> None:
    """One forward of each model at every shape ``generate`` gives it: the
    CFG UNet, the VAE encoder and decoder at the full frame, and the provoke
    round's decode, encode and segmenter at its own shape (eager PyTorch has
    no trace to warm; this loads the kernels and grows the allocator)."""
    cfg = pipe.config
    B, _, R, _ = img.shape
    s = cfg.vae_scale
    lat = R // s
    pipe.unet_fn(torch.zeros(2 * B, 9, lat, lat, device=img.device),
                 torch.full((2 * B,), 500.0, device=img.device), ctx)
    pipe.vae_encode_fn(img)
    pipe.vae_decode_fn(torch.zeros(B, 4, lat, lat, device=img.device))
    c, f = int(cfg.provoke_crop_latent), max(1, int(cfg.provoke_decode_factor))
    if 0 < c < lat:
        pipe.vae_decode_fn(torch.zeros(B, 4, c, c, device=img.device))
        pipe.vae_encode_fn(torch.zeros(B, 3, c * s, c * s, device=img.device))
        pipe.segment_fn(torch.zeros(B, 3, c * s, c * s, device=img.device))
    elif f > 1:
        pipe.vae_decode_fn(torch.zeros(B, 4, lat // f, lat // f, device=img.device))
        pipe.segment_fn(torch.zeros(B, 3, R // f, R // f, device=img.device))
    else:
        pipe.segment_fn(img)


def _pipeline_rate(mask_box: int = 0, iters: int = 2, device="cuda", **kw) -> float:
    """images/sec of one full-size pipeline variant on ``device``: ``iters``
    timed batches of BATCH images after a warm-up of one forward of each
    model at its shapes. The build, the warm-up, each batch's seconds and the
    peak device memory go to stderr."""
    from coma_tpu_torch.models.diffusion.pipeline import TorchNoise

    device = resolve_device(device)
    t_start = time.perf_counter()
    pipe, _, ucfg = _build_pipeline(device=device, **kw)
    _sync(device)
    print(f"[pipeline_rate] build_s={time.perf_counter() - t_start:.1f}",
          file=sys.stderr, flush=True)
    img = torch.zeros(BATCH, 3, RES, RES, device=device)
    mask = torch.ones(BATCH, RES, RES, device=device)
    if mask_box:
        # a realistic person-extent default mask (crop mode anchors its
        # decode window on the mask bbox; throughput of the OTHER modes
        # is mask-content-independent, so rates stay comparable); at 512²
        # the columns are shifted left by 24 and 40 pixels
        lo, hi = (RES - mask_box) // 2, (RES + mask_box) // 2
        mask.zero_()
        mask[:, lo:hi, lo - RES * 3 // 64:hi - RES * 5 // 64] = 1.0
    emb = torch.zeros(BATCH, 77, ucfg.cross_attention_dim, device=device)
    neg = torch.zeros_like(emb)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_built = time.perf_counter()
    _warm(pipe, img, torch.cat([neg, emb]))
    _sync(device)
    print(f"[pipeline_rate] warm-up: one forward of each model at its shapes, "
          f"{time.perf_counter() - t_built:.1f} s", file=sys.stderr, flush=True)
    batch_s = []
    t0 = time.perf_counter()
    for i in range(iters):
        t_batch = time.perf_counter()
        gen = torch.Generator(device).manual_seed(2 + i)
        pipe.generate(img, mask, emb, neg, noise=TorchNoise(gen))
        _sync(device)
        batch_s.append(time.perf_counter() - t_batch)
    rate = BATCH * iters / (time.perf_counter() - t0)
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB"
            if device.type == "cuda" else "")
    print(f"[pipeline_rate] timed batches {[round(s, 3) for s in batch_s]} s{peak}",
          file=sys.stderr, flush=True)
    return rate


def unet_flops(cfg, batch: int, lat: int, ctx_len: int = 77) -> int:
    """FLOPs of one UNet forward at (batch, in_channels, lat, lat), counted by
    ``FlopCounterMode`` on the ``meta`` device (no data, no launch): the
    attention runs its plain version there, whose two products the counter
    sees (4·B·H·Lq·Lk·D); the kernel K3, a ``ctypes`` call, it could not."""
    from torch.utils.flop_counter import FlopCounterMode

    from coma_tpu_torch.models.diffusion.unet import UNet2DCondition

    meta = torch.device("meta")
    model = UNet2DCondition(cfg, device=meta)
    args = (torch.zeros(batch, cfg.in_channels, lat, lat, device=meta),
            torch.zeros(batch, device=meta),
            torch.zeros(batch, ctx_len, cfg.cross_attention_dim, device=meta))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*args)
    return int(counter.get_total_flops())


def bench_unet_step(shared: dict = None, device="cuda"):
    """Isolated CFG UNet step (batch 2*BATCH: uncond+cond) + measured MFU:
    (step seconds, FLOPs / step time / H100_BF16_PEAK)."""
    device = resolve_device(device)
    _, unet_fn, ucfg = _build_pipeline(shared=shared, device=device)
    lat_in = torch.zeros(2 * BATCH, 9, LAT, LAT, device=device)
    t_in = torch.full((2 * BATCH,), 500.0, device=device)
    ctx = torch.zeros(2 * BATCH, 77, ucfg.cross_attention_dim, device=device)
    flops = unet_flops(ucfg, 2 * BATCH, LAT)
    analytic = 677e9 * 2 * 2 * BATCH   # coma_tpu's fallback: SD-1.x ≈ 677 GMACs per 512² image
    print(f"[unet_step] FLOPs {flops} (FlopCounterMode on meta), coma_tpu's fallback "
          f"677e9*2*2*B {analytic:.6g}: ratio {flops / analytic:.4f}", file=sys.stderr, flush=True)
    n = 10
    with torch.no_grad():
        unet_fn(lat_in, t_in, ctx)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            unet_fn(lat_in, t_in, ctx)
        _sync(device)
    step_s = (time.perf_counter() - t0) / n
    mfu = flops / step_s / H100_BF16_PEAK
    return step_s, mfu


def bench_pipe_suite(emit, device="cuda") -> None:
    """Every flagship pipeline variant + the isolated UNet step, ONE process,
    headline first. ``emit(dict)`` runs after EVERY sub-measurement. The SD
    models are built once (``_build_pipeline(shared=...)``)."""
    device = resolve_device(device)
    shared: dict = {}

    def one(key, iters=1, **kw):
        # headline gets 2 timed batches; the others 1
        t0 = time.perf_counter()
        rate = _pipeline_rate(shared=shared, iters=iters, device=device, **kw)
        emit({key: round(rate, 4)})
        print(f"[suite] {key}={rate:.4f} ({time.perf_counter() - t0:.1f}s)",
              file=sys.stderr, flush=True)

    one("hoi_2d_images_per_sec", provoke_decode_factor=1, iters=2)

    t0 = time.perf_counter()
    step_s, mfu = bench_unet_step(shared=shared, device=device)
    emit({"unet_cfg_step_ms": round(step_s * 1e3, 2),
          "unet_step_mfu": round(mfu, 4)})
    print(f"[suite] unet_step ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr, flush=True)

    one("hoi_2d_images_per_sec_pointrend_loop", segmenter="pointrend")
    one("hoi_2d_images_per_sec_pointrend_loop_fast",
        segmenter="pointrend", pointrend_fast=True)
    one("hoi_2d_images_per_sec_fast_mode", provoke_decode_factor=2)

    from coma_tpu_torch.models.diffusion.pipeline import choose_crop_latent

    # crop mode: bucket chosen exactly as the CLI does, from a typical
    # person-extent mask
    top, bottom, left, right = CROP_BOX
    box = np.zeros((1, RES, RES), np.float32)
    box[:, top:bottom, left:right] = 1.0
    bucket = int(choose_crop_latent(box))
    t0 = time.perf_counter()
    rate = _pipeline_rate(mask_box=200, provoke_crop_latent=bucket,
                          shared=shared, iters=1, device=device)
    emit({"hoi_2d_images_per_sec_crop_mode": round(rate, 4),
          "crop_mode_latent_bucket": bucket})
    print(f"[suite] crop={rate:.4f} ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr, flush=True)


@torch.no_grad()
def _init_normal_(module, generator: torch.Generator):
    """Dense and Conv kernels normal with std 1/√fan-in, biases 0, norm scales
    1: ``init_flax_default_``'s scales without its truncation, whose inverse
    error function takes about a minute for the UNet's 860 M parameters on a
    host CPU (the timing does not depend on the weights)."""
    from coma_tpu_torch.models.layers import Conv, Dense, GroupNorm, LayerNorm

    for sub in module.modules():
        if isinstance(sub, (Dense, Conv)):
            sub.weight.normal_(0.0, sub.weight[0].numel() ** -0.5, generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (GroupNorm, LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module


def bench_inpaint_torch_cpu(lat: int = LAT) -> float:
    """Baseline images/sec for the dominant per-image work on torch CPU:
    50 CFG UNet steps + 21 provoke-round VAE decodes, with the port's own
    full-width SD-inpaint UNet and VAE decoder in float32 (seeded weights).
    Segmentation/re-encode excluded — favors the baseline. Measured from one
    step of each (they are step-homogeneous)."""
    from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
    from coma_tpu_torch.models.diffusion.vae import Decoder, VAEConfig

    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ucfg = UNetConfig()
        unet = _init_normal_(UNet2DCondition(ucfg, device="cpu"), g).eval()
        lat_in = torch.zeros(2, 9, lat, lat)
        t = torch.full((2,), 500.0)
        ctx = torch.zeros(2, 77, ucfg.cross_attention_dim)
        unet(lat_in, t, ctx)  # warmup
        t0 = time.perf_counter()
        unet(lat_in, t, ctx)
        unet_s = time.perf_counter() - t0
        del unet

        dec = _init_normal_(Decoder(VAEConfig(), device="cpu"), g).eval()
        z = torch.zeros(1, 4, lat, lat)
        dec(z)
        t0 = time.perf_counter()
        dec(z)
        dec_s = time.perf_counter() - t0
    per_image = STEPS * unet_s + 21 * dec_s
    return 1.0 / per_image


# ----------------------------------------------------- dp scaling over ranks

DP_RES, DP_PER_RANK = 64, 2
RANK_TIMEOUT_S = 600
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_pipeline(device):
    """The tiny pipeline (64², tiny UNet and VAE, seed 0 on the CPU, a
    brightness threshold for the segmenter)."""
    from coma_tpu_torch.models.diffusion.pipeline import (
        AdaptiveMaskConfig,
        AdaptiveMaskInpaintPipeline,
    )
    from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, tiny_unet_config
    from coma_tpu_torch.models.diffusion.vae import Decoder, Encoder, tiny_vae_config
    from coma_tpu_torch.models.layers import init_flax_default_

    g = torch.Generator().manual_seed(0)
    cfg = tiny_unet_config()
    unet, enc, dec = (init_flax_default_(m, g).to(device).eval() for m in (
        UNet2DCondition(cfg), Encoder(tiny_vae_config()), Decoder(tiny_vae_config())))
    pipe = AdaptiveMaskInpaintPipeline(
        unet_fn=unet, vae_encode_fn=enc, vae_decode_fn=dec,
        segment_fn=lambda images: (images.mean(1) > 0.6).float(),
        config=AdaptiveMaskConfig(num_inference_steps=STEPS),
    )
    return pipe, cfg


def _dp_rank(backend: str, device: str) -> int:
    """One rank of ``bench_dp_scaling`` (launched with ``COMA_*``): one
    forward of each model at its shapes, then this rank's batch of the
    weak-scaled work timed between two barriers; prints one
    ``{"dp_rank": ...}`` line with the K3 launches of the timed run."""
    from coma_tpu_torch.models.diffusion.pipeline import TorchNoise
    from coma_tpu_torch.ops import attention
    from coma_tpu_torch.parallel import distributed
    from coma_tpu_torch.parallel.flagship import rank_batches

    ctx = distributed.initialize(backend, device)
    try:
        dev = ctx.device
        pipe, cfg = _tiny_pipeline(dev)
        B, R = DP_PER_RANK * ctx.world_size, DP_RES
        img = torch.zeros(B, 3, R, R, device=dev)
        mask = torch.zeros(B, R, R, device=dev)
        mask[:, 8:40, 8:40] = 1.0
        emb = torch.zeros(B, 7, cfg.cross_attention_dim, device=dev)

        mine = rank_batches(B, DP_PER_RANK, ctx.rank, ctx.world_size)
        _warm(pipe, img[:DP_PER_RANK], torch.cat([emb[:DP_PER_RANK]] * 2))
        _sync(dev)
        distributed.barrier(ctx)
        attention.launches = 0
        t0 = time.perf_counter()
        for i in mine:
            sl = slice(i, i + DP_PER_RANK)
            gen = torch.Generator(dev).manual_seed(0)
            pipe.generate(img[sl], mask[sl], emb[sl], emb[sl] * 0, noise=TorchNoise(gen))
        _sync(dev)
        distributed.barrier(ctx)
        step_s = time.perf_counter() - t0
        print(json.dumps({"dp_rank": dict(rank=ctx.rank, step_s=step_s, device=str(dev),
                                          launches=attention.launches)}), flush=True)
    finally:
        distributed.shutdown(ctx)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_dp_ranks(n: int, backend: str, device: torch.device) -> list:
    """``n`` rank processes of :func:`_dp_rank`; returns their reports in
    rank order. Every process is stopped before this returns."""
    port = _free_port()
    code = ("import sys; from coma_tpu_torch import benchkit; "
            "sys.exit(benchkit._dp_rank(sys.argv[1], sys.argv[2]))")
    procs = []
    for rank in range(n):
        env = dict(os.environ, COMA_COORDINATOR=f"localhost:{port}",
                   COMA_NUM_PROCESSES=str(n), COMA_PROCESS_ID=str(rank),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, backend, device.type], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"bench_dp_scaling: {n} ranks failed:\n"
                           + "\n".join(o[-3000:] for o in outs))
    reports = [json.loads(line)["dp_rank"] for out in outs for line in out.splitlines()
               if line.startswith('{"dp_rank"')]
    if len(reports) != n:
        raise RuntimeError(f"bench_dp_scaling: {len(reports)} reports from {n} ranks")
    return sorted(reports, key=lambda r: r["rank"])


def bench_dp_scaling(ranks=(1, 2, 4), device="cuda") -> dict:
    """Weak scaling of the FULL adaptive-mask loop at tiny shapes, 2 images
    per rank, over 1, 2 and 4 ranks: one process per rank, each generating
    its whole batch (``parallel/flagship.py:rank_batches``). Ranks take a card
    each under NCCL where there are enough cards, else share card 0 under
    gloo; on the CPU, gloo. A point's ``step_s`` is rank 0's time between two
    barriers (the slowest rank's)."""
    device = resolve_device(device)
    curve = {}
    for n in ranks:
        nccl = device.type == "cuda" and torch.cuda.device_count() >= n
        backend = "nccl" if nccl else "gloo"
        reports = _spawn_dp_ranks(n, backend, device)
        B = DP_PER_RANK * n
        dt = reports[0]["step_s"]
        curve[str(n)] = {"batch": B, "step_s": round(dt, 3),
                         "imgs_per_sec": round(B / dt, 2), "backend": backend,
                         "device": [r["device"] for r in reports],
                         "launches": [r["launches"] for r in reports]}
    return {"flagship_dp_scaling": curve}


# ------------------------------------------- production extract_coma path

class _PhaseTimings(dict):
    """timings dict whose writes invoke a callback — lets the bench emit the
    aggregation rate the moment it is measured, before the state export
    runs, so an orchestrator kill mid-export still captures the compute
    metric."""

    def __init__(self, on_set=None):
        super().__init__()
        self._on_set = on_set

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if self._on_set is not None:
            self._on_set(key, value)


def bench_extract_production(num_samples: int = 64, workdir: str = None,
                             h: int = H, o: int = O, n: int = N,
                             emit=None, device="cuda"):
    """Measured samples/s of the PRODUCTION extraction path: fabricate a
    reference-schema results tree with full-scale meshes (human = 10475
    verts, the SMPL-X count; object = 180 points, the qual human-contact
    shape), then time ``run_affordance_extraction`` on ``device`` end to end
    — pickle loads, host prep (normals, index-downsample), the prefetching
    loader, the aggregation (K1 on the card), state export, and the product
    save all included. (Ref: ``src/coma/extract_coma.py:383-426``.)

    The returned rate covers the COMPUTE path (load + prep + aggregation +
    product); the state export (the (H, O, N) grids to the host and their
    pickle) is timed separately in the breakdown (``export_s``), and
    ``samples_per_sec_incl_export`` is the all-in number.

    ``h``/``o``/``n`` exist so tests can drive the identical path at tiny
    shapes; the bench runs the reference qual defaults.

    Returns (samples_per_sec, breakdown_dict)."""
    from coma_tpu_torch.cli import downsample_objects as cli_downsample_objects
    from coma_tpu_torch.geometry.mesh import save_obj
    from coma_tpu_torch.pipelines.downsample import (
        downsample_human_template,
        save_human_downsample,
    )
    from coma_tpu_torch.pipelines.extract import run_affordance_extraction

    device = resolve_device(device)
    sc, cat, asset = "BEHAVE", "backpack", "bench_asset"
    d = workdir or tempfile.mkdtemp(prefix="coma_extract_bench_")
    made_tmp = workdir is None
    root = os.path.join(d, "results")
    constants = os.path.join(d, "constants", "mesh")
    os.makedirs(constants, exist_ok=True)

    # human template: UV sphere sliced to exactly h verts (h=10475 = the
    # SMPL-X vertex count at the default)
    n_lat = max(4, int(math.ceil(math.sqrt(h))) + 1)
    n_lon = max(4, int(math.ceil(h / n_lat)))
    hv, hf = _uv_sphere(n_lat, n_lon)
    hv = hv[:h]
    hf = hf[(hf < h).all(axis=1)]
    meta = downsample_human_template(hv, hf, num_points=h)
    save_human_downsample(meta, h, constants)

    # object asset + downsample pickle at o points
    rng = np.random.default_rng(0)
    obj_lat = max(4, int(math.ceil(math.sqrt(o))) + 1)
    ov, of = _uv_sphere(obj_lat, max(4, int(math.ceil(o / obj_lat)) + 1))
    obj_dir = os.path.join(d, "asset_src")
    os.makedirs(obj_dir, exist_ok=True)
    obj_pth = os.path.join(obj_dir, f"{asset}.obj")
    save_obj(obj_pth, ov, of)
    cli_downsample_objects.main([
        "--obj_pth", obj_pth,
        "--supercategory", sc, "--category", cat, "--asset_id", asset,
        "--number_of_points", str(o),
        "--save_dir", os.path.join(root, "coma", "asset_downsample"),
    ])

    # fabricated human samples at full scale (random plausible humans)
    prompt = "a person carrying a backpack"
    base = os.path.join(root, "generation", "human_sample", sc, cat, asset)
    cam_dir = os.path.join(root, "generation", "cameras", sc, cat, asset)
    os.makedirs(cam_dir, exist_ok=True)
    view = "000"
    with open(os.path.join(cam_dir, f"{view}.pickle"), "wb") as fh:
        pickle.dump({"scale": 256.0}, fh)
    sample_dir = os.path.join(base, view, "0", prompt)
    os.makedirs(sample_dir, exist_ok=True)
    t_write0 = time.perf_counter()
    for i in range(num_samples):
        verts = hv * 0.9 + rng.normal(scale=0.02, size=hv.shape) + [0.3, 0.0, 0.2]
        payload = {
            "verts": verts.astype(np.float32), "faces": hf,
            "IoU": 0.9, "interscetion_ratio": 0.01, "num_inliers": 5,
        }
        with open(os.path.join(sample_dir, f"{i:05d}.pickle"), "wb") as fh:
            pickle.dump(payload, fh)
    fabricate_s = time.perf_counter() - t_write0

    hyper = dict(
        human_res="FULL", human_use_downsample_pcd_raw=False,
        object_res=str(o), object_use_downsample_pcd_raw=True,
        principle_vec=[0, 0, 1], sub_principle_vec=[0, 1, 0],
        rel_dist_method="dist", spatial_grid_size=GRID_SIZE,
        spatial_grid_thres=0.5, normal_gaussian_sigma=SIGMA,
        normal_res=n, spatial_res=0, eps=EPS,
        significant_contact_ratio=0.1, enable_postfilter=False,
        standardize_human_scale=False, scaler_range=(0.75, 1.25),
        visualize_type="aggr-human-contact", vis_example_num=0,
        quant_mode=False, quant_keys=[],
    )
    cwd = os.getcwd()
    os.chdir(d)

    # free the fabricate/downsample phase's leftovers before the timed region
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def on_phase(key, value):
        if emit is not None and key == "aggregate_s":
            emit({"extract_coma_aggregate_s": round(value, 2),
                  "extract_coma_aggregate_samples_per_sec": round(
                      num_samples / max(value, 1e-9), 3)})

    phases: dict = _PhaseTimings(on_phase)
    try:
        t0 = time.perf_counter()
        saved = run_affordance_extraction(
            hyper, "qual:bench",
            supercategories=[sc.lower()], categories=[cat.lower()],
            results_root=root, constants_mesh_dir=constants, verbose=False,
            device=device, timings=phases,
        )
        total_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        if made_tmp:
            shutil.rmtree(d, ignore_errors=True)
    export_s = phases.get("export_s", 0.0)
    compute_s = max(total_s - export_s, 1e-9)
    rate = num_samples / compute_s
    return rate, {"num_samples": num_samples, "total_s": round(total_s, 2),
                  "compute_s": round(compute_s, 2),
                  "aggregate_s": round(phases.get("aggregate_s", 0.0), 2),
                  "export_s": round(export_s, 2),
                  "product_s": round(phases.get("product_s", 0.0), 2),
                  "samples_per_sec_incl_export": round(num_samples / total_s, 3),
                  "fabricate_s": round(fabricate_s, 2),
                  "products_saved": len(saved)}


def _uv_sphere(n_lat, n_lon):
    verts = []
    for i in range(n_lat):
        th = math.pi * (i + 0.5) / n_lat
        for j in range(n_lon):
            ph = 2 * math.pi * j / n_lon
            verts.append([math.sin(th) * math.cos(ph),
                          math.sin(th) * math.sin(ph), math.cos(th)])
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            faces.append([a, b, b + n_lon])
            faces.append([a, b + n_lon, a + n_lon])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)
