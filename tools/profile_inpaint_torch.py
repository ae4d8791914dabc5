#!/usr/bin/env python3
"""Where the time of one inpainting batch goes on the card (coma_tpu_torch).

    python3 tools/profile_inpaint_torch.py [--batch 4] [--steps 50]

Builds the full-width models of ``coma_tpu_torch.cli.inpaint`` (SD-1.x UNet
and VAE in bf16, CLIP ViT-L, the person segmenter; random weights from a
seed), runs one untraced batch to warm up, then one batch at 512² in mode
``p`` under ``torch.profiler``, and prints: the wall clock, the device's
busy and idle shares (kernel time summed over the window), the kernels
grouped by what runs them, and the top kernels by device time. Needs a
card; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (  # (label, substrings of the kernel name), first match wins
    ("K3 flash_attention", ("flash_attention_kernel",)),
    ("convolution", ("conv", "implicit_gemm", "xmma_fprop", "sm90_xmma", "cudnn")),
    ("matmul", ("gemm", "cutlass", "nvjet")),
    ("normalization", ("norm", "moments")),
    ("elementwise and copies", ("elementwise", "copy", "cat", "fill", "clamp")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--steps", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_inpaint_torch: needs a card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_label
    from coma_tpu_torch.cli import inpaint as cli
    from coma_tpu_torch.models.diffusion.pipeline import TorchNoise

    label = card_label()
    cli_args = cli.build_parser().parse_args(
        ["--random_weights", "--default_ddim_steps", str(args.steps)])
    device = torch.device("cuda")
    pipe, encode_prompts, res = cli.build_pipeline(cli_args, device)
    g = torch.Generator(device).manual_seed(0)
    B = args.batch
    image = torch.rand(B, 3, res, res, generator=g, device=device) * 2 - 1
    mask = torch.zeros(B, res, res, device=device)
    mask[:, res // 8: 7 * res // 8, res // 4: 3 * res // 4] = 1.0
    ctx = encode_prompts(["1 person wears the backpack"] * B)
    neg = encode_prompts([cli_args.negative_prompt] * B)

    def run():
        out = pipe.generate(image, mask, ctx, neg,
                            noise=TorchNoise(torch.Generator(device).manual_seed(1)))
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuDNN's algorithm search, the kernels' first launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3
    busy_ms = sum(dev_ms(e) for e in events)
    print(f"one batch of {B} at {res}², {args.steps} steps, mode p [{label}]: wall {wall_ms:.1f} ms "
          f"under the profiler, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    groups = {}
    for e in events:
        n, t = groups.get(group_of(e.key), (0, 0.0))
        groups[group_of(e.key)] = (n + e.count, t + dev_ms(e))
    for name, (n, t) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:24s} {t:10.1f} ms  {100 * t / busy_ms:5.1f}% of busy  {n} launches")
    print("top kernels by device time:")
    for e in sorted(events, key=lambda e: -dev_ms(e))[:12]:
        print(f"  {dev_ms(e):10.1f} ms  {e.count:6d}x  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
