"""CLI: train the person segmenter and emit a loadable checkpoint.

Counterpart of ``coma_tpu/cli/train_segmenter.py``. The reference depends on
an externally downloaded COCO PointRend checkpoint (``INSTALL.md:56-69``);
this trains the in-tree
:class:`~coma_tpu_torch.models.segmentation.PersonSegmenter` on the
procedural articulated-person generator
(:mod:`coma_tpu_torch.models.synthetic_person`) and writes ``coma_tpu``'s
``.npz`` params store (bf16 by default), which both packages load.

Host data generation runs in a producer thread; the step waits on the
queue only when the host falls behind, and synchronises once per step (the
loss is read). The weights start from the port's own seeded initialiser
(Flax's initialisers' distributions, not JAX's numbers). ``--out`` defaults
to ``output/person_segmenter.npz``, so the committed
``coma_tpu/data/person_segmenter.npz`` is never overwritten. A last line
``{"train_segmenter": {...}}`` reports the losses, the IoUs and the times.
"""
from __future__ import annotations

import argparse
import json
import queue
import threading
import time

from coma_tpu_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--out", type=str, default="output/person_segmenter.npz")
    parser.add_argument("--eval_batches", type=int, default=8)
    parser.add_argument("--eval_seed", type=int, default=10_000,
                        help="held-out stream seed (the quality gate uses the same)")
    parser.add_argument("--domains", type=str, default="procedural,rendered",
                        help="comma list of training background domains "
                             "(procedural | rendered); 'rendered' composites "
                             "the capsule humans into textured-rasterizer "
                             "scenes — the stage-1 background distribution")
    parser.add_argument("--corrupt", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="SD-style corruption (blur/noise/JPEG/jitter)")
    parser.add_argument("--bg_pool_size", type=int, default=48)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--bf16_store", action="store_true", default=True)
    add_device_flag(parser)
    return parser


def main(argv=None) -> dict:
    """Train, evaluate, write ``--out``; returns the summary it prints."""
    import numpy as np
    import torch

    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.models.flax_params import flax_tree
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.models.segmentation_train import SegTrainer
    from coma_tpu_torch.models.synthetic_person import (
        person_batch,
        person_batch_domain,
        rendered_background_pool,
    )
    from coma_tpu_torch.optim import warmup_cosine_decay_schedule
    from coma_tpu_torch.utils.checkpoint import save_params

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    domains = [d.strip() for d in args.domains.split(",") if d.strip()]
    known = {"procedural", "rendered"}
    if not domains or not set(domains) <= known:
        # a typo here would otherwise re-render a background pool every
        # batch or hang the producer on an empty list
        raise SystemExit(
            f"--domains must be a non-empty comma list from {sorted(known)}; "
            f"got {args.domains!r}"
        )

    model = init_flax_default_(PersonSegmenter(), torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(200, args.steps // 10),
        decay_steps=args.steps, end_value=args.lr * 0.02,
    )
    trainer = SegTrainer(model, sched, weight_decay=1e-4)

    bg_pool, pool_seconds = None, 0.0
    if "rendered" in domains:
        print("[train_segmenter] pre-rendering background pool "
              f"({args.bg_pool_size} scenes)...", flush=True)
        t = time.perf_counter()
        bg_pool = rendered_background_pool(args.seed, n=args.bg_pool_size, size=args.size,
                                           device=device)
        pool_seconds = time.perf_counter() - t

    q: "queue.Queue" = queue.Queue(maxsize=4)
    errors = []

    def producer():
        try:
            rng = np.random.default_rng(args.seed)
            for i in range(args.steps):
                dom = domains[i % len(domains)]
                q.put(person_batch_domain(
                    rng, args.batch, args.size, background=dom,
                    corrupt=args.corrupt, bg_pool=bg_pool, device=device,
                ))
        except BaseException as e:  # surfaced by the consumer
            errors.append(e)
            q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    def to_dev(a):
        return torch.from_numpy(a).to(device)

    def params_tree():
        tree = flax_tree(model)
        cast = ((lambda a: torch.from_numpy(a).to(torch.bfloat16)) if args.bf16_store
                else (lambda a: a))

        def walk(node):
            return {k: walk(v) if isinstance(v, dict) else cast(v) for k, v in node.items()}

        return walk(tree)

    on_card = device.type == "cuda"
    losses, step_ms, waits = [], [], []
    t0 = time.time()
    for i in range(args.steps):
        t = time.perf_counter()
        batch = q.get()
        waits.append(time.perf_counter() - t)
        if batch is None:
            raise RuntimeError("the data producer failed") from errors[0]
        imgs, masks = (to_dev(a) for a in batch)
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        loss = trainer.step(imgs, masks)
        if on_card:
            end.record()
        # one sync per step: otherwise the host runs arbitrarily far ahead
        # of the device and the queued transfers pile up
        losses.append(float(loss))
        if on_card:
            step_ms.append(start.elapsed_time(end))
        if (i + 1) % args.log_every == 0 or i == 0:
            print(
                f"[train_segmenter] step {i+1}/{args.steps} "
                f"loss {losses[-1]:.4f} ({time.time()-t0:.0f}s)",
                flush=True,
            )
        if (i + 1) % 1000 == 0:
            save_params(params_tree(), args.out)  # periodic checkpoint

    # held-out IoU on the eval streams (same seeds as the quality-gate test):
    # in-distribution (procedural) + CROSS-DOMAIN (holdout textures/shapes
    # the model never trained on, with corruption)
    eval_rng = np.random.default_rng(args.eval_seed)
    ious = []
    for _ in range(args.eval_batches):
        imgs, masks = person_batch(eval_rng, args.batch, args.size)
        ious.append(float(trainer.iou(to_dev(imgs), to_dev(masks))))
    miou = float(np.mean(ious))
    print(f"[train_segmenter] held-out IoU {miou:.4f} over {args.eval_batches} batches")

    holdout_pool = rendered_background_pool(
        args.eval_seed, n=16, size=args.size, holdout=True, device=device
    )
    cd_rng = np.random.default_rng(args.eval_seed + 1)
    cd_ious = []
    for _ in range(args.eval_batches):
        imgs, masks = person_batch_domain(
            cd_rng, args.batch, args.size, background="rendered_holdout",
            corrupt=True, bg_pool=holdout_pool, device=device,
        )
        cd_ious.append(float(trainer.iou(to_dev(imgs), to_dev(masks))))
    cd_miou = float(np.mean(cd_ious))
    print(f"[train_segmenter] CROSS-DOMAIN holdout IoU {cd_miou:.4f}")

    save_params(params_tree(), args.out)
    print(f"[train_segmenter] saved {args.out} (IoU {miou:.4f})")
    summary = dict(device=str(device), steps=args.steps, losses=losses,
                   step_ms=step_ms or None, queue_wait_s=waits, pool_seconds=pool_seconds,
                   iou=miou, cross_domain_iou=cd_miou, out=args.out)
    print(json.dumps({"train_segmenter": summary}))
    return summary


if __name__ == "__main__":
    main()
