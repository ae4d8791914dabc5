"""CLI: ComA extraction (reference: ``src/coma/extract_coma.py``).

One process on one device, or with ``--multihost`` one process per rank:
launch with torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or set ``COMA_COORDINATOR`` (host:port),
``COMA_NUM_PROCESSES`` and ``COMA_PROCESS_ID`` in each process. Each rank
aggregates its shard of the samples, the accumulators are all-reduced over
``--dist_backend`` (``nccl``: one card per rank; ``gloo``: ranks may share a
card, or run on the CPU), and rank 0 writes the outputs. Each rank then
prints one JSON line, ``{"extract_rank": {...}}``: its rank, device, the
launches of each kernel so far in the process, its wait for the slowest
rank, the all-reduce's time and bytes, peak device memory and wall clock.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from coma_tpu_torch.cli._common import add_common_flags, lower_all, seed_everything
from coma_tpu_torch.config.hyperparams import (
    QUAL_AFFORDANCE_EXTRACTION_HYPERPARAMS_DICT,
    QUANT_AFFORDANCE_EXTRACTION_HYPERPARAMS_DICT,
    get_hyperparams,
)
from coma_tpu_torch.ops import attention, contact_kernel, occupancy_kernel
from coma_tpu_torch.parallel import distributed
from coma_tpu_torch.pipelines.extract import run_affordance_extraction


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--human_sample_dir", type=str, default="results/generation/human_sample")
    parser.add_argument("--constants_mesh_dir", type=str, default="./constants/mesh")
    parser.add_argument(
        "--hyperparams_key",
        choices=list(QUANT_AFFORDANCE_EXTRACTION_HYPERPARAMS_DICT.keys())
        + list(QUAL_AFFORDANCE_EXTRACTION_HYPERPARAMS_DICT.keys()),
        required=True,
    )
    parser.add_argument("--scale_tolerance", type=float, default=3.0)
    parser.add_argument("--multihost", action="store_true",
                        help="one process per rank: per-rank sample shards, all-reduce of "
                             "the accumulators, rank 0 writes (env: torchrun's RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, or "
                             "COMA_COORDINATOR, COMA_NUM_PROCESSES, COMA_PROCESS_ID)")
    parser.add_argument("--dist_backend", choices=distributed.BACKENDS, default="nccl",
                        help="with --multihost: nccl (one card per rank) or gloo")
    return parser


def rank_report(ctx: distributed.DistContext, seconds: float) -> dict:
    """What this rank did: its launches, all-reduces, peak memory, wall clock."""
    on_card = ctx.device.type == "cuda"
    return dict(
        rank=ctx.rank, world_size=ctx.world_size, backend=ctx.backend,
        device=str(ctx.device),
        device_name=torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
        launches={"contact_splat": contact_kernel.launches,
                  "occupancy_hits": occupancy_kernel.launches,
                  "flash_attention": attention.launches},
        wait_ms=ctx.wait_ms, allreduce_ms=ctx.allreduce_ms,
        allreduce_bytes=ctx.allreduce_bytes,
        peak_device_gb=torch.cuda.max_memory_allocated(ctx.device) / 1e9 if on_card else None,
        seconds=seconds,
    )


def main(argv=None, ctx: Optional[distributed.DistContext] = None) -> list:
    """Returns the product paths written (none on ranks other than 0). With
    ``--multihost`` the process group is ``ctx`` if given (its caller
    destroys it), else one made here and destroyed at the end."""
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    results_root = args.human_sample_dir.rsplit("/generation/human_sample", 1)[0]
    own = ctx is None and args.multihost
    if own:
        ctx = distributed.initialize(args.dist_backend, args.device)
    try:
        t0 = time.perf_counter()
        saved = run_affordance_extraction(
            hyperparams=get_hyperparams(args.hyperparams_key),
            hyperparams_key=args.hyperparams_key,
            supercategories=lower_all(args.supercategories),
            categories=lower_all(args.categories),
            prompts=lower_all(args.prompts),
            results_root=results_root,
            constants_mesh_dir=args.constants_mesh_dir,
            scale_tolerance=args.scale_tolerance,
            skip_done=args.skip_done,
            device=args.device,
            dist=ctx,
        )
        if ctx is not None:
            print(json.dumps({"extract_rank": rank_report(ctx, time.perf_counter() - t0)}),
                  flush=True)
    finally:
        if own:
            distributed.shutdown(ctx)
    return saved


if __name__ == "__main__":
    main()
