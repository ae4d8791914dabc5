"""CLI: post-filter 3D HOI samples (reference: ``src/coma/filter.py``).

Host only: reads the human-sample pickles' ``IoU``, ``interscetion_ratio``
[sic] and ``num_inliers`` and writes the JSON whitelists the extraction reads.
"""
from __future__ import annotations

import argparse

from coma_tpu_torch.cli._common import add_host_flags, lower_all, seed_everything
from coma_tpu_torch.pipelines.postfilter import run_post_filtering


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_host_flags(parser)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--human_sample_dir", type=str, default="results/generation/human_sample")
    parser.add_argument("--save_dir", type=str, default="results/coma/human_postfilterings")
    parser.add_argument("--IoU_threshold_min", type=float, default=0.7)
    parser.add_argument("--intersection_volume_ratio_threshold_max", type=float, default=0.05)
    parser.add_argument("--inlier_num_threshold_min", type=int, default=1)
    parser.add_argument("--enable_aggregate_total_prompts", action="store_true")
    return parser


def main(argv=None):
    """Returns the rejection statistics."""
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    # human_sample_dir is <root>/generation/human_sample in the schema
    results_root = args.human_sample_dir.rsplit("/generation/human_sample", 1)[0]
    return run_post_filtering(
        supercategories=lower_all(args.supercategories),
        categories=lower_all(args.categories),
        prompts=lower_all(args.prompts),
        results_root=results_root,
        save_dir=args.save_dir,
        IoU_threshold_min=args.IoU_threshold_min,
        intersection_volume_ratio_threshold_max=args.intersection_volume_ratio_threshold_max,
        inlier_num_threshold_min=args.inlier_num_threshold_min,
        enable_aggregate_total_prompts=args.enable_aggregate_total_prompts,
    )


if __name__ == "__main__":
    main()
