"""CLI: per-asset object downsampling (reference: ``src/coma/downsample_objects.py``).

Host only (poisson-disk sampling in numpy and the native library). Assets
come from ``--dataset_type`` (the six dataset layouts of
``downsample_objects.py:93-130``) or from one ``--obj_pth``.
"""
from __future__ import annotations

import argparse
import os

from coma_tpu_torch import native
from coma_tpu_torch.cli._common import add_host_flags, lower_all, seed_everything
from coma_tpu_torch.config.assets import (
    CATEGORY2ASSET,
    DATASET_PTHS,
    DATASET_TYPE2CATEGORIES,
    resolve_asset_obj_path,
)
from coma_tpu_torch.core.paths import flatten
from coma_tpu_torch.pipelines.downsample import downsample_object, save_object_downsample


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_host_flags(parser)
    parser.add_argument("--save_dir", type=str, default="results/coma/asset_downsample")
    parser.add_argument("--simplify_method", choices=["poisson_disk", "uniform"], default="poisson_disk")
    parser.add_argument("--dataset_type", type=str, choices=list(DATASET_PTHS.keys()))
    parser.add_argument("--disable_lowres_switch_for_behave", action="store_true")
    parser.add_argument("--number_of_points", type=int, required=True)
    parser.add_argument("--obj_pth", type=str, help="direct path to a single .obj (bypasses dataset resolution)")
    parser.add_argument("--supercategory", type=str, help="with --obj_pth")
    parser.add_argument("--category", type=str, help="with --obj_pth")
    parser.add_argument("--asset_id", type=str, help="with --obj_pth")
    return parser


def main(argv=None) -> list:
    """Returns the pickles written."""
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)

    jobs = []
    if args.obj_pth:
        jobs.append((args.supercategory, args.category, args.asset_id, args.obj_pth))
    elif args.dataset_type:
        scs = DATASET_TYPE2CATEGORIES[args.dataset_type]
        supercategories = lower_all(args.supercategories)
        categories = lower_all(args.categories)
        if supercategories:
            scs = [sc for sc in scs if sc[0].lower() in supercategories]
        if categories:
            scs = [sc for sc in scs if sc[1].lower() in categories]
        for supercategory, category in scs:
            for asset_id in CATEGORY2ASSET[supercategory][category]:
                obj_pth = resolve_asset_obj_path(
                    args.dataset_type, supercategory, category, asset_id,
                    disable_lowres_switch_for_behave=args.disable_lowres_switch_for_behave,
                )
                jobs.append((supercategory, category, asset_id, obj_pth))
    else:
        raise SystemExit("pass --obj_pth or --dataset_type")

    print(f"[downsample] poisson-disk elimination: {native.path_name()}")
    written = []
    for supercategory, category, asset_id, obj_pth in jobs:
        sc_str, cat_str = flatten(supercategory), flatten(category)
        save_pth = f"{args.save_dir}/{sc_str}/{cat_str}/{asset_id}_{args.number_of_points}.pickle"
        mesh_copy_pth = f"{args.save_dir}/{sc_str}/{cat_str}/{asset_id}.obj"
        if args.skip_done and os.path.exists(save_pth):
            continue
        metadata = downsample_object(
            supercategory=supercategory,
            category=category,
            asset_id=asset_id,
            obj_pth=obj_pth,
            number_of_points=args.number_of_points,
            simplify_method=args.simplify_method,
            seed=args.seed,
        )
        save_object_downsample(metadata, save_pth, obj_pth, mesh_copy_pth)
        written.append(save_pth)
        print(f"[downsample] {supercategory}/{category}/{asset_id}: "
              f"N={metadata['N']} N_raw={metadata['N_raw']} -> {save_pth}")
    return written


if __name__ == "__main__":
    main()
