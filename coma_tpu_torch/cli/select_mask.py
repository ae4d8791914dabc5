"""CLI: candidate-mask selection (reference: ``src/generation/select_mask.py``;
counterpart of ``coma_tpu/cli/select_mask.py``). PNGs are read with
:mod:`coma_tpu_torch.utils.png` (PIL's ``L``); each view's masks are counted
against its segmentation in one pass on ``--device``."""
from __future__ import annotations

import argparse
import glob as _glob
import os

import numpy as np
import torch

from coma_tpu_torch.cli._common import add_common_flags, lower_all, seed_everything
from coma_tpu_torch.config.assets import CATEGORY2MASK_FILTER_CONFIG
from coma_tpu_torch.core.paths import unflatten
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.pipelines.mask_select import save_valid_mask_ids, select_valid_masks
from coma_tpu_torch.utils.png import read_png, to_gray


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--asset_render_dir", type=str, default="results/generation/renders")
    parser.add_argument("--asset_mask_dir", type=str, default="results/generation/asset_masks")
    parser.add_argument("--asset_seg_dir", type=str, default="results/generation/asset_segs")
    parser.add_argument("--save_dir", type=str, default="results/generation/valid_masks")
    parser.add_argument("--default_min_seg_overlap_ratio", type=float, default=0.3)
    parser.add_argument("--default_max_seg_overlap_ratio", type=float, default=0.9)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)

    render_pths = sorted(_glob.glob(f"{args.asset_render_dir}/*/*/*/*.png"))
    stats = {}
    for render_pth in render_pths:
        sc_str, cat_str, asset_id, view_ext = render_pth.split("/")[-4:]
        supercategory, category = unflatten(sc_str), unflatten(cat_str)
        view_id = view_ext.rsplit(".", 1)[0]
        if supercats and supercategory.lower() not in supercats:
            continue
        if cats and category.lower() not in cats:
            continue

        save_pth = f"{args.save_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.pickle"
        if args.skip_done and os.path.exists(save_pth):
            continue

        seg = to_gray(read_png(f"{args.asset_seg_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.png"))
        if (seg > 0).sum() == 0:
            continue

        mask_pths = sorted(
            _glob.glob(f"{args.asset_mask_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}/*.png"))
        masks = np.stack([to_gray(read_png(p)) for p in mask_pths]) if mask_pths \
            else np.zeros((0,) + seg.shape, np.uint8)
        band = CATEGORY2MASK_FILTER_CONFIG.get(supercategory, {}).get(category, {})
        valid_indices = select_valid_masks(
            torch.as_tensor(seg, device=device), torch.as_tensor(masks, device=device),
            band.get("minimum_seg_overlap_ratio", args.default_min_seg_overlap_ratio),
            band.get("maximum_seg_overlap_ratio", args.default_max_seg_overlap_ratio))
        valid_mask_ids = [mask_pths[i].split("/")[-1].rsplit(".", 1)[0] for i in valid_indices]
        save_valid_mask_ids(save_pth, supercategory, category, asset_id, view_id, valid_mask_ids)
        stats[(supercategory, category)] = stats.get((supercategory, category), 0) + len(
            valid_mask_ids)

    for (sc, cat), n in stats.items():
        print(f"[select_mask] {sc}/{cat}: {n} valid masks")


if __name__ == "__main__":
    main()
