"""CLI: finalise 3D HOI samples with quality metrics
(reference: ``src/generation/compute_metrics.py``).

Counterpart of ``coma_tpu/cli/compute_metrics.py``. Per optimised human:
the intersection-volume ratio with the asset (voxel ray parity, refined at
twice the resolution near the post-filter's 0.05), the silhouette IoU of
the human re-rendered with the asset as occluder against the segmentation
mask, and the back-transform into the asset's canonical frame. Writes the
``human_sample`` pickles; the on-disk key ``interscetion_ratio`` [sic] is
the reference's (``compute_metrics.py:237-247``). Runs on ``--device cuda``
(the default; it raises without a card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from coma_tpu_torch.cli._common import add_common_flags, seed_everything
from coma_tpu_torch.cli.initialize_depth import (
    build_worklist,
    dump,
    load_asset_world,
    segmentation_mask,
)
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.pipelines.asset_world import human_to_canonical


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--human_after_opt_dir", type=str,
                        default="results/generation/human_after_opt")
    parser.add_argument("--human_seg_dir", type=str, default="results/generation/human_segs")
    parser.add_argument("--camera_dir", type=str, default="results/generation/cameras")
    parser.add_argument("--save_dir", type=str, default="results/generation/human_sample")
    parser.add_argument("--asset_obj_pth", type=str)
    parser.add_argument("--voxel_resolution", type=int, default=64)
    parser.add_argument("--disable_lowres_switch_for_behave", action="store_true")
    return parser


def main(argv=None) -> dict:
    from coma_tpu_torch.lifting.cameras import OrthoCamera
    from coma_tpu_torch.lifting.metrics import intersection_volume_ratio_adaptive
    from coma_tpu_torch.lifting.rasterizer import render_silhouette, silhouette_iou

    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)
    work = build_worklist(args, args.human_after_opt_dir, args.save_dir)

    assets = {}
    n_ok = n_sent = n_refined = 0
    for human_pth, out in work:
        sc_str, cat_str, asset_id, view_id, mask_id, prompt, fname = human_pth.split("/")[-7:]
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(human_pth, "rb") as fh:
            human = pickle.load(fh)
        if isinstance(human, str):  # sentinel propagation (:222-224)
            dump(out, human)
            n_sent += 1
            continue

        with open(f"{args.camera_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.pickle",
                  "rb") as fh:
            cam_data = pickle.load(fh)
        camera = OrthoCamera.from_pickle(cam_data, device)
        asset_verts, asset_faces, z_min = load_asset_world(args, sc_str, cat_str, asset_id,
                                                           view_id, cam_data, assets)
        hv = torch.as_tensor(np.asarray(human["verts"]), dtype=torch.float32, device=device)
        hf = torch.as_tensor(np.asarray(human["faces"], np.int64), device=device)
        av = torch.as_tensor(np.asarray(asset_verts), dtype=torch.float32, device=device)
        af = torch.as_tensor(np.asarray(asset_faces), dtype=torch.long, device=device)

        # metric 1: the intersection-volume ratio, refined at 2x near 0.05
        ratio, refined = intersection_volume_ratio_adaptive(
            hv, hf, av, af, resolution=args.voxel_resolution,
            fine_resolution=2 * args.voxel_resolution)
        n_refined += refined

        # metric 2: silhouette IoU against the segmentation (asset occluding)
        iou = 0.0
        gt = segmentation_mask(args.human_seg_dir,
                               f"{sc_str}/{cat_str}/{asset_id}/{view_id}/{mask_id}/{prompt}/"
                               f"{fname}")
        if gt is not None:
            rendered = render_silhouette(camera, hv, hf, occluder_verts=av, occluder_faces=af)
            iou = float(silhouette_iou(rendered, torch.as_tensor(gt, device=device)))

        # the canonical-frame back-transform (:240-241)
        payload = dict(human)
        payload.update(verts=human_to_canonical(np.asarray(human["verts"]), cam_data, z_min),
                       z_min=z_min, IoU=iou,
                       interscetion_ratio=ratio)  # [sic] the reference's on-disk key
        dump(out, payload)
        n_ok += 1
    print(f"[compute_metrics] {n_ok} samples finalized, {n_sent} sentinels, "
          f"{n_refined} refined at {2 * args.voxel_resolution}^3")
    return dict(finalized=n_ok, sentinels=n_sent, refined=n_refined)


if __name__ == "__main__":
    main()
