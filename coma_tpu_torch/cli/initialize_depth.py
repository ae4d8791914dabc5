"""CLI: depth initialisation by occluded-silhouette IoU search
(reference: ``src/generation/initialize_depth.py``).

Counterpart of ``coma_tpu/cli/initialize_depth.py``: per regressed human,
the pixel-space mesh lifted to the view's world frame, 2·retrieval_range+1
candidate depths along R[:, 2] around the asset point nearest the pelvis
ray, all rendered in one pass with the asset as occluder, and the one whose
silhouette best matches the segmentation mask kept. Sentinels propagate;
no segmentation mask gives "ERRONEOUS SAMPLE DUE TO TOO SMALL HUMAN".
``--filter_out`` keeps only the local minima of the human-asset
triangle-collision curve (``ops/collision.py``). Runs on ``--device cuda``
(the default; it raises without a card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle

import numpy as np
import torch

from coma_tpu_torch.cli._common import (
    add_common_flags,
    lower_all,
    seed_everything,
    shard_worklist,
)
from coma_tpu_torch.config.assets import CATEGORY2DATASET_TYPE, resolve_asset_obj_path
from coma_tpu_torch.core.paths import unflatten
from coma_tpu_torch.core.sentinels import TOO_SMALL_HUMAN
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.geometry.mesh import load_obj
from coma_tpu_torch.pipelines.asset_world import asset_to_world


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--camera_dir", type=str, default="results/generation/cameras")
    parser.add_argument("--human_pred_dir", type=str, default="results/generation/human_preds")
    parser.add_argument("--human_seg_dir", type=str, default="results/generation/human_segs")
    parser.add_argument("--save_dir", type=str, default="results/generation/human_before_opt")
    parser.add_argument("--interval_ratio", type=float, default=0.3)
    parser.add_argument("--retrieval_range", type=int, default=3)
    parser.add_argument("--asset_obj_pth", type=str, help="override asset .obj path")
    parser.add_argument("--disable_lowres_switch_for_behave", action="store_true")
    parser.add_argument("--no_initialize", action="store_true")
    parser.add_argument("--filter_out", action="store_true",
                        help="keep only the depth candidates at local minima of the "
                             "human-asset triangle-collision curve "
                             "(initialize_depth.py:96-125; with the upstream kernel_size 9 > "
                             "2*retrieval_range the window keeps nothing: use e.g. "
                             "--kernel_size 5)")
    parser.add_argument("--max_collisions", type=int, default=1000,
                        help="collision-count cap per candidate (the BVH's output buffer, "
                             "initialize_depth.py:388)")
    parser.add_argument("--kernel_size", type=int, default=9,
                        help="local-minimum window of the collision filter "
                             "(initialize_depth.py:387)")
    return parser


def build_worklist(args, pred_dir: str, save_dir: str) -> list:
    """(input pickle, output pickle) pairs of a 7-level tree that pass the
    filters; the output keeps the input's path under ``save_dir``."""
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)
    prompts = lower_all(args.prompts)
    work = []
    for p in sorted(_glob.glob(f"{pred_dir}/*/*/*/*/*/*/*.pickle")):
        sc_str, cat_str, asset, view, mask_id, prompt, fname = p.split("/")[-7:]
        if supercats and unflatten(sc_str).lower() not in supercats:
            continue
        if cats and unflatten(cat_str).lower() not in cats:
            continue
        if prompts and prompt.split(",")[0].lower() not in prompts:
            continue
        out = f"{save_dir}/{sc_str}/{cat_str}/{asset}/{view}/{mask_id}/{prompt}/{fname}"
        if args.skip_done and os.path.exists(out):
            continue
        work.append((p, out))
    return shard_worklist(work, args.parallel_idx, args.parallel_num)


def load_asset_world(args, sc_str: str, cat_str: str, asset_id: str, view_id: str, cam_data,
                     cache: dict):
    """(world verts, faces, z_min) of the view's asset, cached per view."""
    key = (sc_str, cat_str, asset_id, view_id)
    if key not in cache:
        supercategory, category = unflatten(sc_str), unflatten(cat_str)
        dataset_type = CATEGORY2DATASET_TYPE[(supercategory, category)]
        obj_pth = args.asset_obj_pth or resolve_asset_obj_path(
            dataset_type, supercategory, category, asset_id,
            disable_lowres_switch_for_behave=args.disable_lowres_switch_for_behave)
        mesh = load_obj(obj_pth)
        verts, z_min = asset_to_world(mesh.vertices, cam_data, dataset_type)
        cache[key] = (verts, mesh.faces, z_min)
    return cache[key]


def segmentation_mask(seg_dir: str, rel: str):
    """The union of a sample's instance masks, or None."""
    seg_pth = f"{seg_dir}/{rel}"
    if not os.path.exists(seg_pth):
        return None
    with open(seg_pth, "rb") as fh:
        seg = pickle.load(fh)
    if isinstance(seg, str) or len(seg.get("pred_masks", [])) == 0:
        return None
    return np.any(seg["pred_masks"], axis=0)


def dump(out: str, payload) -> None:
    with open(out, "wb") as fh:
        pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)


def main(argv=None) -> dict:
    from coma_tpu_torch.lifting.cameras import OrthoCamera, pixels_to_world
    from coma_tpu_torch.lifting.depth_init import (
        compute_directional_size,
        compute_nearest_point,
        initialize_depth_for_sample,
    )

    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)
    work = build_worklist(args, args.human_pred_dir, args.save_dir)

    cameras, assets = {}, {}
    n_ok = n_sent = 0
    for pred_pth, out in work:
        sc_str, cat_str, asset_id, view_id, mask_id, prompt, fname = pred_pth.split("/")[-7:]
        with open(pred_pth, "rb") as fh:
            pred = pickle.load(fh)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if isinstance(pred, str):  # propagate the sentinel
            dump(out, pred)
            n_sent += 1
            continue

        camera_pth = f"{args.camera_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.pickle"
        if camera_pth not in cameras:
            with open(camera_pth, "rb") as fh:
                cameras[camera_pth] = pickle.load(fh)
        cam_data = cameras[camera_pth]
        camera = OrthoCamera.from_pickle(cam_data, device)
        asset_verts, asset_faces, _ = load_asset_world(args, sc_str, cat_str, asset_id, view_id,
                                                       cam_data, assets)

        human_verts = pixels_to_world(
            torch.as_tensor(np.asarray(pred["verts"]), dtype=torch.float32, device=device),
            camera)
        pelvis = pixels_to_world(torch.as_tensor(np.asarray(pred["pelvis"]), dtype=torch.float32,
                                                 device=device)[None], camera)[0]

        if args.no_initialize:
            dump(out, dict(idx=None, verts=human_verts.cpu().numpy(), faces=pred["faces"],
                           IoU=None, human_segmentation=None, interval_from_center=None,
                           displacement=None))
            n_ok += 1
            continue

        # the reference searches along R[:, 2] (:306)
        direction = camera.R[:, 2]
        asset_v = torch.as_tensor(np.asarray(asset_verts), dtype=torch.float32, device=device)
        asset_f = torch.as_tensor(np.asarray(asset_faces), dtype=torch.long, device=device)
        human_f = torch.as_tensor(np.asarray(pred["faces"]), dtype=torch.long, device=device)
        interval = compute_directional_size(human_verts, direction) * args.interval_ratio
        _, dist = compute_nearest_point(asset_v, pelvis, direction)
        offsets = torch.arange(-args.retrieval_range, args.retrieval_range + 1,
                               dtype=torch.float32, device=device)
        displacements = dist + offsets * interval

        if args.filter_out:
            # the local-minimum collision pre-filter (extract_candidates:96-125)
            from coma_tpu_torch.ops.collision import collision_curve, filter_candidate_indices

            curve = np.minimum(collision_curve(human_verts, human_f, asset_v, asset_f,
                                               displacements, direction),
                               args.max_collisions)
            kept = filter_candidate_indices(curve, args.kernel_size)
            if kept.size == 0:
                # an empty candidate list: select_human gives None (:362-365)
                dump(out, TOO_SMALL_HUMAN)
                n_sent += 1
                continue
            displacements = displacements[torch.as_tensor(kept, device=device)]

        rel = f"{sc_str}/{cat_str}/{asset_id}/{view_id}/{mask_id}/{prompt}/{fname}"
        gt_mask = segmentation_mask(args.human_seg_dir, rel)
        if gt_mask is None:
            dump(out, TOO_SMALL_HUMAN)
            n_sent += 1
            continue

        result = initialize_depth_for_sample(
            camera, human_verts, human_f, torch.as_tensor(gt_mask, device=device),
            displacements, occluder_verts=asset_v, occluder_faces=asset_f,
            direction=direction)
        best = int(result["best_index"])
        d = float(result["best_displacement"])
        dump(out, dict(
            idx=best,
            verts=result["best_verts"].cpu().numpy(),
            faces=pred["faces"],
            IoU=float(result["best_iou"]),
            human_segmentation=None,
            interval_from_center=abs(best - len(displacements)),
            displacement=(d * direction.cpu().numpy()).reshape(1, 3),
        ))
        n_ok += 1
    print(f"[initialize_depth] {n_ok} initialized, {n_sent} sentinels")
    return dict(initialized=n_ok, sentinels=n_sent)


if __name__ == "__main__":
    main()
