"""CLI: multiview object rendering (reference: ``src/generation/render_objects.py``;
counterpart of ``coma_tpu/cli/render_objects.py``).

Blender-free: renders each view's object segmentation and textured RGB
(shadows, ambient occlusion, sky environment, GGX specular, ACES tonemap) on
the card, fills the grid of candidate masks there, and writes the PNGs with
:mod:`coma_tpu_torch.utils.png` and the camera pickles in the reference
schema. ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from coma_tpu_torch.cli._common import add_common_flags, lower_all, seed_everything
from coma_tpu_torch.config.assets import (
    CATEGORY2ASSET,
    CATEGORY2CAMERA_CONFIG,
    CATEGORY2PERTURB_CONFIG,
    DATASET_PTHS,
    DATASET_TYPE2CATEGORIES,
    discover_assets,
    resolve_asset_obj_path,
)
from coma_tpu_torch.core.paths import flatten
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.geometry.mesh import load_obj_textured
from coma_tpu_torch.pipelines.rendering import (
    build_camera_ring,
    candidate_mask_grid,
    render_object_views_textured,
    sample_perturbations,
    save_camera_pickle,
)
from coma_tpu_torch.utils.png import write_png

# Blender's .obj import convention: obj (x, y-up, z-forward) -> world
# (x, -z, y) (the reference reads sizes with the same axis correction,
# render_objects.py:95-99)
OBJ_TO_WORLD = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--dataset_type", type=str, choices=list(DATASET_PTHS.keys()))
    parser.add_argument("--obj_pth", type=str, help="single-asset mode")
    parser.add_argument("--supercategory", type=str)
    parser.add_argument("--category", type=str)
    parser.add_argument("--asset_id", type=str)
    parser.add_argument("--asset_render_dir", type=str, default="results/generation/renders")
    parser.add_argument("--asset_mask_dir", type=str, default="results/generation/asset_masks")
    parser.add_argument("--asset_seg_dir", type=str, default="results/generation/asset_segs")
    parser.add_argument("--camera_dir", type=str, default="results/generation/cameras")
    parser.add_argument("--resolution", type=int, nargs=2, default=[512, 512])
    parser.add_argument("--default_stride_x", type=float, default=0.1)
    parser.add_argument("--default_stride_y", type=float, default=0.1)
    parser.add_argument("--default_elevation", type=float, default=15.0)
    parser.add_argument("--default_azimuth", type=float, default=0.0)
    parser.add_argument("--default_view_num", type=int, default=8)
    parser.add_argument("--default_bbox_size", type=float, nargs=3, default=[0.45, 0.45, 0.95])
    parser.add_argument("--default_perturb_sample_num", type=int, default=1)
    parser.add_argument("--ao_samples", type=int, default=8,
                        help="hemisphere ambient-occlusion directions for the RGB render "
                             "(GI-style contact darkening; 0 disables)")
    parser.add_argument("--soft_shadow_samples", type=int, default=1,
                        help="area-light directions for soft shadows (1 = hard shadow)")
    parser.add_argument("--light_cone_deg", type=float, default=5.0,
                        help="area-light cone half-angle used when --soft_shadow_samples > 1")
    parser.add_argument("--specular", type=float, default=0.25,
                        help="GGX specular strength (0 = pure Lambertian); fidelity target "
                             "is the Cycles Principled BSDF default")
    parser.add_argument("--roughness", type=float, default=0.35,
                        help="GGX roughness used when --specular > 0")
    parser.add_argument("--flat_ambient", action="store_true",
                        help="disable the sky/ground environment ambient term")
    parser.add_argument("--no_tonemap", action="store_true",
                        help="linear clip instead of the ACES filmic curve")
    parser.add_argument("--gi_samples", type=int, default=0,
                        help="one-bounce indirect-light taps per pixel via a reflective "
                             "shadow map (color bleeding / bounce fill, the single-bounce "
                             "slice of Cycles GI); 0 disables")
    return parser


def render_asset(args, supercategory, category, asset_id, obj_pth, device) -> int:
    """Render all (perturbation x view) combinations of one asset; returns
    the number of views written."""
    sc_str, cat_str = flatten(supercategory), flatten(category)
    mesh = load_obj_textured(obj_pth)
    verts_world = mesh.vertices @ OBJ_TO_WORLD.T

    camera_config = CATEGORY2CAMERA_CONFIG[supercategory][category]
    if asset_id in camera_config.get("asset_specific_config", {}):
        camera_config = camera_config["asset_specific_config"][asset_id]
    perturb_config = CATEGORY2PERTURB_CONFIG[supercategory][category]

    # asset size + ground placement (render_objects.py:93-110)
    z_min = verts_world[:, 2].min()
    verts_world = verts_world - np.array([0.0, 0.0, z_min])
    lengths = verts_world.max(axis=0) - verts_world.min(axis=0)
    scale = float(lengths.max()) * camera_config["ortho_scale"] * 2

    view_num = camera_config.get("view_num", args.default_view_num)
    perturb_num = camera_config.get("perturb_sample_num", args.default_perturb_sample_num)
    elevation = camera_config.get("elevation", args.default_elevation)
    azimuth = camera_config.get("azimuth", args.default_azimuth)
    cameras = build_camera_ring(
        length_z=float(lengths[2]), ortho_scale_world=scale, view_num=view_num,
        elevation_deg=elevation, azimuth_deg=azimuth, z_scale=camera_config["z_scale"],
        resolution=tuple(args.resolution), device=device)
    rng = np.random.default_rng(args.seed)
    perturbs = sample_perturbations(perturb_config, perturb_num, rng)

    dirs = {}
    for kind, base in (("render", args.asset_render_dir), ("mask", args.asset_mask_dir),
                       ("seg", args.asset_seg_dir), ("camera", args.camera_dir)):
        dirs[kind] = f"{base}/{sc_str}/{cat_str}/{asset_id}"
        os.makedirs(dirs[kind], exist_ok=True)

    n_written = 0
    for p_idx, perturb in enumerate(perturbs):
        R_p = perturb["rotation_matrix"]
        disp = perturb["displacement_frac"] * lengths
        pv = verts_world @ R_p.T + disp[None]
        for v_idx, camera in enumerate(cameras):
            view_id = f"view:{p_idx * view_num + v_idx:05d}"
            seg_pth = f"{dirs['seg']}/{view_id}.png"
            if args.skip_done and os.path.exists(seg_pth):
                continue
            seg, rgb = render_object_views_textured(
                camera, pv, mesh, ao_samples=args.ao_samples,
                light_samples=args.soft_shadow_samples, light_cone_deg=args.light_cone_deg,
                specular=args.specular, roughness=args.roughness,
                sky_env=not args.flat_ambient, tonemap=not args.no_tonemap,
                gi_samples=args.gi_samples)
            write_png(seg_pth, seg)
            write_png(f"{dirs['render']}/{view_id}.png", rgb)

            angle_z = np.pi / 2 + np.deg2rad(azimuth) + (2 * np.pi / view_num) * v_idx
            masks = candidate_mask_grid(
                camera, (pv.min(axis=0), pv.max(axis=0)),
                bbox_size=camera_config.get("bbox_size", tuple(args.default_bbox_size)),
                stride_x=camera_config.get("stride_x", args.default_stride_x),
                stride_y=camera_config.get("stride_y", args.default_stride_y),
                azimuth_z=angle_z).cpu().numpy()
            mask_dir = f"{dirs['mask']}/{view_id}"
            os.makedirs(mask_dir, exist_ok=True)
            for m_idx, mask in enumerate(masks):
                write_png(f"{mask_dir}/{m_idx:05d}.png", mask)

            save_camera_pickle(
                f"{dirs['camera']}/{view_id}.pickle", camera,
                obj_rotation=R_p,          # world-frame object rotation
                obj_perturb_R=R_p, obj_location=disp, obj_displacement=disp)
            n_written += 1
    return n_written


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(args.seed)

    jobs = []
    if args.obj_pth:
        jobs.append((args.supercategory, args.category, args.asset_id, args.obj_pth))
    else:
        supercats, cats = lower_all(args.supercategories), lower_all(args.categories)
        try:
            # enumerate from the dataset's own metadata (the reference's
            # per-dataset adapters, render_objects.py:352-719)
            found = discover_assets(args.dataset_type)
        except (OSError, KeyError):
            # dataset metadata absent: fall back to the whitelist + path schema
            found = []
            for supercategory, category in DATASET_TYPE2CATEGORIES[args.dataset_type]:
                for asset_id in CATEGORY2ASSET[supercategory][category]:
                    found.append((supercategory, category, asset_id,
                                  resolve_asset_obj_path(args.dataset_type, supercategory,
                                                         category, asset_id)))
        for supercategory, category, asset_id, obj_pth in found:
            if supercats and supercategory.lower() not in supercats:
                continue
            if cats and category.lower() not in cats:
                continue
            jobs.append((supercategory, category, asset_id, obj_pth))

    for supercategory, category, asset_id, obj_pth in jobs:
        n = render_asset(args, supercategory, category, asset_id, obj_pth, device)
        print(f"[render] {supercategory}/{category}/{asset_id}: {n} views")


if __name__ == "__main__":
    main()
