"""CLI: HOI reconstruction from a learned ComA (the application).

Counterpart of ``coma_tpu/cli/optimize.py`` (reference:
``src/application/optimize.py``): fit a SMPL-X human (VPoser latent, global
orient, translation, hand poses) to a learned ComA, then write the OBJ and
the final losses. Runs on ``--device cuda`` (the default; it raises without
a card) or ``--device cpu``.

Inputs: the extracted ComA pickle and the object downsample pickle (raw pcd
points and normals). SMPL-X and VPoser weights are license-gated files the
user provides (``--smplx_model_path``, ``--vposer_snapshot``, a torch
``state_dict``); without them a synthetic body model of the ComA's vertex
count and a decoder made from a seed (Flax's initialisers: zero biases, so
the body pose stays at the identity) keep the run mechanical. Where
``coma_tpu`` hands the snapshot's (encoder, decoder) pair to the fit and
fails, the port takes the decoder.
"""
from __future__ import annotations

import argparse
import json
import os

from coma_tpu_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--coma_pth", required=True, help="extracted ComA pickle")
    parser.add_argument("--obj_downsample_pth", required=True,
                        help="object downsample pickle (raw pcd points+normals)")
    parser.add_argument("--save_pth", default="optimized.obj")
    parser.add_argument("--losses_json", type=str)
    parser.add_argument("--smplx_model_path", type=str, help="SMPLX_NEUTRAL.npz")
    parser.add_argument("--vposer_snapshot", type=str, help="VPoser torch snapshot")
    parser.add_argument("--reference_object_vertex_index", type=int, default=0)
    parser.add_argument("--contact_threshold", type=float, default=0.3)
    parser.add_argument("--scale_factor", type=float, default=1.0)
    parser.add_argument("--num_iters", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--orientation_weight", type=float, default=1e12)
    parser.add_argument("--contact_weight", type=float, default=2.6e11)
    parser.add_argument("--collision_weight", type=float, default=1e9)
    parser.add_argument("--use_collision", action="store_true")
    add_device_flag(parser)
    return parser


def load_decoder(snapshot_path, device):
    """The VPoser decoder of ``snapshot_path``, or one made from seed 0."""
    import torch

    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.vposer import VPoserDecoder, load_vposer_snapshot

    if snapshot_path and os.path.exists(snapshot_path):
        snap = torch.load(snapshot_path, map_location="cpu", weights_only=True)
        return load_vposer_snapshot(snap, device=device)[1]
    if snapshot_path:
        print("[optimize] WARNING: VPoser snapshot missing; random decoder")
    dec = VPoserDecoder(device=device)
    return init_flax_default_(dec, torch.Generator(device).manual_seed(0)).eval()


def main(argv=None):
    import numpy as np

    from coma_tpu_torch.affordance.io import load_pickle
    from coma_tpu_torch.cli._common import seed_everything
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.geometry.mesh import save_obj
    from coma_tpu_torch.models.smplx import SMPLXModel, random_model
    from coma_tpu_torch.pipelines.application import optimize_smpl

    args = build_parser().parse_args(argv)
    seed_everything(42)
    device = resolve_device(args.device)

    for pth in (args.coma_pth, args.obj_downsample_pth):
        if not os.path.exists(pth):
            raise SystemExit(f"[optimize] input not found: {pth}")
    coma_dict = load_pickle(args.coma_pth)
    obj = load_pickle(args.obj_downsample_pth)
    obj_verts = np.asarray(obj["downsampled_pcd_points_raw"], np.float32)
    obj_normals = np.asarray(obj["downsampled_pcd_normal_raw"], np.float32)

    if args.smplx_model_path and os.path.exists(args.smplx_model_path):
        smplx_model = SMPLXModel.from_npz(args.smplx_model_path, device=device)
    else:
        H = int(np.asarray(coma_dict["prob_grid_canon_human_wrt_obj"]).shape[0])
        smplx_model = random_model(num_verts=H, num_betas=10, num_expr=10, device=device)
        print("[optimize] WARNING: SMPL-X weights missing; synthetic body model")

    result = optimize_smpl(
        smplx_model=smplx_model,
        vposer_decoder=load_decoder(args.vposer_snapshot, device),
        coma_dict=coma_dict,
        obj_verts=obj_verts,
        obj_normals=obj_normals,
        reference_object_vertex_index=args.reference_object_vertex_index,
        contact_threshold=args.contact_threshold,
        scale_factor=args.scale_factor,
        num_iters=args.num_iters,
        lr=args.lr,
        orientation_weight=args.orientation_weight,
        contact_weight=args.contact_weight,
        collision_weight=args.collision_weight,
        use_collision=args.use_collision,
    )
    os.makedirs(os.path.dirname(args.save_pth) or ".", exist_ok=True)
    save_obj(args.save_pth, result.vertices, result.faces)
    losses = {k: float(v) for k, v in result.losses.items()}
    print(f"[optimize] saved {args.save_pth}; final losses {losses}")
    if args.losses_json:
        with open(args.losses_json, "w") as fh:
            json.dump(losses, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
