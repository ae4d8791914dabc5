"""CLI: SMPL-X star-pose template + downsample pickles
(reference: ``src/coma/downsample_human.py``).

With ``--smplx_model_path`` (the SMPL-X npz) the star-pose template (arms
lowered ±30°) comes from the port's LBS on ``--device`` (default ``cuda``,
which raises without a card; TF32 off); with ``--smplx_star_pth`` an
existing template OBJ is read instead (the weights are license-gated and not
redistributable). Downsampling is host work (numpy and the native library).
"""
from __future__ import annotations

import argparse
import os

from coma_tpu_torch import native
from coma_tpu_torch.cli._common import add_device_flag, seed_everything
from coma_tpu_torch.config.metadata import DEFAULT_SEED
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.geometry.mesh import load_obj
from coma_tpu_torch.pipelines.downsample import (
    downsample_human_template,
    save_human_downsample,
    save_star_template,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--smplx_model_path", type=str, help="SMPLX_NEUTRAL.npz")
    parser.add_argument("--smplx_star_pth", type=str, help="existing smplx_star.obj")
    parser.add_argument("--constants_mesh_dir", type=str, default="./constants/mesh")
    parser.add_argument("--simplify_method", choices=["poisson_disk", "uniform"], default="poisson_disk")
    parser.add_argument(
        "--num_human_downsample_points_list",
        type=int,
        nargs="+",
        default=[1000, 1500, 2000, 2048, 20000],
    )
    parser.add_argument("--skip_done", action="store_true")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_device_flag(parser)
    return parser


def main(argv=None) -> list:
    """Returns the downsample pickles written."""
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)

    if args.smplx_model_path:
        from coma_tpu_torch.models.smplx import SMPLXModel, star_pose_vertices

        model = SMPLXModel.from_npz(args.smplx_model_path, device=device)
        vertices = star_pose_vertices(model).cpu().numpy()   # float32, as coma_tpu's
        faces = model.faces_array
        print(f"[downsample_human] star pose on {device}: V={len(vertices)}")
    elif args.smplx_star_pth:
        mesh = load_obj(args.smplx_star_pth)
        vertices, faces = mesh.vertices, mesh.faces
    else:
        raise SystemExit("pass --smplx_model_path or --smplx_star_pth")

    save_star_template(vertices, faces, args.constants_mesh_dir)

    print(f"[downsample_human] poisson-disk elimination: {native.path_name()}")
    written = []
    for num_points in args.num_human_downsample_points_list:
        tag = "FULL" if num_points >= len(vertices) else str(num_points)
        save_pth = f"{args.constants_mesh_dir}/smplx_star_downsampled_{tag}.pickle"
        if args.skip_done and os.path.exists(save_pth):
            continue
        metadata = downsample_human_template(
            vertices, faces, num_points, simplify_method=args.simplify_method, seed=args.seed
        )
        path = save_human_downsample(metadata, num_points, args.constants_mesh_dir)
        written.append(path)
        print(f"[downsample_human] N={metadata['N']} N_raw={metadata['N_raw']} -> {path}")
    return written


if __name__ == "__main__":
    main()
