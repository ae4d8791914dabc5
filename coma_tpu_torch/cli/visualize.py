"""CLI: visualize affordance products.

Counterpart of ``coma_tpu/cli/visualize.py`` (reference:
``src/visualization/{visualize_human,visualize_object,visualize_occupancy}.py``
— Blender/mayavi replaced by PLY + images). ``coma_tpu`` draws its previews
with matplotlib, which the card machine lacks: here the human preview and
the volume render go through the port's rasterizer on the card, the
object's coloured points are splatted into a z-buffer on the card from
matplotlib's default 3-D view, and every image is written by
``utils/png.py``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from coma_tpu_torch.cli._common import add_device_flag

# matplotlib's default 3-D view (``Axes3D``: elev 30, azim -60), at the
# previews' resolution
OBJECT_ELEV, OBJECT_AZIM = 30.0, -60.0
OBJECT_RESOLUTION = 512
SPLAT_RADIUS = 1     # each point covers (2 * 1 + 1)² pixels


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="what", required=True)

    h = sub.add_parser("human", help="per-vertex affordance on the SMPL-X star mesh")
    h.add_argument("--affordance_npy", required=True, help="human_contact.npy or orientational_tendency.npy")
    h.add_argument("--smplx_star_pth", required=True, help="smplx_star.obj or .pickle")
    h.add_argument("--human_downsample_pth", help="downsample pickle when the affordance is on a subset")
    h.add_argument("--out", default="output/human_affordance")

    o = sub.add_parser("object", help="preview the colored object-contact .ply")
    o.add_argument("--ply", required=True)
    o.add_argument("--out", default="output/object_contact.png")

    c = sub.add_parser("occupancy", help="occupancy probability field")
    c.add_argument("--occupancy_npy", required=True)
    c.add_argument("--out", default="output/occupancy.png")
    c.add_argument("--mode", choices=("volume", "slices"), default="volume",
                   help="'volume': ray-marched 3-D render (the reference's "
                        "mayavi.mlab.pipeline.volume, visualize_occupancy.py"
                        ":27-66); 'slices': slice grid + max-projections")
    c.add_argument("--asset_downsample_pth",
                   help="downsample pickle: composite the canonicalized "
                        "object mesh into the volume render (reference "
                        "visualize_occupancy.py:34-56)")
    c.add_argument("--resolution", type=int, default=512)
    c.add_argument("--elev", type=float, default=20.0)
    c.add_argument("--azim", type=float, default=35.0)
    for p in (h, o, c):
        add_device_flag(p)
    return parser


def splat_points(points: np.ndarray, colors: np.ndarray, resolution: int, elev: float,
                 azim: float, device) -> torch.Tensor:
    """Coloured points as (2·SPLAT_RADIUS + 1)² squares in an orthographic view
    (``elev``, ``azim`` as matplotlib's), z-buffered: each pixel takes the
    nearest point, the lowest index on equal depth; white elsewhere ->
    (H, W, 3) float32 on ``device``."""
    from coma_tpu_torch.visualization.volume import _orbit_axes

    H = W = resolution
    right, up, fwd = (a.to(device) for a in _orbit_axes(elev, azim, device))
    p = torch.as_tensor(np.float32(points), device=device)
    rel = p - (p.amax(0) + p.amin(0)) / 2
    span = float(torch.linalg.norm(p.amax(0) - p.amin(0))) * 1.05 + 1e-12
    px = torch.floor((rel @ right / span + 0.5) * W).long()
    py = torch.floor((0.5 - rel @ up / span) * H).long()
    depth = rel @ fwd
    offsets = torch.arange(-SPLAT_RADIUS, SPLAT_RADIUS + 1, device=device)
    dy, dx = torch.meshgrid(offsets, offsets, indexing="ij")
    X = px[:, None] + dx.reshape(1, -1)
    Y = py[:, None] + dy.reshape(1, -1)
    inside = (X >= 0) & (X < W) & (Y >= 0) & (Y < H)
    flat = (Y.clamp(0, H - 1) * W + X.clamp(0, W - 1))[inside]
    z = depth[:, None].expand_as(X)[inside]
    idx = torch.arange(len(p), device=device)[:, None].expand_as(X)[inside]
    zbuf = torch.full((H * W,), float("inf"), device=device)
    zbuf.scatter_reduce_(0, flat, z, "amin")
    n = len(p)
    win = torch.full((H * W,), n, dtype=torch.long, device=device)
    win.scatter_reduce_(0, flat, torch.where(z == zbuf[flat], idx, torch.full_like(idx, n)),
                        "amin")
    palette = torch.cat([torch.as_tensor(np.float32(colors), device=device).reshape(n, 3),
                         torch.ones((1, 3), device=device)])
    return palette[win].reshape(H, W, 3)


def main(argv=None) -> None:
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.utils.png import write_png
    from coma_tpu_torch.visualization.viz import (
        render_mesh_preview,
        save_vertex_colored_mesh,
        visualize_occupancy_slices,
    )

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.what == "human":
        from coma_tpu_torch.affordance.io import load_pickle
        from coma_tpu_torch.geometry.mesh import load_obj

        if args.smplx_star_pth.endswith(".obj"):
            mesh = load_obj(args.smplx_star_pth)
            verts, faces = mesh.vertices, mesh.faces
        else:
            d = load_pickle(args.smplx_star_pth)
            verts, faces = np.asarray(d["vertices"]), np.asarray(d["faces"])
        weights_sub = np.load(args.affordance_npy)
        weights = np.zeros(len(verts))
        if args.human_downsample_pth:
            meta = load_pickle(args.human_downsample_pth)
            idx = np.asarray(meta["downsample_indices"], np.int64)
            weights[idx] = weights_sub
        else:
            assert len(weights_sub) == len(verts)
            weights = weights_sub
        save_vertex_colored_mesh(f"{args.out}.ply", verts, faces, weights)
        render_mesh_preview(f"{args.out}.png", verts, faces, weights, device=device)
        print(f"[visualize] wrote {args.out}.ply + {args.out}.png")

    elif args.what == "object":
        from coma_tpu_torch.utils.ply import read_ply_pointcloud

        points, _, colors = read_ply_pointcloud(args.ply)
        if colors is None:
            raise SystemExit(f"{args.ply}: the point cloud has no colours")
        img = splat_points(points, colors, OBJECT_RESOLUTION, OBJECT_ELEV, OBJECT_AZIM, device)
        write_png(args.out, np.round(img.cpu().numpy() * 255).astype(np.uint8))
        print(f"[visualize] wrote {args.out}")

    elif args.what == "occupancy":
        info = np.load(args.occupancy_npy, allow_pickle=True).item()
        if args.mode == "slices":
            visualize_occupancy_slices(args.out, info["prob_field"])
        else:
            from coma_tpu_torch.visualization.volume import save_occupancy_volume_render

            mesh = None
            meta = info.get("spatial_grid_metadata") or {}
            if args.asset_downsample_pth:
                from coma_tpu_torch.affordance.io import load_pickle

                d = load_pickle(args.asset_downsample_pth)
                verts = np.asarray(d["obj_vertices_original"], np.float32)
                faces = np.asarray(d["obj_faces_original"], np.int64)
                # canonicalize on the occupancy anchor vertex — the
                # reference indexes the ORIGINAL vertices with the
                # selected idx (0), visualize_occupancy.py:39-41
                mesh = (verts - verts[0][None], faces)
            save_occupancy_volume_render(
                args.out, info["prob_field"], mesh=mesh,
                voxel_size=float(meta.get("voxel_size", 1.0)),
                resolution=args.resolution,
                elev_deg=args.elev, azim_deg=args.azim, device=device,
            )
        print(f"[visualize] wrote {args.out}")


if __name__ == "__main__":
    main()
