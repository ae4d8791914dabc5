"""CLI: multiview RANSAC and depth optimisation
(reference: ``src/generation/optimize_depth.py``).

Counterpart of ``coma_tpu/cli/optimize_depth.py``. Per sample: RANSAC
inlier views mined from batched DLT triangulations of the other views'
regressed joints, then the displacement along R[:, 2] optimised (Adam, 200
steps) against the multiview joint loss plus the collision term — neural
COAP when the converted weights and the SMPL-X npz are given (the
reference's default), weight-free capsules otherwise. All samples optimise
together in one batch; the SMPL-X forward is hoisted out of the loop, and
meshes of fewer vertices are padded by repeating their last one. Sentinels
("NOT ALLOWED VIEWPOINT PROMPTS", "TOO LITTLE INLIERS") propagate like the
reference's. Runs on ``--device cuda`` (the default; it raises without a
card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle

import numpy as np
import torch

from coma_tpu_torch.cli._common import add_common_flags, seed_everything
from coma_tpu_torch.cli.initialize_depth import build_worklist, dump
from coma_tpu_torch.config.prompts import ALLOWED_VIEWPOINT_AUGMENTATIONS
from coma_tpu_torch.core.paths import unflatten
from coma_tpu_torch.core.sentinels import NOT_ALLOWED_VIEWPOINT, TOO_LITTLE_INLIERS
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.models.keypoints import smpl_to_openpose


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--camera_dir", type=str, default="results/generation/cameras")
    parser.add_argument("--human_preds_dir", type=str, default="results/generation/human_preds")
    parser.add_argument("--human_initial_dir", type=str,
                        default="results/generation/human_before_opt")
    parser.add_argument("--save_dir", type=str, default="results/generation/human_after_opt")
    parser.add_argument("--maximum_candidates", type=int, default=400)
    parser.add_argument("--ransac_threshold", type=float, default=200.0)
    parser.add_argument("--triangulation_threshold", type=float, default=100.0)
    parser.add_argument("--num_epoch", type=int, default=200)
    parser.add_argument("--minimum_inliers", type=int, default=1)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--w_collision", type=float, default=0.4)
    parser.add_argument("--w_multiview", type=float, default=1e-3)
    parser.add_argument("--no_collision", action="store_true",
                        help="alias for --collision_backend none")
    parser.add_argument("--max_inliers", type=int, default=16, help="padding cap")
    parser.add_argument("--collision_backend", choices=["auto", "coap", "capsule", "none"],
                        default="auto",
                        help="auto = neural COAP when --coap_ckpt and --smplx_model_path "
                             "resolve, else the capsule backend")
    parser.add_argument("--coap_ckpt", type=str, default="pre-trained/coap/coap.npz",
                        help="COAP's published checkpoint (.ckpt/.pt) or its params in "
                             "the Flax layout (.npz)")
    parser.add_argument("--smplx_model_path", type=str, default="",
                        help="SMPLX_NEUTRAL.npz (poses COAP's bone frames)")
    parser.add_argument("--asset_obj_pth", type=str,
                        help="override asset .obj path (collision scene points)")
    parser.add_argument("--max_scene_points", type=int, default=2048)
    parser.add_argument("--scene_bbox_margin", type=float, default=0.5,
                        help="margin (m) of the scene-point prefilter around the human's box "
                             "(the reference prefilters by the exact box, "
                             "optimize_depth.py:105-112; the margin keeps points reachable "
                             "while the depth moves)")
    return parser


def resolve_backend(args) -> str:
    backend = "none" if args.no_collision else args.collision_backend
    if backend in ("auto", "coap"):
        have_ckpt = bool(args.coap_ckpt) and os.path.exists(args.coap_ckpt)
        have_smplx = bool(args.smplx_model_path) and os.path.exists(args.smplx_model_path)
        if have_ckpt and have_smplx:
            return "coap"
        if backend == "coap":
            raise SystemExit(
                "[optimize_depth] --collision_backend coap needs both --coap_ckpt (got "
                f"{args.coap_ckpt!r}) and --smplx_model_path (got {args.smplx_model_path!r}) "
                "to exist")
        print("[optimize_depth] neural COAP unavailable "
              f"(ckpt={'ok' if have_ckpt else 'missing'}, "
              f"smplx={'ok' if have_smplx else 'missing'}); using the weight-free capsule "
              "backend. Pass --coap_ckpt/--smplx_model_path for the reference loss stack.")
        return "capsule"
    return backend


def load_coap(args, device):
    """(occupancy module, partition, SMPL-X model) of the neural backend.
    ``--coap_ckpt`` is the published checkpoint (``.ckpt``/``.pt``, read by
    its own keys) or a Flax ``.npz``; its parts must be the partition's."""
    from coma_tpu_torch.models.coap import COAPConfig, COAPOccupancy, load_coap_checkpoint
    from coma_tpu_torch.models.coap_partition import build_partition
    from coma_tpu_torch.models.flax_params import load_flax_params
    from coma_tpu_torch.models.smplx import SMPLXModel
    from coma_tpu_torch.utils.checkpoint import load_params

    smplx_model = SMPLXModel.from_npz(args.smplx_model_path, device=device)
    partition = build_partition(smplx_model.lbs_weights.cpu().numpy(), smplx_model.parents)
    if args.coap_ckpt.endswith(".npz"):
        occ = COAPOccupancy(COAPConfig(num_parts=partition.num_parts))
        load_flax_params(occ, load_params(args.coap_ckpt))
    else:
        occ = load_coap_checkpoint(args.coap_ckpt)
        if occ.config.num_parts != partition.num_parts:
            raise ValueError(f"{args.coap_ckpt} holds {occ.config.num_parts} parts, the body "
                             f"model's partition {partition.num_parts}")
    return occ.to(device).eval(), partition, smplx_model


def load_scene_verts(args, sc_str, cat_str, asset_id, cam_data):
    """Asset vertices in the view's world frame (the collision scene
    points), or None when the asset .obj cannot be resolved (collision then
    no-ops for its samples)."""
    from coma_tpu_torch.config.assets import CATEGORY2DATASET_TYPE, resolve_asset_obj_path
    from coma_tpu_torch.geometry.mesh import load_obj
    from coma_tpu_torch.pipelines.asset_world import asset_to_world

    supercategory, category = unflatten(sc_str), unflatten(cat_str)
    dataset_type = CATEGORY2DATASET_TYPE.get((supercategory, category))
    try:
        obj_pth = args.asset_obj_pth or resolve_asset_obj_path(dataset_type, supercategory,
                                                               category, asset_id)
        mesh = load_obj(obj_pth)
    except (KeyError, TypeError, FileNotFoundError, OSError) as exc:
        print(f"[optimize_depth] WARN: no asset mesh for {supercategory}/{category}/"
              f"{asset_id} ({exc}); collision scene empty for its samples")
        return None
    verts, _ = asset_to_world(mesh.vertices, cam_data, dataset_type or "")
    return np.asarray(verts, np.float32)


@torch.no_grad()
def coap_frames_for_sample(smplx_model, smplx_data, verts_world):
    """The SMPL-X model posed by the regressed parameters, its LBS vertices
    rigidly aligned (Kabsch) onto the lifted world vertices and the
    alignment folded into the bone transforms, so COAP's frames live in the
    world. dict(rest_joints (J, 3), rel_transforms (J, 4, 4)), or None when
    the vertex counts differ."""
    from coma_tpu_torch.geometry.transforms import rigid_align_np
    from coma_tpu_torch.models.smplx import smplx_forward

    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=smplx_model.device)
          for k, v in smplx_data.items() if k != "transl"}
    verts_lbs, _, rel_tf, rest_j = smplx_forward(smplx_model, return_rel_transforms=True, **sd)
    verts_lbs = verts_lbs[0].cpu().numpy()
    if verts_lbs.shape[0] != verts_world.shape[0]:
        return None
    R, t = rigid_align_np(verts_lbs, verts_world)
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = R
    A[:3, 3] = t
    return dict(rest_joints=rest_j[0].cpu().numpy().astype(np.float32),
                rel_transforms=A[None] @ rel_tf[0].cpu().numpy().astype(np.float32))


def viewpoint_allowed(prompt: str) -> bool:
    """The viewpoint-prompt gate (``optimize_depth.py:529-535``)."""
    base = prompt.split(",")[0]
    suffix = prompt.replace(base, "")
    viewprompt = "original" if suffix == "" else suffix.strip().lower()
    allowed = {v.strip().lower() if v != "original" else "original"
               for v in ALLOWED_VIEWPOINT_AUGMENTATIONS}
    return viewprompt in allowed


def main(argv=None) -> dict:
    from coma_tpu_torch.lifting.cameras import OrthoCamera, pixels_to_world
    from coma_tpu_torch.lifting.triangulation import mine_ransac_inliers
    from coma_tpu_torch.models.coap import pad_scene_points

    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)
    tri_idx = smpl_to_openpose(use_hands=True)    # 67 joints for the triangulation
    body_idx = smpl_to_openpose(use_hands=False)  # 25 joints for the loss
    body_in_tri = [int(np.where(tri_idx == b)[0][0]) for b in body_idx]

    backend = resolve_backend(args)
    coap = load_coap(args, device) if backend == "coap" else None
    print(f"[optimize_depth] collision backend: {backend}")

    work = build_worklist(args, args.human_initial_dir, args.save_dir)
    cache = {}

    def camera_data(sc_str, cat_str, asset_id, view_id):
        key = ("camera", sc_str, cat_str, asset_id, view_id)
        if key not in cache:
            with open(f"{args.camera_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.pickle",
                      "rb") as fh:
                cache[key] = pickle.load(fh)
        return cache[key]

    batch = []
    n_sent = 0
    for init_pth, out in work:
        sc_str, cat_str, asset_id, view_id, mask_id, prompt, fname = init_pth.split("/")[-7:]
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if not viewpoint_allowed(prompt):
            dump(out, NOT_ALLOWED_VIEWPOINT)
            n_sent += 1
            continue
        with open(init_pth, "rb") as fh:
            initial = pickle.load(fh)
        if isinstance(initial, str):
            dump(out, initial)
            n_sent += 1
            continue
        mainprompt = prompt.split(",")[0]
        pred_pth = (f"{args.human_preds_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}/{mask_id}/"
                    f"{mainprompt}/{fname}")
        with open(pred_pth, "rb") as fh:
            pred = pickle.load(fh)
        if isinstance(pred, str):
            dump(out, pred)
            n_sent += 1
            continue

        cam_data = camera_data(sc_str, cat_str, asset_id, view_id)
        ref_cam = OrthoCamera.from_pickle(cam_data, device)

        # the other views' predictions (same asset and main prompt)
        cand_cams, cand_joints = [], []
        for o in sorted(_glob.glob(f"{args.human_preds_dir}/{sc_str}/{cat_str}/{asset_id}/*/*/"
                                   f"{mainprompt}/*.pickle")):
            o_view = o.split("/")[-4]
            if o_view == view_id:
                continue
            with open(o, "rb") as fh:
                o_pred = pickle.load(fh)
            if isinstance(o_pred, str):
                continue
            cand_cams.append(OrthoCamera.from_pickle(
                camera_data(sc_str, cat_str, asset_id, o_view), device))
            cand_joints.append(np.asarray(o_pred["joints_proj"])[tri_idx])

        result = None
        if cand_cams:
            result = mine_ransac_inliers(
                ref_cam,
                torch.as_tensor(np.asarray(pred["joints_proj"])[tri_idx], dtype=torch.float32,
                                device=device),
                cand_cams,
                torch.as_tensor(np.stack(cand_joints), dtype=torch.float32, device=device),
                maximum_candidates=args.maximum_candidates,
                ransac_threshold=args.ransac_threshold,
                triangulation_threshold=args.triangulation_threshold)
        joints_img = pred.get("joints_img")
        if result is None or result.num_inliers < args.minimum_inliers \
                or joints_img is None or np.asarray(joints_img).ndim != 2:
            dump(out, TOO_LITTLE_INLIERS)
            n_sent += 1
            continue

        # world joints at the initialised depth: the 3-D pixel joints lifted,
        # plus depth init's displacement (only this rigid offset changes in
        # the loop; see lifting/depth_optimize.py)
        joints_world = pixels_to_world(
            torch.as_tensor(np.asarray(joints_img), dtype=torch.float32, device=device),
            ref_cam).cpu().numpy()
        init_disp = np.asarray(initial.get("displacement") if initial.get("displacement")
                               is not None else np.zeros(3)).reshape(-1)[:3]
        joints_world = joints_world + init_disp[None]
        verts0 = np.asarray(initial["verts"], np.float32)

        # collision scene points: the view's asset vertices inside the
        # human's box and margin (optimize_depth.py:105-124)
        scene_pts = scene_valid = coap_aux = None
        if backend != "none":
            key = ("scene", sc_str, cat_str, asset_id, view_id)
            if key not in cache:
                cache[key] = load_scene_verts(args, sc_str, cat_str, asset_id, cam_data)
            scene = cache[key]
            if scene is not None and len(scene):
                lo = verts0.min(0) - args.scene_bbox_margin
                hi = verts0.max(0) + args.scene_bbox_margin
                scene = scene[np.all((scene >= lo) & (scene <= hi), axis=1)]
            scene_pts, scene_valid = pad_scene_points(
                scene if scene is not None else np.zeros((0, 3), np.float32),
                args.max_scene_points)
        if backend == "coap":
            coap_aux = coap_frames_for_sample(coap[2], pred["smplx_data"], verts0)
            if coap_aux is None:
                print(f"[optimize_depth] WARN: vertex count mismatch vs the SMPL-X model for "
                      f"{init_pth}; collision off for this sample")
                scene_valid = np.zeros_like(scene_valid)
                J = coap[2].num_joints
                coap_aux = dict(rest_joints=np.zeros((J, 3), np.float32),
                                rel_transforms=np.tile(np.eye(4, dtype=np.float32), (J, 1, 1)))

        inlier_set = set(result.inlier_indices.tolist())
        batch.append(dict(
            out=out, faces=initial["faces"], verts=verts0, joints_world=joints_world[body_idx],
            scene_pts=scene_pts, scene_valid=scene_valid, coap_aux=coap_aux, cam_data=cam_data,
            inliers=[dict(R=c.R.cpu().numpy(), t=c.t.cpu().numpy(),
                          joints_2d=cand_joints[i][body_in_tri])
                     for i, c in enumerate(cand_cams) if i in inlier_set],
            num_inliers=result.num_inliers))

    result = optimize_batch(batch, args, backend, coap, device) if batch else None
    print(f"[optimize_depth] optimized {len(batch)}, {n_sent} sentinels")
    return dict(optimized=len(batch), sentinels=n_sent, result=result)


def optimize_batch(batch, args, backend, coap, device):
    """One Adam run over every sample of ``batch``; writes their pickles and
    returns the :class:`DepthOptResult`."""
    from coma_tpu_torch.lifting.depth_optimize import optimize_depth_batch, pad_inliers

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    scale = float(batch[0]["cam_data"]["scale"])
    resolution = tuple(batch[0]["cam_data"]["resolution"])
    V = max(len(b["verts"]) for b in batch)
    verts_w = [np.pad(b["verts"], ((0, V - len(b["verts"])), (0, 0)), mode="edge")
               for b in batch]
    padded = [pad_inliers(b["inliers"], args.max_inliers, resolution) for b in batch]
    Rs, ts, j2ds, valids = (np.stack([p[k] for p in padded]) for k in range(4))
    joints_w = np.stack([b["joints_world"] for b in batch])

    collision_fn = collision_aux = None
    if backend != "none":
        collision_aux = dict(base_centroid=t(np.stack(verts_w).mean(axis=1)),
                             scene_points=t(np.stack([b["scene_pts"] for b in batch])),
                             scene_valid=t(np.stack([b["scene_valid"] for b in batch])))
    if backend == "capsule":
        from coma_tpu_torch.models.coap import make_capsule_collision_aux_fn

        collision_fn = torch.func.vmap(make_capsule_collision_aux_fn())
        collision_aux["joints"] = t(joints_w)
    elif backend == "coap":
        from coma_tpu_torch.models.coap import make_coap_collision_aux_fn

        collision_fn = torch.func.vmap(make_coap_collision_aux_fn(coap[0], coap[1]))
        collision_aux.update(
            rest_joints=t(np.stack([b["coap_aux"]["rest_joints"] for b in batch])),
            rel_transforms=t(np.stack([b["coap_aux"]["rel_transforms"] for b in batch])),
            translation=torch.zeros((len(batch), 3), dtype=torch.float32, device=device))

    result = optimize_depth_batch(
        joints_world=t(joints_w), verts_world=t(np.stack(verts_w)),
        cam_front=t(np.stack([np.asarray(b["cam_data"]["R"])[:, 2] for b in batch])),
        inlier_R=t(Rs), inlier_t=t(ts), inlier_joints_2d=t(j2ds), inlier_valid=t(valids),
        scale=scale, resolution=resolution, collision_fn=collision_fn,
        collision_aux=collision_aux, num_epochs=args.num_epoch, lr=args.lr,
        w_multiview=args.w_multiview, w_collision=args.w_collision)
    verts = result.verts.cpu().numpy()
    for i, b in enumerate(batch):
        dump(b["out"], dict(verts=verts[i][: len(b["verts"])],
                            faces=np.asarray(b["faces"], np.uint32),
                            num_inliers=int(b["num_inliers"])))
    return result


if __name__ == "__main__":
    main()
