"""Multiview object rendering stage (PyTorch; counterpart of
``coma_tpu/pipelines/rendering.py``).

Reference: ``src/generation/render_objects.py`` — per asset: place it on the
ground plane, build a ring of orthographic cameras (``:125-135``), sample
per-category rotation/displacement perturbations (``:143-236``), rasterize
the grid of candidate human-placement bbox masks (``:274-303`` via
``utils/blenderproc.py:render_points:183-198`` and a convex-hull fill),
render the object's segmentation (``:314-318``) and its RGB (Cycles with the
MTL textures, here :func:`coma_tpu_torch.lifting.rasterizer.render_textured`),
and save camera and object-pose pickles (``:330-347``).

The geometry of cameras, perturbations and mask quads is numpy on the host
(the same ``Generator`` calls in the same order, so the perturbations are
``coma_tpu``'s); segmentation, RGB and the masks are made on the camera's
device, the masks by :mod:`coma_tpu_torch.geometry.polygon` (OpenCV's fill,
exactly).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from coma_tpu_torch.geometry.polygon import fill_convex_hulls
from coma_tpu_torch.lifting.cameras import OrthoCamera, project_points
from coma_tpu_torch.lifting.rasterizer import (
    make_sky_env,
    rasterize_depth,
    render_silhouette,
    render_textured,
)


def euler_xyz_to_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Blender 'XYZ' euler -> rotation matrix (R = Rz @ Ry @ Rx)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def build_camera_ring(length_z: float, ortho_scale_world: float, view_num: int,
                      elevation_deg: float = 15.0, azimuth_deg: float = 0.0,
                      z_scale: float = 1.0, radius: float = 10.0,
                      resolution: Tuple[int, int] = (512, 512),
                      device="cuda") -> List[OrthoCamera]:
    """The ring of orthographic cameras around the asset (reference
    ``render_objects.py:125-135``): view i at azimuth a_i = azimuth + 2π i /
    view_num on a circle of ``radius`` at height radius·sin(elev) +
    length_z·z_scale, rotation_euler XYZ = (π/2 − elev, 0, π/2 + a_i);
    ``ortho_scale_world`` is ``max_extent * config.ortho_scale * 2``."""
    elevation = np.deg2rad(elevation_deg)
    azimuth = np.deg2rad(azimuth_deg)
    cameras = []
    for view_idx in range(view_num):
        a = azimuth + (2 * np.pi / view_num) * view_idx
        location = np.array([
            radius * np.cos(elevation) * np.cos(a),
            radius * np.cos(elevation) * np.sin(a),
            radius * np.sin(elevation) + length_z * z_scale,
        ])
        R = euler_xyz_to_matrix(np.pi / 2 - elevation, 0.0, np.pi / 2 + a)
        cameras.append(OrthoCamera(
            R=torch.as_tensor(np.float32(R), device=device),
            t=torch.as_tensor(np.float32(location), device=device),
            scale=float(ortho_scale_world), resolution=resolution))
    return cameras


def _sample_interval_list(intervals, n, rng) -> np.ndarray:
    """The reference's interval sampler (``render_objects.py:155-162``): per
    draw, a uniform from each interval, one picked with probability ∝
    (start − end) normalised (kept verbatim, quirk included)."""
    prob = np.array([start - end for start, end in intervals], dtype=np.float64)
    prob = prob / prob.sum()
    out = []
    for _ in range(n):
        draws = [rng.uniform(lo, hi) for lo, hi in intervals]
        out.append(rng.choice(draws, p=prob) if len(draws) > 1 else draws[0])
    return np.asarray(out)


def sample_perturbations(perturb_config: Dict, perturb_sample_num: int,
                         rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """Rotation/displacement perturbations per category config (reference
    ``render_objects.py:143-236``): dicts of a rotation matrix and a
    fractional displacement."""
    if not perturb_config.get("need_perturb", False):
        return [dict(rotation_matrix=np.eye(3), displacement_frac=np.zeros(3))]

    def rot_list(key, make):
        if perturb_config.get(key) is not None:
            angles = _sample_interval_list(perturb_config[key], perturb_sample_num, rng)
            return [make(np.deg2rad(a)) for a in angles]
        return [np.eye(3)] * perturb_sample_num

    def rot_x(a):
        return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])

    def rot_y(a):  # the reference's y-rotation has the sign of sin flipped
        return np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])

    def rot_z(a):
        return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    rx = rot_list("rotation_x", rot_x)
    ry = rot_list("rotation_y", rot_y)
    rz = rot_list("rotation_z", rot_z)
    disp = []
    for key in ("displacement_x", "displacement_y", "displacement_z"):
        if perturb_config.get(key) is not None:
            disp.append(_sample_interval_list(perturb_config[key], perturb_sample_num, rng))
        else:
            disp.append(np.zeros(perturb_sample_num))
    return [
        dict(rotation_matrix=rx[i] @ ry[i] @ rz[i],
             displacement_frac=np.array([disp[0][i], disp[1][i], disp[2][i]]))
        for i in range(perturb_sample_num)
    ]


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def render_points_px(camera: OrthoCamera, points: np.ndarray) -> np.ndarray:
    """World points -> pixel coordinates as the mask-grid path forms them
    (``utils/blenderproc.py:render_points:183-198``: x scaled by W and y by
    H, where the lifting path uses max(W, H); equal at square images)."""
    W, H = camera.resolution
    R, t = _host64(camera.R), _host64(camera.t)
    compat = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float64)
    cam = (points - t) @ R @ compat.T
    px = cam[..., 0] * W / camera.scale + W / 2.0
    py = cam[..., 1] * H / camera.scale + H / 2.0
    return np.stack([px, py], axis=-1)


def candidate_quads(camera: OrthoCamera, asset_bounds, bbox_size, stride_x: float,
                    stride_y: float, azimuth_z: float) -> np.ndarray:
    """(M, 4, 2) int32 pixel corners of the ground-plane grid of standing
    bboxes (reference ``render_objects.py:254-303``: ±bbox_y along the
    camera-aligned x axis at heights 0 and 2·bbox_z), truncated to int32 as
    ``quad.astype(np.int32)`` does."""
    (x_min, y_min, _), (x_max, y_max, _) = asset_bounds
    bbox_x, bbox_y, bbox_z = bbox_size
    xs = np.arange(np.ceil((x_min - bbox_x) / stride_x) * stride_x, x_max + bbox_x, stride_x)
    ys = np.arange(np.ceil((y_min - bbox_y) / stride_y) * stride_y, y_max + bbox_y, stride_y)
    gx, gy = np.meshgrid(xs, ys)
    centers = np.column_stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)])
    axis_x = np.array([np.cos(azimuth_z), np.sin(azimuth_z), 0.0])
    axis_z = np.array([0.0, 0.0, 1.0])
    four = np.stack([
        centers + axis_x * bbox_y,
        centers + axis_x * bbox_y + axis_z * bbox_z * 2,
        centers - axis_x * bbox_y + axis_z * bbox_z * 2,
        centers - axis_x * bbox_y,
    ], axis=1)
    return render_points_px(camera, four).astype(np.int32)


def candidate_mask_grid(camera: OrthoCamera, asset_bounds, bbox_size, stride_x: float,
                        stride_y: float, azimuth_z: float) -> torch.Tensor:
    """The grid of candidate human-placement masks, (M, H, W) uint8 in {0,
    255} on the camera's device: each quad's ``cv2.convexHull`` filled by
    ``cv2.fillConvexPoly``'s rule, all M at once."""
    quads = candidate_quads(camera, asset_bounds, bbox_size, stride_x, stride_y, azimuth_z)
    W, H = camera.resolution
    return fill_convex_hulls(quads, H, W, camera.R.device)


def render_object_views(camera: OrthoCamera, verts: np.ndarray, faces: np.ndarray,
                        light_dir=(0.3, 0.2, -0.9)) -> Tuple[np.ndarray, np.ndarray]:
    """Object segmentation + flat-Lambertian preview RGB, normals from the
    z-buffer's screen-space gradient -> (seg (H, W) uint8 in {0, 255}, rgb
    (H, W, 3) uint8)."""
    dev = camera.R.device
    verts_t = torch.as_tensor(np.float32(verts), device=dev)
    faces_t = torch.as_tensor(np.asarray(faces), device=dev).long()
    seg = render_silhouette(camera, verts_t, faces_t).cpu().numpy().astype(np.uint8) * 255
    W, H = camera.resolution
    pz = project_points(camera, verts_t)
    zbuf = rasterize_depth(pz[faces_t], H, W).cpu().numpy()
    covered = np.isfinite(zbuf)
    gz = np.where(covered, zbuf,
                  np.nanmax(np.where(covered, zbuf, np.nan)) if covered.any() else 1.0)
    gy, gx = np.gradient(gz)
    n = np.stack([-gx, -gy, np.ones_like(gz)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    light = -np.asarray(light_dir, dtype=np.float64)
    light /= np.linalg.norm(light)
    shade = np.clip(n @ light, 0.15, 1.0)
    rgb = np.where(covered[..., None], (shade[..., None] * 220).astype(np.uint8), 255)
    return seg, np.repeat(rgb, 3, axis=-1).astype(np.uint8)


def textured_scene(camera: OrthoCamera, verts: np.ndarray, tmesh, ground_z: float = 0.0,
                   ground_color: float = 0.78) -> dict:
    """``render_textured``'s inputs for the asset over a ground plane, on
    the camera's device: the asset's triangles, then two 1e4-wide ground
    triangles on an extra constant material; ``tri_w`` the world triangles
    (asset and ground, the shadow receivers) and ``casters`` the asset's
    alone (a flat ground cannot cast onto what stands on it, and its extent
    would swamp the shadow map's footprint)."""
    dev = camera.R.device
    faces = np.asarray(tmesh.faces)
    v = np.asarray(verts, np.float64)
    verts_t = torch.as_tensor(np.float32(verts), device=dev)
    tri_px = project_points(camera, verts_t)[torch.as_tensor(faces, device=dev)]
    fuv = np.asarray(tmesh.face_uvs)
    uvs = tmesh.uvs if len(tmesh.uvs) else np.zeros((1, 2), np.float32)
    tri_uv = uvs[np.clip(fuv, 0, len(uvs) - 1)].astype(np.float32)
    e1 = v[faces[:, 1]] - v[faces[:, 0]]
    e2 = v[faces[:, 2]] - v[faces[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    ext = 1e4
    gverts = np.array([[-ext, -ext, ground_z], [ext, -ext, ground_z],
                       [ext, ext, ground_z], [-ext, ext, ground_z]], np.float32)
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    g_tri = project_points(camera, torch.as_tensor(gverts, device=dev))[torch.as_tensor(
        quad, device=dev)]
    M = tmesh.textures.shape[0]
    textures = np.concatenate([tmesh.textures, np.full((1,) + tmesh.textures.shape[1:],
                                                       ground_color, np.float32)], axis=0)
    casters = v.astype(np.float32)[faces]

    def dev_(a):
        return torch.as_tensor(a, device=dev)

    return dict(
        tri_px=torch.cat([tri_px, g_tri], dim=0),
        tri_uv=dev_(np.concatenate([tri_uv, np.zeros((2, 3, 2), np.float32)], axis=0)),
        tri_mat=dev_(np.concatenate([np.asarray(tmesh.face_material, np.int32),
                                     np.full(2, M, np.int32)])),
        tri_n=dev_(np.concatenate([n, np.tile([[0.0, 0.0, 1.0]], (2, 1))]).astype(np.float32)),
        textures=dev_(textures),
        tri_w=dev_(np.concatenate([casters, gverts[quad]])),
        casters=dev_(casters),
    )


def render_object_views_textured(camera: OrthoCamera, verts: np.ndarray, tmesh,
                                 ground_z: float = 0.0, ground_color: float = 0.78,
                                 shadows: bool = True, ao_samples: int = 0,
                                 light_samples: int = 1, light_cone_deg: float = 0.0,
                                 specular: float = 0.0, roughness: float = 0.35,
                                 sky_env: bool = False, tonemap: bool = False,
                                 gi_samples: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Object segmentation + textured RGB over a ground plane (the
    reference's Cycles render of asset + plane + area light with the MTL
    textures, ``render_objects.py:90,309``, ``utils/blenderproc.py:100-113``)
    -> (seg (H, W) uint8 in {0, 255}, rgb (H, W, 3) uint8, truncated from
    [0, 1] × 255 as ``coma_tpu`` does). ``shadows`` adds the shadow-mapped
    light, ``ao_samples`` hemisphere ambient occlusion, ``specular`` a GGX
    lobe toward the camera, ``sky_env`` the sky/ground ambient, ``tonemap``
    the ACES curve, ``gi_samples`` one reflective-shadow-map bounce."""
    dev = camera.R.device
    verts_t = torch.as_tensor(np.float32(verts), device=dev)
    faces_t = torch.as_tensor(np.asarray(tmesh.faces), device=dev)
    seg = render_silhouette(camera, verts_t, faces_t).to(torch.uint8) * 255
    scene = textured_scene(camera, verts, tmesh, ground_z, ground_color)
    kw = dict(ao_samples=ao_samples, light_samples=light_samples,
              light_cone_deg=light_cone_deg, tonemap=tonemap,
              gi_samples=gi_samples if shadows else 0)
    if shadows:
        kw.update(tri_w=scene["tri_w"], shadow_casters=scene["casters"])
    if specular > 0.0:
        # surface -> camera in world space: the orthographic camera's -front
        kw.update(specular=specular, roughness=roughness,
                  view_dir=tuple((-camera.front).cpu().numpy().astype(np.float32).tolist()))
    if sky_env:
        kw["env_map"] = make_sky_env(device=dev)
    W, H = camera.resolution
    rgb, _ = render_textured(scene["tri_px"], scene["tri_uv"], scene["tri_mat"],
                             scene["tri_n"], scene["textures"], H, W, **kw)
    return seg.cpu().numpy(), (rgb * 255).to(torch.uint8).cpu().numpy()


def save_camera_pickle(path: str, camera: OrthoCamera, obj_rotation: np.ndarray,
                       obj_perturb_R: np.ndarray, obj_location: np.ndarray,
                       obj_displacement: np.ndarray) -> None:
    """The reference's camera pickle (``render_objects.py:330-347``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    euler = _matrix_to_euler_xyz(obj_rotation)
    with open(path, "wb") as handle:
        pickle.dump(
            dict(
                R=_host64(camera.R),
                t=_host64(camera.t),
                scale=camera.scale,
                resolution=tuple(camera.resolution),
                obj_rotation=np.asarray(obj_rotation).reshape(3, 3),
                obj_R=np.asarray(obj_perturb_R).reshape(3, 3),
                obj_euler=np.asarray(euler).reshape(3, 1),
                obj_location=np.asarray(obj_location).reshape(3, 1),
                obj_t=np.asarray(obj_displacement).reshape(3, 1),
            ),
            handle,
            protocol=pickle.HIGHEST_PROTOCOL,
        )


def _matrix_to_euler_xyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> Blender 'XYZ' euler angles."""
    sy = -R[2, 0]
    cy = np.sqrt(max(0.0, 1.0 - sy * sy))
    if cy > 1e-8:
        rx = np.arctan2(R[2, 1], R[2, 2])
        ry = np.arcsin(np.clip(sy, -1, 1))
        rz = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        rx = np.arctan2(-R[1, 2], R[1, 1])
        ry = np.arcsin(np.clip(sy, -1, 1))
        rz = 0.0
    return np.array([rx, ry, rz])
