"""BEHAVE contact visualization: part-colored contact spheres + a Kinect
perspective render of the human/object scene.

Counterpart of ``coma_tpu/visualization/contact_viz.py``. Reference parity: ``utils/behave.py:925-1060`` —
- ``ContactVisualizer`` (:925): sample 10k points on the object surface,
  find those within ``thres`` of the SMPL body, group by 14 coarse body
  parts, and emit one colored sphere per contacted part.
- ``Pyt3DWrapper``/``MeshRendererWrapper`` (:1006/:970): render the meshes
  plus contact spheres with a fixed Kinect color camera (pytorch3d
  SoftPhong); here the port's z-buffer rasterizer
  (:func:`coma_tpu_torch.lifting.rasterizer.render_textured`) with solid
  per-mesh colors.

Design notes (divergences from the reference, shared with ``coma_tpu``):
- The reference reads per-vertex part labels from the BEHAVE data drop
  (``smpl_parts_dense.pkl``); this derives them from the model itself —
  argmax of the SMPL-X LBS skinning weights mapped through a 55-joint ->
  14-part table (:func:`part_labels_from_lbs`) — so no external pickle is
  needed and the labels work for the 10475-vertex SMPL-X topology.
- Rendering is one rasterizer pass over all meshes joined as a scene (the
  reference's ``join_meshes_as_scene``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# 55 SMPL-X joints (root + 54, models/smplx.py) -> 14 coarse parts.
PART_NAMES = (
    "hips", "spine", "neck", "head",
    "leftUpLeg", "rightUpLeg", "leftLeg", "rightLeg",
    "leftFoot", "rightFoot", "leftArm", "rightArm",
    "leftHand", "rightHand",
)

_JOINT_TO_PART = {
    0: 0,                                # pelvis
    3: 1, 6: 1, 9: 1, 13: 1, 14: 1,      # spine1-3 + collars
    12: 2,                               # neck
    15: 3, 22: 3, 23: 3, 24: 3,          # head, jaw, eyes
    1: 4, 2: 5,                          # upper legs
    4: 6, 7: 6, 5: 7, 8: 7,              # knees + ankles
    10: 8, 11: 9,                        # feet
    16: 10, 18: 10, 17: 11, 19: 11,      # shoulders + elbows
    20: 12, 21: 13,                      # wrists
}
for _j in range(25, 40):                 # left fingers
    _JOINT_TO_PART[_j] = 12
for _j in range(40, 55):                 # right fingers
    _JOINT_TO_PART[_j] = 13

# 14 visually-distinct part colors (the reference reorders a matplotlib
# palette via its own color_reorder table; the exact hues are cosmetic).
PART_COLORS = np.array([
    (0.65, 0.34, 0.16), (1.00, 0.60, 0.20), (0.55, 0.55, 0.10),
    (0.90, 0.80, 0.25), (0.17, 0.63, 0.17), (0.56, 0.87, 0.54),
    (0.84, 0.15, 0.16), (1.00, 0.60, 0.59), (0.58, 0.40, 0.74),
    (0.77, 0.69, 0.84), (0.12, 0.47, 0.71), (0.68, 0.78, 0.91),
    (0.89, 0.47, 0.76), (0.50, 0.50, 0.50),
], np.float32)

# Default mesh colors: SMPL blue-ish, object yellow-ish
# (reference SMPL_OBJ_COLOR_LIST, behave.py).
SMPL_OBJ_COLOR_LIST = [
    (0.65098039, 0.74117647, 0.85882353),
    (251 / 255.0, 128 / 255.0, 114 / 255.0),
]


def part_labels_from_lbs(lbs_weights: np.ndarray) -> np.ndarray:
    """(V,) int part label per vertex = argmax skinning joint -> part table.

    The functional equivalent of the reference's ``load_part_labels``
    (``behave.py:933-939``) without the external ``smpl_parts_dense.pkl``.
    """
    w = np.asarray(lbs_weights)
    joint = np.argmax(w, axis=-1)
    table = np.zeros(w.shape[-1], np.int32)
    for j, p in _JOINT_TO_PART.items():
        if j < table.shape[0]:
            table[j] = p
    return table[joint]


def uv_sphere(
    center: np.ndarray, radius: float, n_lat: int = 10, n_lon: int = 16
) -> Tuple[np.ndarray, np.ndarray]:
    """A small UV-sphere mesh (verts, faces) — the reference's
    ``Sphere(center, radius).to_mesh()`` (psbody)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.cos(lon), np.sin(lon)], -1)                  # (L, 2)
    verts = [np.array([0.0, 0.0, radius])]
    for t in lat[1:-1]:
        r, z = np.sin(t) * radius, np.cos(t) * radius
        verts.extend(np.concatenate([ring * r, np.full((n_lon, 1), z)], -1))
    verts.append(np.array([0.0, 0.0, -radius]))
    verts = np.asarray(verts, np.float32) + np.asarray(center, np.float32)

    faces = []
    top, bot = 0, len(verts) - 1
    row = lambda i: 1 + i * n_lon
    for k in range(n_lon):
        faces.append((top, row(0) + k, row(0) + (k + 1) % n_lon))
    for i in range(n_lat - 2):
        for k in range(n_lon):
            a, b = row(i) + k, row(i) + (k + 1) % n_lon
            c, d = row(i + 1) + k, row(i + 1) + (k + 1) % n_lon
            faces.append((a, c, d))
            faces.append((a, d, b))
    for k in range(n_lon):
        faces.append((bot, row(n_lat - 2) + (k + 1) % n_lon, row(n_lat - 2) + k))
    return verts, np.asarray(faces, np.int64)


def get_contact_spheres(
    human_verts: np.ndarray,
    part_labels: np.ndarray,
    obj_verts: np.ndarray,
    obj_faces: np.ndarray,
    thres: float = 0.04,
    radius: float = 0.06,
    n_samples: int = 10_000,
    seed: int = 42,
) -> Dict[int, Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray]]]:
    """Per-part contact spheres: {part: (color, (sphere_verts, sphere_faces))}.

    Reference: ``ContactVisualizer.get_contact_spheres`` (``behave.py:946-967``)
    — sample the object surface, keep points within ``thres`` of the body,
    group by the nearest body vertex's part, one sphere at each group mean.
    """
    from scipy.spatial import cKDTree

    from coma_tpu_torch.geometry.mesh import Mesh
    from coma_tpu_torch.geometry.sampling import sample_surface_uniform

    rng = np.random.default_rng(seed)
    points, _ = sample_surface_uniform(
        Mesh(np.asarray(obj_verts, np.float64), np.asarray(obj_faces)), n_samples, rng
    )
    dist, idx = cKDTree(np.asarray(human_verts)).query(points)
    contact = dist < thres
    if not contact.any():
        return {}
    labels = np.asarray(part_labels)[idx[contact]]
    pts = points[contact]
    out = {}
    for part in range(len(PART_NAMES)):
        sel = labels == part
        if sel.any():
            center = pts[sel].mean(axis=0)
            out[part] = (PART_COLORS[part], uv_sphere(center, radius))
    return out


class KinectCamera:
    """The BEHAVE color-camera intrinsics (``Pyt3DWrapper.get_kinect_camera``,
    ``behave.py:1015-1033``), scaled to the render resolution. pytorch3d's
    ``R = diag(-1,-1,1)`` x/y flip is folded into the projection."""

    NATIVE = (2048, 1536)
    FX, FY = 979.7844, 979.840
    CX, CY = 1018.952, 779.486

    def __init__(self, image_size: Tuple[int, int] = (512, 384)):
        self.width, self.height = image_size
        sx = self.width / self.NATIVE[0]
        sy = self.height / self.NATIVE[1]
        self.fx, self.fy = self.FX * sx, self.FY * sy
        self.cx, self.cy = self.CX * sx, self.CY * sy

    def project(self, points: np.ndarray) -> np.ndarray:
        """(V, 3) camera-frame points -> (V, 3) [px, py, depth]."""
        p = np.asarray(points, np.float64)
        z = np.maximum(p[:, 2], 1e-6)
        px = self.cx - self.fx * p[:, 0] / z
        py = self.cy - self.fy * p[:, 1] / z
        return np.stack([px, py, z], -1).astype(np.float32)


def render_contact_scene(
    meshes: Sequence[Tuple[np.ndarray, np.ndarray]],
    colors: Optional[Sequence] = None,
    image_size: Tuple[int, int] = (512, 384),
    viz_contact: bool = False,
    part_labels: Optional[np.ndarray] = None,
    camera: Optional[KinectCamera] = None,
    thres: float = 0.04,
    device="cuda",
) -> np.ndarray:
    """Render [human, object, ...] meshes (+ optional contact spheres) from
    the Kinect camera on ``device`` -> (H, W, 3) float32 in [0, 1].

    The native ``Pyt3DWrapper.render_meshes`` (``behave.py:1035-1049``):
    with ``viz_contact`` the human/object contact spheres are appended to
    the scene with their part colors. Meshes are in the Kinect color frame
    (+z in front of the camera), like the reference's.
    """
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.lifting.rasterizer import render_textured

    dev = resolve_device(device)

    meshes = [(np.asarray(v), np.asarray(f)) for v, f in meshes]
    colors = list(colors) if colors is not None else list(SMPL_OBJ_COLOR_LIST)
    while len(colors) < len(meshes):
        colors.append((0.7, 0.7, 0.7))
    colors = colors[: len(meshes)]

    if viz_contact:
        if len(meshes) < 2:
            raise ValueError("viz_contact needs [human, object] meshes")
        if part_labels is None:
            part_labels = np.zeros(len(meshes[0][0]), np.int32)
        spheres = get_contact_spheres(
            meshes[0][0], part_labels, meshes[1][0], meshes[1][1], thres=thres
        )
        for _, (color, sphere) in sorted(spheres.items()):
            meshes.append(sphere)
            colors.append(color)

    cam = camera or KinectCamera(image_size)
    tri_px, tri_n, tri_mat = [], [], []
    for m, (verts, faces) in enumerate(meshes):
        pz = cam.project(verts)
        tri_px.append(pz[faces])
        v = np.asarray(verts, np.float64)
        e1 = v[faces[:, 1]] - v[faces[:, 0]]
        e2 = v[faces[:, 2]] - v[faces[:, 0]]
        n = np.cross(e1, e2)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        tri_n.append(n.astype(np.float32))
        tri_mat.append(np.full(len(faces), m, np.int32))

    tri_px = np.concatenate(tri_px)
    tri_n = np.concatenate(tri_n)
    tri_mat = np.concatenate(tri_mat)
    tri_uv = np.zeros((len(tri_px), 3, 2), np.float32)
    textures = np.asarray(colors, np.float32).reshape(-1, 1, 1, 3)

    rgb, _ = render_textured(
        *(torch.as_tensor(a, device=dev) for a in (tri_px, tri_uv, tri_mat, tri_n, textures)),
        cam.height, cam.width,
        light_dir=(0.0, -0.6, -0.8),    # the reference's point light at
        flip_y=False,                    # (0, -2, 0) in front of the camera
    )
    return rgb.cpu().numpy()
