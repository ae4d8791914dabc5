"""Orthographic camera model and coordinate-compat transforms (PyTorch).

Counterpart of ``coma_tpu/lifting/cameras.py`` (reference: the Blender
orthographic camera of ``utils/blenderproc.py:set_camera_config:60-80``, the
OpenGL->Blender compat matrix, ``optimize_depth.py:get_view2joints_render:
185-198``, ``get_projection_matrix:165-183`` and ``convert_cam2real:
79-103``). A camera is a plain dataclass of tensors; every function takes
and returns tensors on the camera's device.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

# constants/generation/visualizers.py (coordinate-compat data)
COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER = np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]
)
COMPATIBILITY_MATRIX_OPENGL_TO_BLENDER = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]
)


@dataclasses.dataclass(frozen=True)
class OrthoCamera:
    """Blender-convention orthographic camera.

    ``R``/``t``: camera-to-world rotation (3, 3) and translation (3,) as the
    camera pickles store them; ``scale``: ortho_scale (world units across
    max(resolution) pixels); ``resolution``: (W, H).
    """

    R: torch.Tensor
    t: torch.Tensor
    scale: float = 1.0
    resolution: Tuple[int, int] = (512, 512)

    @property
    def front(self) -> torch.Tensor:
        """The viewing direction in world space (−Z of the camera)."""
        return -self.R[:, 2]

    @classmethod
    def from_pickle(cls, data: Mapping, device="cuda") -> "OrthoCamera":
        """A camera from a ``render_objects`` pickle's ``R``, ``t``, ``scale``
        and ``resolution``, in float32 on ``device``."""
        return cls(R=torch.as_tensor(np.asarray(data["R"]), dtype=torch.float32, device=device),
                   t=torch.as_tensor(np.asarray(data["t"]), dtype=torch.float32,
                                     device=device).reshape(3),
                   scale=float(data["scale"]), resolution=tuple(data["resolution"]))


def _gl2bl(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(COMPATIBILITY_MATRIX_OPENGL_TO_BLENDER, dtype=like.dtype,
                           device=like.device)


def project_points(camera: OrthoCamera, points: torch.Tensor) -> torch.Tensor:
    """World points (..., N, 3) -> (..., N, 3): pixel x, pixel y, pixel-scale
    depth. A camera whose ``R``/``t`` carry leading axes (a stack of views)
    broadcasts against the points' leading axes."""
    M = camera.R @ _gl2bl(points)
    cam = points @ M - (camera.t[..., None, :] @ M)
    W, H = camera.resolution
    m = float(max(camera.resolution))
    x = cam[..., 0] / camera.scale * m + W / 2.0
    y = cam[..., 1] / camera.scale * m + H / 2.0
    z = cam[..., 2] / camera.scale * m
    return torch.stack([x, y, z], dim=-1)


def dlt_projection(camera: OrthoCamera) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rotation (..., 3, 3), translation (..., 3)) of the pixel-scale
    origin-centred affine projection the DLT uses."""
    m = float(max(camera.resolution))
    gl = _gl2bl(camera.R)
    Rt = camera.R.transpose(-1, -2)
    rotation = (gl @ Rt) / camera.scale * m
    translation = ((-gl @ Rt) @ camera.t[..., None])[..., 0] / camera.scale * m
    return rotation, translation


def triangulate_pair(cam_a: OrthoCamera, cam_b: OrthoCamera, joints_a: torch.Tensor,
                     joints_b: torch.Tensor) -> torch.Tensor:
    """Two-view DLT of corresponding 2-D joints (..., J, 2) -> (..., J, 3)
    world: the two views' first two projection rows stacked into A (4, 3),
    solved for every joint with one pseudo-inverse. ``cam_b`` may be a stack
    of views (leading axes on R/t and on ``joints_b``), each paired with
    ``cam_a``."""
    rot_a, tr_a = dlt_projection(cam_a)
    rot_b, tr_b = dlt_projection(cam_b)
    Wa, Ha = cam_a.resolution
    Wb, Hb = cam_b.resolution
    pa = joints_a - torch.tensor([Wa / 2.0, Ha / 2.0], dtype=joints_a.dtype,
                                 device=joints_a.device)
    pb = joints_b - torch.tensor([Wb / 2.0, Hb / 2.0], dtype=joints_b.dtype,
                                 device=joints_b.device)
    A = torch.cat(torch.broadcast_tensors(rot_a[..., :2, :], rot_b[..., :2, :]), dim=-2)
    b = torch.cat(torch.broadcast_tensors(pa - tr_a[..., None, :2], pb - tr_b[..., None, :2]),
                  dim=-1)                                                 # (..., J, 4)
    return b @ torch.linalg.pinv(A).transpose(-1, -2)                     # (..., J, 3)


def reprojection_mse(camera: OrthoCamera, world_joints: torch.Tensor,
                     joints_2d: torch.Tensor) -> torch.Tensor:
    """mean_j ||project(X_j).xy − x_j||² (the reference's joints_MSE)."""
    proj = project_points(camera, world_joints)[..., :2]
    return torch.mean(torch.sum((proj - joints_2d) ** 2, dim=-1))


def convert_cam2real(verts: torch.Tensor, transl: torch.Tensor, camera: OrthoCamera,
                     focals: Tuple[float, float], princpt: Tuple[float, float],
                     z_mean: float) -> torch.Tensor:
    """Regressed-human camera space (B, V, 3) + (B, 3) -> world space."""
    W, H = camera.resolution
    m = float(max(camera.resolution))
    v = verts + transl[:, None, :]
    fx, fy = focals
    v = v * torch.tensor([fx / z_mean, fy / z_mean, (fx + fy) / 2.0 / z_mean],
                         dtype=v.dtype, device=v.device)
    z_mean_img = torch.mean(v[:, :, 2])
    v = v + torch.tensor([princpt[0], princpt[1], 0.0], dtype=v.dtype, device=v.device)
    v = torch.cat([v[..., :2], v[..., 2:] + (500.0 - z_mean_img)], dim=-1)
    v = (v - torch.tensor([W / 2.0, H / 2.0, 0.0], dtype=v.dtype, device=v.device)) \
        / m * camera.scale
    return v @ (_gl2bl(v) @ camera.R.T) + camera.t


def pixels_to_world(points_px: torch.Tensor, camera: OrthoCamera) -> torch.Tensor:
    """Pixel-scale points (..., 3) -> world (the inverse of project_points)."""
    W, H = camera.resolution
    m = float(max(camera.resolution))
    p = (points_px - torch.tensor([W / 2.0, H / 2.0, 0.0], dtype=points_px.dtype,
                                  device=points_px.device)) / m * camera.scale
    return p @ (_gl2bl(p) @ camera.R.T) + camera.t
