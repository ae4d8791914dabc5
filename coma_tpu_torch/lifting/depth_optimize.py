"""Depth optimisation: Adam over one displacement scalar per sample.

Counterpart of ``coma_tpu/lifting/depth_optimize.py`` (reference:
``src/generation/optimize_depth.py:run_depth_optimization:432-780``): 200
Adam steps (lr 0.01) on a scalar displacement along the camera front axis,
minimising w_multiview (1e-3) x the mean reprojection MSE of the body
joints over the RANSAC inlier views (``multiview_joint_loss:371-400``) +
w_collision (0.4) x the collision loss. The reference re-runs the SMPL-X
forward every step with residuals that are not optimised, so the forward
is loop-invariant: world joints and vertices are computed once and moved
rigidly along the ray, as in ``coma_tpu``.

``coma_tpu`` vmaps a ``lax.scan`` of ``optax.adam`` over the samples. Here
one (B,) displacement tensor is optimised by :class:`OptaxAdam`; the samples
are independent and Adam is elementwise, so the gradient of the summed loss
gives every sample its own trajectory, as the vmap does. The collision term
takes the whole batch at once (``fn(verts (B, V, 3), aux)`` -> (B,)).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from coma_tpu_torch.lifting.cameras import OrthoCamera, project_points
from coma_tpu_torch.optim import OptaxAdam

W_MULTIVIEW = 1e-3   # optimize_depth.py:804 (w_multiview default)
W_COLLISION = 0.4    # optimize_depth.py:805


def multiview_joint_loss(
    joints_world: torch.Tensor,      # (..., J, 3) world joints
    inlier_R: torch.Tensor,          # (..., K, 3, 3)
    inlier_t: torch.Tensor,          # (..., K, 3)
    inlier_joints_2d: torch.Tensor,  # (..., K, J, 2)
    inlier_valid: torch.Tensor,      # (..., K) 1/0 padding mask
    scale: float,
    resolution: Tuple[int, int],
) -> torch.Tensor:
    """Mean over the valid inlier views of the body-joint reprojection
    error; per view ``mean(sum(err², joint axis))`` as the reference reduces
    it. Leading axes are a batch of samples."""
    views = OrthoCamera(R=inlier_R, t=inlier_t, scale=scale, resolution=resolution)
    proj = project_points(views, joints_world[..., None, :, :])[..., :2]   # (..., K, J, 2)
    per_view = torch.mean(torch.sum((inlier_joints_2d - proj) ** 2, dim=-2), dim=-1)
    return torch.sum(per_view * inlier_valid, dim=-1) / torch.clamp(
        torch.sum(inlier_valid, dim=-1), min=1.0)


@dataclasses.dataclass
class DepthOptResult:
    displacement: torch.Tensor   # (B,) optimised scalar per sample
    verts: torch.Tensor          # (B, V, 3) optimised world vertices
    losses: torch.Tensor         # (B,) final loss values
    history: torch.Tensor        # (num_epochs, B) loss before each step


def optimize_depth_batch(
    joints_world: torch.Tensor,       # (B, 25, 3) body joints at displacement 0
    verts_world: torch.Tensor,        # (B, V, 3) vertices at displacement 0
    cam_front: torch.Tensor,          # (B, 3) unit search directions
    inlier_R: torch.Tensor,           # (B, K, 3, 3) padded inlier cameras
    inlier_t: torch.Tensor,           # (B, K, 3)
    inlier_joints_2d: torch.Tensor,   # (B, K, 25, 2)
    inlier_valid: torch.Tensor,       # (B, K)
    scale: float,
    resolution: Tuple[int, int],
    collision_fn: Optional[Callable] = None,   # (verts (B, V, 3)[, aux]) -> (B,)
    collision_aux=None,                        # dict of tensors with leading B
    num_epochs: int = 200,
    lr: float = 0.01,
    w_multiview: float = W_MULTIVIEW,
    w_collision: float = W_COLLISION,
) -> DepthOptResult:
    """Every sample's displacement in one Adam run. ``collision_fn`` is
    called as ``fn(verts)`` when ``collision_aux`` is None, else ``fn(verts,
    aux)``: ``torch.func.vmap`` of a per-sample factory of ``models/coap.py``
    (``make_{capsule,coap}_collision_aux_fn``) gives one batched launch per
    operation, whatever B. The loop never waits for the device: the
    per-step losses stay there until the end."""
    front = cam_front[:, None, :]

    def loss_fn(d):
        shift = d[:, None, None] * front
        loss = w_multiview * multiview_joint_loss(joints_world + shift, inlier_R, inlier_t,
                                                  inlier_joints_2d, inlier_valid, scale,
                                                  resolution)
        if collision_fn is not None:
            moved = verts_world + shift
            c = collision_fn(moved) if collision_aux is None else collision_fn(moved,
                                                                                collision_aux)
            loss = loss + w_collision * c
        return loss

    d = torch.zeros(joints_world.shape[0], dtype=joints_world.dtype,
                    device=joints_world.device, requires_grad=True)
    opt = OptaxAdam({"d": d}, lr)
    history = []
    for _ in range(num_epochs):
        loss = loss_fn(d)
        (grad,) = torch.autograd.grad(loss.sum(), [d])
        opt.step({"d": d}, {"d": grad})
        history.append(loss.detach())
    with torch.no_grad():
        final = loss_fn(d)
        d = d.detach()
        verts = verts_world + d[:, None, None] * front
    hist = (torch.stack(history) if history
            else torch.zeros((0,) + d.shape, dtype=d.dtype, device=d.device))
    return DepthOptResult(displacement=d, verts=verts, losses=final, history=hist)


def pad_inliers(inliers: List[dict], max_inliers: int, resolution: Tuple[int, int]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a ragged per-sample inlier list to (K, ...) arrays and a valid
    mask. Each inlier: {'R' (3, 3), 't' (3,), 'joints_2d' (25, 2)}."""
    K = max_inliers
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), dtype=np.float32)
    j2d = np.zeros((K, 25, 2), dtype=np.float32)
    valid = np.zeros((K,), dtype=np.float32)
    for i, inl in enumerate(inliers[:K]):
        R[i] = inl["R"]
        t[i] = inl["t"]
        j2d[i] = inl["joints_2d"]
        valid[i] = 1.0
    return R, t, j2d, valid
