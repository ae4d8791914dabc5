"""RANSAC inlier mining over multi-view triangulations (PyTorch).

Counterpart of ``coma_tpu/lifting/triangulation.py`` (reference:
``optimize_depth.py:compute_ransac_inclusives_with_triangulation:143-368``):
the reference view's 2-D joints are triangulated (DLT) against every other
view's; candidates whose reference-view reprojection MSE is under
``triangulation_threshold`` are kept, sorted by total MSE and capped at
``maximum_candidates``; then each kept triangulation votes for every kept
candidate whose own-view reprojection error is under ``ransac_threshold``,
and the one with the most votes gives the inlier set.

All candidates triangulate in one batch and the (K, K) vote matrix is one
batched expression; the thresholds, the sorts and the cap run on the host
in numpy, as in ``coma_tpu``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from coma_tpu_torch.lifting.cameras import OrthoCamera, project_points, triangulate_pair


@dataclasses.dataclass
class RansacResult:
    inlier_indices: np.ndarray      # indices into the candidate list, error-sorted
    best_candidate: int             # index of the winning triangulation
    num_inliers: int
    triangulations: np.ndarray      # (C, J, 3)
    mses: np.ndarray                # (C,) total (ref + own) reprojection MSE


def _mse(camera: OrthoCamera, X: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """Per view, mean_j ||project(X_j).xy − x_j||² (the reference's joints_MSE)."""
    proj = project_points(camera, X)[..., :2]
    return torch.mean(torch.sum((proj - joints) ** 2, dim=-1), dim=-1)


def mine_ransac_inliers(
    ref_camera: OrthoCamera,
    ref_joints_2d: torch.Tensor,        # (J, 2) reference view
    cand_cameras: List[OrthoCamera],    # C other-view cameras
    cand_joints_2d: torch.Tensor,       # (C, J, 2) other views' joints
    maximum_candidates: int = 400,
    ransac_threshold: float = 200.0,
    triangulation_threshold: float = 10.0,
) -> Optional[RansacResult]:
    """The winning inlier set, or None if no candidate survives."""
    C = len(cand_cameras)
    if C == 0:
        return None
    views = OrthoCamera(R=torch.stack([c.R for c in cand_cameras]),
                        t=torch.stack([c.t for c in cand_cameras]),
                        scale=cand_cameras[0].scale, resolution=cand_cameras[0].resolution)
    tri = triangulate_pair(ref_camera, views, ref_joints_2d, cand_joints_2d)   # (C, J, 3)
    ref_mse = _mse(ref_camera, tri, ref_joints_2d)
    own_mse = _mse(views, tri, cand_joints_2d)
    total_mse = (ref_mse + own_mse).cpu().numpy()
    ref_mse = ref_mse.cpu().numpy()

    keep = np.flatnonzero(ref_mse < triangulation_threshold)
    if keep.size == 0:
        return None
    keep = keep[np.argsort(total_mse[keep])][:maximum_candidates]

    # vote: candidate i's triangulation reprojected into candidate j's view
    keep_t = torch.as_tensor(keep, device=tri.device)
    kept = OrthoCamera(R=views.R[keep_t][None], t=views.t[keep_t][None], scale=views.scale,
                       resolution=views.resolution)
    errors = _mse(kept, tri[keep_t][:, None], cand_joints_2d[keep_t][None]).cpu().numpy()
    votes = errors < ransac_threshold
    counts = votes.sum(axis=1)
    best = int(np.argmax(counts))
    inlier_local = np.flatnonzero(votes[best])
    inlier_local = inlier_local[np.argsort(errors[best, inlier_local])]
    return RansacResult(
        inlier_indices=keep[inlier_local],
        best_candidate=int(keep[best]),
        num_inliers=int(counts[best]),
        triangulations=tri.cpu().numpy(),
        mses=total_mse,
    )
