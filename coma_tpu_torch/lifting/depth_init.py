"""Depth initialisation: silhouette-IoU search along the camera ray.

Counterpart of ``coma_tpu/lifting/depth_init.py`` (reference:
``src/generation/initialize_depth.py`` — ``compute_nearest_point:41``,
``extract_candidates:92``, ``select_human:134-201``): 2·retrieval_range+1
displacements of the human along the search direction, each rendered into
the scene with the asset as occluder, the IoU of each against the
segmentation mask, and the argmax of (IoU, −|index − C|). All candidates
render in one batched pass.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from coma_tpu_torch.lifting.cameras import OrthoCamera
from coma_tpu_torch.lifting.rasterizer import render_silhouettes_batch, silhouette_iou


def compute_directional_size(mesh_verts: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Extent of a mesh along a direction (``initialize_depth.py:31-38``)."""
    d = direction / torch.linalg.norm(direction)
    proj = mesh_verts @ d
    return proj.max() - proj.min()


def compute_nearest_point(asset_verts: torch.Tensor, point: torch.Tensor,
                          direction: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The asset vertex nearest the ray (point, direction): the ray point
    closest to it, and its signed distance from ``point`` along the ray
    (``initialize_depth.py:compute_nearest_point:41-63``)."""
    d = (direction / torch.linalg.norm(direction)).reshape(1, 3)
    p = point.reshape(1, 3)
    disp = p - asset_verts                                   # (N, 3)
    perp = disp - (disp @ d.T) * d
    idx = torch.argmin(torch.linalg.norm(perp, dim=1))
    disp_sel = p - asset_verts[idx]
    nearest = p - (disp_sel @ d.T) * d
    distance = -(disp_sel @ d.T)[0, 0]
    return nearest.reshape(3), distance


def candidate_displacements(distance_from_center: torch.Tensor, retrieval_range: int,
                            stride) -> torch.Tensor:
    """2·retrieval_range+1 displacement magnitudes centred on the nearest
    object point along the search direction."""
    offsets = torch.arange(-retrieval_range, retrieval_range + 1, dtype=torch.float32,
                           device=torch.as_tensor(distance_from_center).device)
    return distance_from_center + offsets * stride


def initialize_depth_for_sample(
    camera: OrthoCamera,
    human_verts: torch.Tensor,       # (V, 3) world, at the initial depth
    human_faces: torch.Tensor,       # (F, 3)
    gt_human_mask: torch.Tensor,     # (H, W) binary segmentation mask
    displacements: torch.Tensor,     # (C,) candidate magnitudes
    occluder_verts: Optional[torch.Tensor] = None,
    occluder_faces: Optional[torch.Tensor] = None,
    direction: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render every candidate and pick argmax (IoU, −|index − C|).

    ``direction`` defaults to the reference's R[:, 2] (``:306``, not the
    viewing direction −R[:, 2]). Among equal IoUs the largest index wins:
    ``interval_from_center = |idx − C|`` (``:182,200``) is kept as a
    −1e-6·|idx − C| tie-break, which matters because every candidate
    behind the nearest occluder has the same IoU. Returns dict(best_index,
    best_iou, best_displacement, ious, best_verts).
    """
    if direction is None:
        direction = camera.R[:, 2]
    direction = direction / torch.linalg.norm(direction)
    cand_verts = human_verts[None] + displacements[:, None, None] * direction[None, None]
    masks = render_silhouettes_batch(camera, cand_verts, human_faces,
                                     occluder_verts=occluder_verts,
                                     occluder_faces=occluder_faces)        # (C, H, W)
    ious = silhouette_iou(masks, gt_human_mask[None])                      # (C,)
    C = displacements.shape[0]
    center_penalty = torch.abs(torch.arange(C, device=ious.device) - C).to(ious.dtype)
    best = torch.argmax(ious - 1e-6 * center_penalty)
    return dict(best_index=best, best_iou=ious[best], best_displacement=displacements[best],
                ious=ious, best_verts=cand_verts[best])
