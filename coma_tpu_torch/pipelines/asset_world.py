"""Asset world-frame placement shared by the lifting stages (numpy; a copy
of ``coma_tpu/pipelines/asset_world.py``).

Reference parity: the asset load+transform performed identically by
``initialize_depth.py:330-346``, ``optimize_depth.py:636-661`` and
``compute_metrics.py:150-170``: obj verts -> trimesh->Blender axis compat ->
perturbation (obj_R, obj_t from the camera pickle) -> ground-plane snap for
the z-normalized datasets.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from coma_tpu_torch.lifting.cameras import COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER

Z_NORMALIZED_DATASETS = ("SHAPENET", "SKETCHFAB", "INTERCAP", "BEHAVE")


def asset_to_world(
    obj_verts: np.ndarray,
    camera_data: Dict,
    dataset_type: str,
) -> Tuple[np.ndarray, float]:
    """Returns (world verts, z_min used for the canonical back-transform)."""
    verts = np.asarray(obj_verts, np.float64) @ COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER
    z_min = float(verts[:, 2].min())
    verts = verts @ np.asarray(camera_data["obj_R"]).T + np.asarray(camera_data["obj_t"]).reshape(1, 3)
    if dataset_type in Z_NORMALIZED_DATASETS:
        verts = verts - np.array([0.0, 0.0, z_min])
    return verts, z_min


def human_to_canonical(
    human_verts: np.ndarray, camera_data: Dict, z_min: float
) -> np.ndarray:
    """World human verts -> the asset's canonical (trimesh) frame.

    Reference: ``compute_metrics.py:240-241`` — undo the perturbation and the
    axis compat so samples from all views/perturbations share one frame.
    """
    obj_R = np.asarray(camera_data["obj_R"])
    obj_t = np.asarray(camera_data["obj_t"]).reshape(1, 3)
    M = COMPATIBILITY_MATRIX_TRIMESH_P3D_TO_BLENDER
    verts_blender = (human_verts + [0.0, 0.0, z_min] - obj_t) @ obj_R - [0.0, 0.0, z_min]
    return verts_blender @ M.T + np.array([0.0, 0.0, z_min]) @ M.T
