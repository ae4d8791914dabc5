"""Joint index maps and robust losses for keypoint fitting (PyTorch).

Counterpart of ``coma_tpu/models/keypoints.py`` (reference: ``utils/smpl.py``):
the SMPL-X -> OpenPose joint permutations, the Geman-McClure robustifier, and
the 21 vertex landmarks SMPL-X appends after its 55 kinematic joints.
"""
from __future__ import annotations

import numpy as np
import torch

# SMPLX -> OpenPose COCO-25 (utils/smpl.py:107-110)
SMPLX_TO_OPENPOSE_BODY = np.array(
    [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     56, 57, 58, 59, 60, 61, 62, 63, 64, 65],
    dtype=np.int32,
)
SMPLX_TO_OPENPOSE_LHAND = np.array(
    [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68, 34, 35, 36, 69,
     31, 32, 33, 70],
    dtype=np.int32,
)
SMPLX_TO_OPENPOSE_RHAND = np.array(
    [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73, 49, 50, 51, 74,
     46, 47, 48, 75],
    dtype=np.int32,
)


def smpl_to_openpose(
    model_type: str = "smplx",
    use_hands: bool = True,
    use_face: bool = False,
    use_face_contour: bool = False,
) -> np.ndarray:
    """COCO-25 permutation (reference: ``utils/smpl.py:smpl_to_openpose:73``):
    67 joints with hands, 25 without."""
    assert model_type == "smplx", "the pipeline only exercises smplx"
    mapping = [SMPLX_TO_OPENPOSE_BODY]
    if use_hands:
        mapping += [SMPLX_TO_OPENPOSE_LHAND, SMPLX_TO_OPENPOSE_RHAND]
    if use_face:
        mapping += [np.arange(76, 127 + 17 * use_face_contour, dtype=np.int32)]
    return np.concatenate(mapping)


def gmof(residual: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """Geman-McClure robustifier (reference: ``utils/smpl.py:GMoF:59``)."""
    sq = residual * residual
    return rho * rho * sq / (sq + rho * rho)


# Face, feet, then left and right fingertips (the reference's vendored smplx,
# ``vertex_joint_selector.py:30-60``, ``vertex_ids.py:47-69``).
SMPLX_LANDMARK_VERTEX_IDS = np.array(
    [9120, 9929, 9448, 616, 6,                  # nose, reye, leye, rear, lear
     5770, 5780, 8846, 8463, 8474, 8635,        # L/R big toe, small toe, heel
     5361, 4933, 5058, 5169, 5286,              # left fingertips (thumb..pinky)
     8079, 7669, 7794, 7905, 8022],             # right fingertips
    dtype=np.int32,
)


def append_vertex_landmarks(vertices: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """(..., V, 3), (..., 55, 3) -> (..., 76, 3), so ``smpl_to_openpose``
    indices 55-75 resolve. Ids clip to V-1, so small synthetic meshes stay
    usable (their landmarks then alias real vertices)."""
    ids = np.clip(SMPLX_LANDMARK_VERTEX_IDS, 0, vertices.shape[-2] - 1)
    picked = vertices.index_select(-2, torch.as_tensor(ids, dtype=torch.long,
                                                        device=vertices.device))
    return torch.cat([joints, picked], dim=-2)
