"""Vector transform primitives (PyTorch).

Counterpart of ``coma_tpu/geometry/transforms.py``: ``normalize_vectors``
for the extraction, ``rodrigues`` and ``skew`` for SMPL-X's LBS, ``rot6d_to_rotmat`` for
Hand4Whole, ``quat_to_rotmat``, and the host-side ``rigid_align_np`` for the depth optimizer.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize_vectors(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalize vectors along the last axis.

    The norm is clamped below by ``eps`` so zero vectors stay zero instead of
    NaN (reference: ``utils/transformations.py:normalize_vectors_torch``).
    The squared norm of the 3-vectors is summed in a fixed order, as the
    contact kernel sums it.
    """
    sq = v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2] + v[..., 2:3] * v[..., 2:3]
    return v / torch.clamp(torch.sqrt(sq), min=eps)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product (skew-symmetric) matrices ``(..., 3, 3)`` of ``(..., 3)``
    vectors: ``skew(v) @ u == cross(v, u)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rodrigues(rotvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle vectors ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``.

    R = I + A·K + B·K² on the unnormalized axis, A = sinθ/θ,
    B = (1-cosθ)/θ², with their Taylor expansions near θ = 0, as
    ``coma_tpu``'s (reference: ``smplx/lbs.py:batch_rodrigues``). K² is
    summed term by term, so no matrix unit rounds it.
    """
    n2 = torch.sum(rotvec * rotvec, dim=-1)[..., None, None]
    ok = n2 > eps * eps
    safe = torch.where(ok, n2, torch.ones_like(n2))
    theta = torch.sqrt(safe)
    A = torch.where(ok, torch.sin(theta) / theta, 1.0 - n2 / 6.0)
    B = torch.where(ok, (1.0 - torch.cos(theta)) / safe, 0.5 - n2 / 24.0)
    K = skew(rotvec)
    KK = (K[..., :, :, None] * K[..., None, :, :]).sum(dim=-2)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + A * K + B * KK


def quat_to_rotmat(quat: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternions ``(..., 4)`` (w, x, y, z) -> rotation matrices ``(..., 3, 3)``
    (``coma_tpu/geometry/transforms.py:65``; reference
    ``utils/transformations.py:quat_to_rotmat``). A zero quaternion gives the
    identity."""
    quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=eps)
    w, x, y, z = quat.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def rot6d_to_rotmat(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Continuous 6D rotations (..., 6) -> rotation matrices (..., 3, 3):
    Gram-Schmidt of ``x[..., :3]`` and ``x[..., 3:6]``, the columns b1, b2,
    b1 × b2 (Hand4Whole's RotationNet; not VPoser's column layout, which is
    ``models/vposer.rot6d_decode``)."""
    a1, a2 = x[..., :3], x[..., 3:6]
    b1 = normalize_vectors(a1, eps)
    b2 = normalize_vectors(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1, eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rigid_align_np(src, dst):
    """Least-squares rigid transform (Kabsch) on the host: R, t (float32)
    with dst ≈ src @ R.T + t, correspondence by index."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    sc, dc = src.mean(axis=0), dst.mean(axis=0)
    H = (src - sc).T @ (dst - dc)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = dc - R @ sc
    return R.astype(np.float32), t.astype(np.float32)
