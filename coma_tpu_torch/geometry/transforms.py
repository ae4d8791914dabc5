"""Vector transform primitives (PyTorch).

Counterpart of ``coma_tpu/geometry/transforms.py``: ``normalize_vectors``
for the extraction, ``rodrigues`` and ``skew`` for SMPL-X's LBS.
"""
from __future__ import annotations

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
