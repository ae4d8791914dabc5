"""Geometry: vector normalisation, rotations, mesh IO and normals, surface
sampling and downsampling."""
from coma_tpu_torch.geometry.transforms import (
    normalize_vectors,
    quat_to_rotmat,
    rodrigues,
    rot6d_to_rotmat,
    skew,
)

__all__ = [
    "normalize_vectors",
    "quat_to_rotmat",
    "rodrigues",
    "rot6d_to_rotmat",
    "skew",
]
