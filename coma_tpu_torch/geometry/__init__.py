"""Geometry: vector normalisation, rotations, mesh IO and normals, surface
sampling and downsampling."""
from coma_tpu_torch.geometry.transforms import normalize_vectors

__all__ = ["normalize_vectors"]
