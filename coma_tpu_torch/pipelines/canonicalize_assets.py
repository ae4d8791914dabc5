"""Asset canonicalization (a copy of ``coma_tpu/pipelines/canonicalize_assets.py``;
reference: ``utils/canonicalize.py``, a Blender script rotating the BEHAVE
backpack / InterCap suitcase to the generation pose and recentring the
origin, ported as a plain mesh transform).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from coma_tpu_torch.geometry.mesh import Mesh
from coma_tpu_torch.pipelines.rendering import euler_xyz_to_matrix

# per-category canonicalization (rotation in degrees XYZ, recenter mode)
CANONICALIZATION = {
    ("BEHAVE", "backpack"): dict(rotation_xyz_deg=(90.0, 0.0, 0.0), recenter="bottom"),
    ("INTERCAP", "suitcase"): dict(rotation_xyz_deg=(90.0, 0.0, 0.0), recenter="bottom"),
}


def canonicalize_asset(mesh: Mesh, rotation_xyz_deg: Tuple[float, float, float],
                       recenter: str = "bottom") -> Mesh:
    """Rotate by XYZ euler degrees and recentre (xy-center, z-bottom at 0)."""
    R = euler_xyz_to_matrix(*np.deg2rad(rotation_xyz_deg))
    verts = mesh.vertices @ R.T
    if recenter == "bottom":
        center = verts.mean(axis=0)
        verts = verts - np.array([center[0], center[1], verts[:, 2].min()])
    elif recenter == "center":
        verts = verts - verts.mean(axis=0)
    return Mesh(vertices=verts, faces=mesh.faces.copy())
