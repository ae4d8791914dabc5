"""Mesh IO and normals (numpy, Open3D semantics).

A copy of ``coma_tpu/geometry/mesh.py`` without the textured loader:

- :func:`load_obj` keeps vertex and face order exactly as in the file (the
  index-based downsampling depends on it; reference
  ``utils/load_3d.py:load_obj_as_o3d_preserving_face_order``).
- vertex normal = normalized sum of the incident *unnormalized* face cross
  products (area-weighted); isolated vertices keep a zero normal (Open3D's
  ``TriangleMesh.compute_vertex_normals``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    """A triangle mesh: float64 vertices, int64 faces (file order preserved)."""

    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int64
    _vertex_normals: Optional[np.ndarray] = None

    @property
    def vertex_normals(self) -> np.ndarray:
        if self._vertex_normals is None:
            self._vertex_normals = compute_vertex_normals(self.vertices, self.faces)
        return self._vertex_normals


def load_obj(path: str) -> Mesh:
    """Parse a Wavefront OBJ, preserving vertex/face order.

    Supports ``v``, ``f`` (with ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn`` and
    negative indices); polygons are fan-triangulated in order.
    """
    verts = []
    faces = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(
        vertices=np.asarray(verts, dtype=np.float64),
        faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def face_cross_products(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unnormalized face normals (cross products, |n| = 2·area). (F, 3)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    return np.cross(v1 - v0, v2 - v0)


def face_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    return 0.5 * np.linalg.norm(face_cross_products(vertices, faces), axis=-1)


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, zero for isolated vertices. (V, 3)."""
    fn = face_cross_products(vertices, faces)  # (F, 3) area-weighted
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return np.divide(vn, norm, out=np.zeros_like(vn), where=norm > 0)


def normalize_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norm, eps)
