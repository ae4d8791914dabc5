"""Mesh IO and normals (numpy, Open3D semantics).

A copy of ``coma_tpu/geometry/mesh.py``:

- :func:`load_obj` keeps vertex and face order exactly as in the file (the
  index-based downsampling depends on it; reference
  ``utils/load_3d.py:load_obj_as_o3d_preserving_face_order``).
- :func:`load_obj_textured` adds UVs, per-face materials and one texture
  layer per material for the textured renderer; ``map_Kd`` PNGs are read
  with :mod:`coma_tpu_torch.utils.png` and resized as PIL's bilinear resize
  does (the card has no PIL). A texture the PNG reader cannot decode (a
  JPEG, say) keeps the material's Kd layer with a printed warning, where
  ``coma_tpu`` decodes it through PIL.
- vertex normal = normalized sum of the incident *unnormalized* face cross
  products (area-weighted); isolated vertices keep a zero normal (Open3D's
  ``TriangleMesh.compute_vertex_normals``).
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional

import numpy as np

from coma_tpu_torch.utils.png import read_png, to_rgb
from coma_tpu_torch.utils.resize import resize_bilinear


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


@dataclasses.dataclass
class TexturedMesh:
    """Mesh + UVs + per-face material for textured rendering (the data the
    reference's ``bpy.ops.import_scene.obj`` carries into Cycles,
    ``render_objects.py:90``). ``textures`` (M, S, S, 3) float32 in [0, 1],
    one layer per material (plain-Kd materials become constant layers)."""

    vertices: np.ndarray       # (V, 3) float64
    faces: np.ndarray          # (F, 3) int64
    uvs: np.ndarray            # (VT, 2) float32 (empty if the obj has none)
    face_uvs: np.ndarray       # (F, 3) int64 into uvs (-1 where absent)
    face_material: np.ndarray  # (F,) int32 into textures
    textures: np.ndarray       # (M, S, S, 3) float32

    @property
    def mesh(self) -> Mesh:
        return Mesh(self.vertices, self.faces)


def _grey_layer(tex_size: int) -> np.ndarray:
    return np.full((tex_size, tex_size, 3), 0.8, np.float32)


def _parse_mtl(path: str, tex_size: int) -> dict:
    """Parse a .mtl file -> {name: (S, S, 3) float32 texture layer}."""
    materials = {}
    cur = None
    base = os.path.dirname(path)
    try:
        fh = open(path, "r", errors="ignore")
    except OSError:
        return materials
    with fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "newmtl":
                cur = tok[1] if len(tok) > 1 else ""
                materials[cur] = _grey_layer(tex_size)
            elif tok[0] == "Kd" and cur is not None and len(tok) >= 4:
                kd = np.array([float(tok[1]), float(tok[2]), float(tok[3])], np.float32)
                materials[cur] = np.broadcast_to(kd, (tex_size, tex_size, 3)).astype(np.float32)
            elif tok[0] == "map_Kd" and cur is not None:
                tex_pth = os.path.join(base, line.split(None, 1)[1].strip())
                try:
                    image = to_rgb(read_png(tex_pth))
                except OSError:
                    continue                      # missing: keep Kd, as coma_tpu does
                except (ValueError, zlib.error) as err:
                    print(f"[mesh] WARNING: texture {tex_pth} not decoded ({err}); "
                          f"material {cur!r} keeps its Kd colour")
                    continue
                resized = resize_bilinear(image, (tex_size, tex_size))
                materials[cur] = resized.astype(np.float32) / 255.0
    return materials


def load_obj_textured(path: str, tex_size: int = 256) -> TexturedMesh:
    """Parse OBJ + MTL with UVs and per-face materials (vertex/face order
    preserved, fan triangulation like :func:`load_obj`, negative indices).
    Missing materials or UVs degrade to a default 0.8-grey layer and a -1
    UV index."""
    verts, uvs, faces, face_uvs, face_mat = [], [], [], [], []
    mtl_layers: dict = {}
    mat_index = {None: 0}
    layers = [_grey_layer(tex_size)]
    cur_mat = 0
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vt "):
                p = line.split()
                uvs.append([float(p[1]), float(p[2]) if len(p) > 2 else 0.0])
            elif line.startswith("mtllib"):
                mtl_pth = os.path.join(os.path.dirname(path), line.split(None, 1)[1].strip())
                mtl_layers.update(_parse_mtl(mtl_pth, tex_size))
            elif line.startswith("usemtl"):
                parts = line.split(None, 1)        # any whitespace (tabs are valid OBJ)
                name = parts[1].strip() if len(parts) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(layers)
                    layers.append(mtl_layers.get(name, _grey_layer(tex_size)))
                cur_mat = mat_index[name]
            elif line.startswith("f "):
                vi, ti = [], []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    i = int(parts[0])
                    vi.append(i - 1 if i > 0 else len(verts) + i)
                    if len(parts) > 1 and parts[1]:
                        t = int(parts[1])
                        ti.append(t - 1 if t > 0 else len(uvs) + t)
                    else:
                        ti.append(-1)
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    face_uvs.append([ti[0], ti[k], ti[k + 1]])
                    face_mat.append(cur_mat)
    return TexturedMesh(
        vertices=np.asarray(verts, np.float64),
        faces=np.asarray(faces, np.int64).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        face_uvs=np.asarray(face_uvs, np.int64).reshape(-1, 3),
        face_material=np.asarray(face_mat, np.int32),
        textures=np.stack(layers, axis=0),
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
