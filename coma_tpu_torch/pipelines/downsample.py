"""Human/object downsampling stages (numpy, on the host).

A copy of ``coma_tpu/pipelines/downsample.py``: the same pickle schema, keys
and dtypes. Reference parity: ``src/coma/downsample_objects.py:run_downsampling:17-62``
and ``src/coma/downsample_human.py:downsample_smplx:17-86`` — poisson-disk
downsample meshes into point clouds, record nearest-mesh-vertex indices,
drop zero-normal points/indices, pickle in the shipped metadata schema.
"""
from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, Optional

import numpy as np

from coma_tpu_torch.geometry.mesh import Mesh, compute_vertex_normals, load_obj, save_obj
from coma_tpu_torch.geometry.sampling import simplify_mesh_and_get_indices


def downsample_object(
    supercategory: str,
    category: str,
    asset_id: str,
    obj_pth: str,
    number_of_points: int,
    simplify_method: str = "poisson_disk",
    seed: int = 42,
) -> Dict[str, Any]:
    """Object downsample metadata (reference schema,
    ``downsample_objects.py:46-60``): raw pcd points/normals with zero-normal
    points dropped, nearest-vertex indices (duplicates kept), plus the full
    original mesh."""
    mesh = load_obj(obj_pth)
    obj_vertices = mesh.vertices
    obj_faces = mesh.faces
    obj_vertex_normals = mesh.vertex_normals

    indices, pcd_points, pcd_normals = simplify_mesh_and_get_indices(
        mesh, number_of_points=number_of_points, simplify_method=simplify_method, seed=seed
    )

    # drop raw pcd points whose interpolated normal is zero
    # (downsample_objects.py:30-44)
    keep = np.flatnonzero(pcd_normals.sum(axis=-1) != 0)
    pcd_points = pcd_points[keep]
    pcd_normals = pcd_normals[keep]

    return {
        "supercategory": supercategory,
        "category": category,
        "asset_id": asset_id,
        "V": obj_vertices.shape[0],
        "F": obj_faces.shape[0],
        "N": len(indices),
        "N_raw": len(pcd_points),
        "downsample_indices": indices,
        "downsampled_pcd_points_raw": pcd_points,
        "downsampled_pcd_normal_raw": pcd_normals,
        "obj_vertices_original": obj_vertices,
        "obj_faces_original": obj_faces,
        "obj_vertex_normals_original": obj_vertex_normals,
    }


def save_object_downsample(
    metadata: Dict[str, Any], save_pth: str, obj_pth: str, mesh_copy_pth: str
) -> None:
    os.makedirs(os.path.dirname(save_pth), exist_ok=True)
    with open(save_pth, "wb") as handle:
        pickle.dump(metadata, handle, protocol=pickle.HIGHEST_PROTOCOL)
    if os.path.abspath(obj_pth) != os.path.abspath(mesh_copy_pth):
        shutil.copy(src=obj_pth, dst=mesh_copy_pth)


def downsample_human_template(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    simplify_method: str = "poisson_disk",
    seed: int = 42,
) -> Dict[str, Any]:
    """Human (SMPL-X star-pose template) downsample metadata.

    Reference: ``downsample_human.py:43-77`` — index-based downsample of the
    canonical star-pose mesh; indices with zero vertex normals are dropped
    (not the pcd points — note the asymmetry vs the object path). Passing
    ``num_points >= V`` yields the 'FULL' identity downsample.
    """
    mesh = Mesh(vertices=np.asarray(vertices, np.float64), faces=np.asarray(faces, np.int64))
    vertex_normals = compute_vertex_normals(mesh.vertices, mesh.faces)
    V = len(vertices)

    if num_points < V:
        indices, pcd_points, pcd_normals = simplify_mesh_and_get_indices(
            mesh, number_of_points=num_points, simplify_method=simplify_method, seed=seed
        )
    else:
        pcd_points = mesh.vertices.copy()
        pcd_normals = vertex_normals.copy()
        indices = sorted(range(V))

    # drop indices whose original vertex normal is zero (downsample_human.py:57-65)
    indices = [i for i in indices if vertex_normals[i].sum() != 0]

    return {
        "vertices": np.asarray(vertices),
        "faces": np.asarray(faces),
        "V": V,
        "F": len(faces),
        "N": len(indices),
        "N_raw": len(pcd_points),
        "downsample_indices": indices,
        "downsampled_pcd_points_raw": pcd_points,
        "downsampled_pcd_normal_raw": pcd_normals,
    }


def save_human_downsample(
    metadata: Dict[str, Any],
    num_points: int,
    constants_mesh_dir: str = "./constants/mesh",
    full_threshold: Optional[int] = None,
) -> str:
    V = metadata["V"]
    full = num_points >= (full_threshold if full_threshold is not None else V)
    tag = "FULL" if full else str(num_points)
    save_pth = f"{constants_mesh_dir}/smplx_star_downsampled_{tag}.pickle"
    os.makedirs(constants_mesh_dir, exist_ok=True)
    with open(save_pth, "wb") as handle:
        pickle.dump(metadata, handle, protocol=pickle.HIGHEST_PROTOCOL)
    return save_pth


def save_star_template(
    vertices: np.ndarray, faces: np.ndarray, constants_mesh_dir: str = "./constants/mesh"
) -> None:
    """Write the canonical star-pose template obj + pickle
    (reference: ``downsample_human.py:35-41``)."""
    os.makedirs(constants_mesh_dir, exist_ok=True)
    save_obj(f"{constants_mesh_dir}/smplx_star.obj", vertices, faces)
    with open(f"{constants_mesh_dir}/smplx_star.pickle", "wb") as handle:
        pickle.dump(
            {"vertices": np.asarray(vertices), "faces": np.asarray(faces)},
            handle,
            protocol=pickle.HIGHEST_PROTOCOL,
        )
