"""Per-sample input preparation for affordance extraction (numpy).

Counterpart of ``coma_tpu/pipelines/affordance_inputs.py``.

Reference parity: ``utils/coma.py:prepare_affordance_extraction_inputs:649-791``
— load the optimized human mesh, recompute its vertex normals, apply the
index-based downsampling (or the raw poisson-disk point cloud for objects),
and optionally reject samples by the regressed human's pixel-to-world scale.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from coma_tpu_torch.affordance.io import load_pickle
from coma_tpu_torch.geometry.mesh import compute_vertex_normals, normalize_rows


def prepare_affordance_extraction_inputs(
    human_mesh_pth: str,
    human_downsample_metadata: Dict[str, Any],
    object_downsample_metadata: Dict[str, Any],
    human_use_downsample_pcd_raw: bool,
    object_use_downsample_pcd_raw: bool,
    eps: float,
    standardize_human_scale: bool = False,
    scaler_range=None,
    camera_pth: Optional[str] = None,
    human_params_pth: Optional[str] = None,
    object_mesh_for_check_pth: Optional[str] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Returns the (downsampled) human/object verts+normals for one sample,
    or None if the sample is rejected by the scale filter.

    ``object_mesh_for_check_pth``: redundant-load cross-check — re-load the
    object OBJ and assert verts/faces match the downsample pickle
    (reference: ``utils/coma.py:694-699``)."""
    if object_mesh_for_check_pth is not None:
        from coma_tpu_torch.geometry.mesh import load_obj

        check = load_obj(object_mesh_for_check_pth)
        np.testing.assert_allclose(
            np.asarray(check.vertices, np.float64),
            np.asarray(object_downsample_metadata["obj_vertices_original"], np.float64),
            atol=1e-6,
            err_msg="object OBJ does not match the downsample pickle",
        )
        assert np.array_equal(
            np.asarray(check.faces),
            np.asarray(object_downsample_metadata["obj_faces_original"]),
        ), "object faces do not match the downsample pickle"
    human_data = load_pickle(human_mesh_pth)
    human_verts_orig = np.asarray(human_data["verts"], dtype=np.float64)
    human_faces_orig = np.asarray(human_data["faces"], dtype=np.int64)
    human_vertex_normals_orig = normalize_rows(
        compute_vertex_normals(human_verts_orig, human_faces_orig), eps
    )

    obj_verts_orig = np.asarray(object_downsample_metadata["obj_vertices_original"])
    obj_vertex_normals_orig = normalize_rows(
        np.asarray(object_downsample_metadata["obj_vertex_normals_original"])
    )

    # human: always index-downsampled mesh vertices (the reference asserts
    # against the raw-pcd path for humans, utils/coma.py:706-707)
    assert not human_use_downsample_pcd_raw, "human must use mesh representation"
    h_idx = np.asarray(human_downsample_metadata["downsample_indices"], dtype=np.int64)
    human_verts = human_verts_orig[h_idx]
    human_vertex_normals = human_vertex_normals_orig[h_idx]
    assert len(human_verts) == human_downsample_metadata["N"]

    if object_use_downsample_pcd_raw:
        obj_verts = np.asarray(object_downsample_metadata["downsampled_pcd_points_raw"])
        obj_vertex_normals = np.asarray(
            object_downsample_metadata["downsampled_pcd_normal_raw"]
        )
        assert len(obj_verts) == object_downsample_metadata["N_raw"]
    else:
        o_idx = np.asarray(
            object_downsample_metadata["downsample_indices"], dtype=np.int64
        )
        obj_verts = obj_verts_orig[o_idx]
        obj_vertex_normals = obj_vertex_normals_orig[o_idx]
        assert len(obj_verts) == object_downsample_metadata["N"]

    if standardize_human_scale:
        # scale filter: reject samples whose regressed human's pixel->world
        # scale is out of range (reference: utils/coma.py:757-773; the
        # rescaling itself is a no-op there too — filter only).
        camera = load_pickle(camera_pth)
        human_params = load_pickle(human_params_pth)
        scaler = (512.0 / camera["scale"]) * (
            human_params["convert_data"]["z_mean"]
            / human_params["convert_data"]["focals"][0]
        )
        if scaler_range is not None:
            lo, hi = scaler_range
            if scaler < lo or scaler > hi:
                return None

    return dict(
        human_verts=human_verts.astype(np.float32),
        human_normals=human_vertex_normals.astype(np.float32),
        obj_verts=obj_verts.astype(np.float32),
        obj_normals=obj_vertex_normals.astype(np.float32),
    )
