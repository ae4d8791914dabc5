"""Surface sampling and mesh downsampling (numpy + scipy).

A copy of ``coma_tpu/geometry/sampling.py``, seeded the same way, so the
same mesh and seed give the same points and indices. Reference parity:
Open3D's ``sample_points_poisson_disk`` (used by
``utils/coma.py:simplify_mesh_and_get_indices:29-98``), re-implemented from
Yuksel's weighted sample elimination ("Sample Elimination for Generating
Poisson Disk Sample Sets", 2015). Offline data prep that runs once per
asset, on the host.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from coma_tpu_torch import native
from coma_tpu_torch.geometry.mesh import Mesh, face_areas, normalize_rows


def sample_surface_uniform(
    mesh: Mesh, n: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface samples with interpolated normals.

    Returns ``(points (n,3), normals (n,3))``. Normals are barycentric
    interpolations of vertex normals (Open3D's behaviour), so samples on
    faces whose vertices all have zero normals get zero normals.
    """
    areas = face_areas(mesh.vertices, mesh.faces)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    probs = areas / total
    face_idx = rng.choice(len(areas), size=n, p=probs)
    # uniform barycentric coordinates
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    tri = mesh.faces[face_idx]
    pts = (
        w0[:, None] * mesh.vertices[tri[:, 0]]
        + w1[:, None] * mesh.vertices[tri[:, 1]]
        + w2[:, None] * mesh.vertices[tri[:, 2]]
    )
    vn = mesh.vertex_normals
    nrm = w0[:, None] * vn[tri[:, 0]] + w1[:, None] * vn[tri[:, 1]] + w2[:, None] * vn[tri[:, 2]]
    nonzero = np.linalg.norm(nrm, axis=-1, keepdims=True) > 0
    nrm = np.where(nonzero, normalize_rows(nrm), 0.0)
    return pts, nrm


def poisson_disk_eliminate(
    points: np.ndarray, n_target: int, total_area: float
) -> np.ndarray:
    """Yuksel weighted sample elimination: keep ``n_target`` well-spread points
    (the pure-Python fallback of :func:`coma_tpu_torch.native.poisson_eliminate`).

    Returns the indices of the surviving points, sorted. Weight
    w_ij = (1 - d_ij / (2 r_max))^8 with r_max = sqrt(A / (2 sqrt(3) N)).
    """
    m = len(points)
    assert n_target <= m
    r_max = np.sqrt(total_area / (2.0 * np.sqrt(3.0) * n_target))
    radius = 2.0 * r_max
    tree = cKDTree(points)
    neighbors = tree.query_ball_point(points, r=radius)

    def w(d):
        return (1.0 - d / radius) ** 8

    weights = np.zeros(m)
    for i, nbrs in enumerate(neighbors):
        for j in nbrs:
            if j != i:
                weights[i] += w(np.linalg.norm(points[i] - points[j]))

    alive = np.ones(m, dtype=bool)
    heap = [(-weights[i], i) for i in range(m)]
    heapq.heapify(heap)
    n_alive = m
    stale = weights.copy()
    while n_alive > n_target:
        negw, i = heapq.heappop(heap)
        if not alive[i] or -negw != stale[i]:
            if alive[i] and -negw != stale[i]:
                heapq.heappush(heap, (-stale[i], i))
            continue
        alive[i] = False
        n_alive -= 1
        for j in neighbors[i]:
            if j != i and alive[j]:
                stale[j] -= w(np.linalg.norm(points[i] - points[j]))
                heapq.heappush(heap, (-stale[j], j))
    return np.flatnonzero(alive)


def sample_points_poisson_disk(
    mesh: Mesh, number_of_points: int, init_factor: int = 5, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson-disk surface samples (points, normals).

    Open3D's pipeline: uniformly over-sample ``init_factor × N`` points, then
    eliminate down to N, through the native library where it builds
    (:func:`coma_tpu_torch.native.available`), else in Python.
    """
    rng = np.random.default_rng(seed)
    pts, nrm = sample_surface_uniform(mesh, init_factor * number_of_points, rng)
    total_area = float(face_areas(mesh.vertices, mesh.faces).sum())
    if native.available():
        keep = native.poisson_eliminate(pts, number_of_points, total_area)
    else:
        keep = poisson_disk_eliminate(pts, number_of_points, total_area)
    return pts[keep], nrm[keep]


def sample_points_uniform(
    mesh: Mesh, number_of_points: int, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return sample_surface_uniform(mesh, number_of_points, rng)


def nearest_vertex_indices(points: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Index of the nearest mesh vertex per sampled point (N,) — the
    'distance-based' branch of ``simplify_mesh_and_get_indices``
    (``utils/coma.py:87-91``), by KD-tree."""
    tree = cKDTree(vertices)
    _, idx = tree.query(points)
    return idx.astype(np.int64)


def simplify_mesh_and_get_indices(
    mesh: Mesh,
    number_of_points: int,
    simplify_method: str = "poisson_disk",
    seed: int = 42,
) -> Tuple[list, np.ndarray, np.ndarray]:
    """Downsample a mesh to a point cloud + nearest-vertex index list.

    Returns ``(selected_vertex_indices, pcd_points, pcd_normals)`` with the
    reference's semantics (``utils/coma.py:29-98``): indices may repeat.
    """
    if simplify_method == "poisson_disk":
        pts, nrm = sample_points_poisson_disk(mesh, number_of_points, seed=seed)
    elif simplify_method == "uniform":
        pts, nrm = sample_points_uniform(mesh, number_of_points, seed=seed)
    else:
        raise NotImplementedError(simplify_method)
    indices = nearest_vertex_indices(pts, mesh.vertices)
    return list(indices), pts, nrm
