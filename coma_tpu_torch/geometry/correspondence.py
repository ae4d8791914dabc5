"""Point-cloud keypoint-correspondence utilities (CPNet helper parity).

Counterpart of ``coma_tpu/geometry/correspondence.py``. Reference:
``imports/cpnet/utils.py`` — point-cloud augmentation, kNN graph
laplacians, geodesic distance tables, and the cross-instance keypoint
geodesic-error metric (``geo_error_per_cp``, ``:108-160`` there). The
reference never calls these from a main-path script (SURVEY §2.4 marks the
module vestigial); the surface is kept for CPNet-style keypoint evaluation:

- the dense math (kNN graphs, laplacians, nearest-embedding queries) is
  PyTorch on the tensors' device; the all-pairs embedding query in
  :func:`geo_error_per_cp` is one batched matmul + argmin;
- the sequential graph algorithm (multi-source shortest path for geodesics)
  stays on the host in ``scipy.sparse.csgraph``;
- the random augmentations take an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "point_augment",
    "jitter_point_cloud",
    "rotate_point_cloud",
    "normalize_point_cloud",
    "knn_graph",
    "pc_to_laplacian",
    "normalize_adjacency",
    "normalized_laplacian",
    "geodesic_distances",
    "geo_error_per_cp",
]


# --------------------------------------------------------------------- aug

def point_augment(pcd: np.ndarray, num_point: int = 3000) -> np.ndarray:
    """Pad (by tiling) or trim a cloud to exactly ``num_point`` points.

    Same semantics as the reference ``point_augment``: doubling until one
    partial tile suffices, else truncation.
    """
    if pcd.shape[0] < num_point:
        while num_point - pcd.shape[0] > pcd.shape[0]:
            pcd = np.concatenate([pcd, pcd])
        return np.concatenate([pcd, pcd[: num_point - pcd.shape[0]]])
    return pcd[:num_point]


def jitter_point_cloud(pcd: torch.Tensor, generator: torch.Generator, sigma: float = 0.01,
                       clip: float = 0.05) -> torch.Tensor:
    """Gaussian-jitter every coordinate, clipped to ``±clip``."""
    assert clip > 0
    noise = torch.randn(pcd.shape, generator=generator, dtype=pcd.dtype,
                        device=generator.device).to(pcd.device)
    return pcd + torch.clamp(sigma * noise, -clip, clip)


def rotate_point_cloud(pcd: torch.Tensor, generator: torch.Generator,
                       degree: float = np.pi / 60) -> torch.Tensor:
    """Random small rotation about +Y, angle ~ U[0, degree)."""
    angle = torch.rand((), generator=generator, device=generator.device).to(pcd.device) * degree
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, zero, s]), torch.stack([zero, one, zero]),
                       torch.stack([-s, zero, c])]).to(pcd.dtype)
    return pcd @ rot


def normalize_point_cloud(pts: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Scale each point onto the unit sphere (row-wise L2)."""
    norm = torch.sqrt(torch.sum(pts * pts, dim=-1, keepdim=True))
    return pts / torch.clamp(norm, min=eps)


# ------------------------------------------------------------------ graphs

def knn_graph(pcd: torch.Tensor, k: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors (self excluded) of every point.

    Returns ``(dists, idx)`` each ``(N, k)``: one (N, N) distance matrix and
    a stable ascending sort, so equal distances go to the lower index, as
    ``jax.lax.top_k`` orders them in ``coma_tpu``.
    """
    sq = torch.sum(pcd * pcd, dim=-1)
    d2 = sq[:, None] - 2.0 * (pcd @ pcd.T) + sq[None, :]
    eye = torch.eye(d2.shape[0], dtype=torch.bool, device=d2.device)
    d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return torch.sqrt(torch.clamp(vals[:, :k], min=0.0)), idx[:, :k]


def normalize_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """Symmetric normalization D^-1/2 A D^-1/2 (reference ``normalize_adj``)."""
    rowsum = torch.sum(adj, dim=1)
    d_inv_sqrt = torch.where(rowsum > 0, rowsum ** -0.5, torch.zeros_like(rowsum))
    return adj * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


def normalized_laplacian(adj: torch.Tensor) -> torch.Tensor:
    """I - D^-1/2 A D^-1/2 (reference ``normalized_laplacian``)."""
    return torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device) - normalize_adjacency(adj)


def pc_to_laplacian(pcd: torch.Tensor, knn: int = 20) -> torch.Tensor:
    """Normalized laplacian of the gaussian-weighted kNN graph.

    Reference ``pc2lap``: edge weight ``exp(-d² / s_i²)`` where ``s_i`` is
    the mean kNN distance of row i, on the DIRECTED kNN graph (row i holds
    i's neighbors only — ``kneighbors_graph`` is asymmetric and the
    reference keeps it so). The (N, k) edge list is scattered into the
    dense (N, N) adjacency.
    """
    n = pcd.shape[0]
    dists, idx = knn_graph(pcd, knn)
    scale = torch.mean(dists, dim=1, keepdim=True)          # (N, 1)
    w = torch.exp(-(dists ** 2) / torch.clamp(scale, min=1e-20) ** 2)
    adj = torch.zeros((n, n), dtype=w.dtype, device=w.device).scatter_add_(1, idx, w)
    return normalized_laplacian(adj)


def geodesic_distances(pcd: np.ndarray, knn: int = 20) -> np.ndarray:
    """All-pairs geodesic distances over the kNN graph (host side).

    Reference ``gen_geo_dists``: shortest paths on the undirected kNN
    distance graph (``scipy.sparse.csgraph``; the reference used sklearn's
    now-removed ``graph_shortest_path`` wrapper around the same routine).
    The kNN graph is built in float32 on the CPU.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    n = pcd.shape[0]
    dists, idx = knn_graph(torch.as_tensor(np.asarray(pcd, np.float32)), knn)
    rows = np.repeat(np.arange(n), knn)
    graph = sp.csr_matrix((dists.numpy().ravel(), (rows, idx.numpy().ravel())), shape=(n, n))
    return shortest_path(graph, directed=False)


# ------------------------------------------------------------------ metric

def _nearest_by_embedding(embeddings: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """idx[j, i] = argmin_p ||embeddings[j, p] - queries[i]|| for ALL pairs:
    (D, P, F) x (D, F) -> (D, P, D) scores, then the first minimum over P —
    the reference's D² per-cloud KDTree queries
    (``imports/cpnet/utils.py:119-133``) as one batched product."""
    sq = torch.sum(embeddings * embeddings, dim=-1)                   # (D, P)
    dots = torch.einsum("jpf,if->jpi", embeddings, queries)           # (D, P, D)
    return torch.argmin(sq[:, :, None] - 2.0 * dots, dim=1)           # (D, D)


def _queries(embeddings, kp):
    return torch.gather(embeddings, 1, kp[:, None, None].expand(-1, 1, embeddings.shape[-1]))[:, 0]


def _geo_error_l2(pcds, embeddings, kp):
    d = pcds.shape[0]
    idx = _nearest_by_embedding(embeddings, _queries(embeddings, kp))      # (D, D) [j, i]
    p_nearest = torch.gather(pcds, 1, idx[..., None].expand(-1, -1, 3))    # (D, D, 3)
    p_gt = torch.gather(pcds, 1, kp[:, None, None].expand(-1, 1, 3))       # (D, 1, 3)
    err = torch.linalg.norm(p_nearest - p_gt, dim=-1)                      # (D, D) [j, i]
    off = 1.0 - torch.eye(d, dtype=err.dtype, device=err.device)
    return torch.sum(err * off), torch.sum(off)


def _geo_error_geodesic(pcds, embeddings, kp, dist_mats):
    d = pcds.shape[0]
    idx = _nearest_by_embedding(embeddings, _queries(embeddings, kp))      # (D, D) [j, i]
    row = torch.gather(dist_mats, 1, idx[..., None].expand(-1, -1, dist_mats.shape[-1]))
    err = torch.gather(row, 2, kp[:, None, None].expand(-1, d, 1))[..., 0]  # (D, D)
    off = 1.0 - torch.eye(d, dtype=err.dtype, device=err.device)
    return torch.sum(err * off), torch.sum(off)


def geo_error_per_cp(
    pcds: np.ndarray,
    embeddings: np.ndarray,
    kp_indices: np.ndarray,
    dist_mats: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[float, bool]:
    """Mean cross-instance keypoint error of one correspondence point.

    For every ordered pair of annotated clouds (i, j), i != j: look up
    cloud i's keypoint embedding in cloud j's embeddings (nearest neighbor
    in feature space) and measure the L2 (or geodesic, when ``dist_mats``
    is given) distance between the retrieved point and cloud j's annotated
    keypoint. Returns ``(mean_error, valid)``; ``valid`` is False when
    fewer than two clouds carry the keypoint (reference returns 0 there).
    Computed in float32 on ``device``.

    Reference ``geo_error_per_cp`` (``imports/cpnet/utils.py:108-160``).
    """
    from coma_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    kp_indices = np.asarray(kp_indices)
    valid_inds = np.nonzero(kp_indices >= 0)[0]
    if valid_inds.size < 2:
        return 0.0, False

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)[valid_inds], device=dev).to(dtype)

    pcds, embeddings = on_dev(pcds), on_dev(embeddings)
    kp = on_dev(kp_indices, torch.int64)
    if dist_mats is None:
        total, cnt = _geo_error_l2(pcds, embeddings, kp)
    else:
        total, cnt = _geo_error_geodesic(pcds, embeddings, kp, on_dev(dist_mats))
    return float(total) / float(cnt), True
