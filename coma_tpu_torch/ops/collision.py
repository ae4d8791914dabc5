"""Triangle-collision counting, the torch-mesh-isect BVH's count (PyTorch).

Counterpart of ``coma_tpu/ops/collision.py`` (reference:
``src/generation/initialize_depth.py`` ``compute_collision:74-89`` and the
``filter_out`` candidate pre-filter of ``extract_candidates:96-125``; only
``initialize_depth --filter_out`` reaches it). The all-pairs test runs over
tiles of (block_a, block_b) triangles: an AABB-overlap gate masks a
Möller–Trumbore battery of the six edges of the pair (two non-coplanar
triangles intersect iff an edge of one pierces the other). Coplanar pairs
count as not intersecting (the parallel guard rejects them), as in
``coma_tpu``. Plain PyTorch, no kernel of its own.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-9


def pack_triangles(verts, faces) -> torch.Tensor:
    """(V, 3) + (F, 3) int -> (F, 3, 3) float32 triangle corners."""
    verts = torch.as_tensor(verts, dtype=torch.float32)
    return verts[torch.as_tensor(faces, device=verts.device).long()]


def _edge_hits_tri(p, d, v0, e1, e2) -> torch.Tensor:
    """Möller–Trumbore segment test broadcast over a pair tile: True iff the
    segment p + s·d, s in [0, 1], crosses the triangle (v0, e1, e2)'s
    interior."""
    h = torch.linalg.cross(d, e2, dim=-1)
    a = torch.sum(e1 * h, dim=-1)
    near_parallel = torch.abs(a) < _EPS
    inv = torch.where(near_parallel, torch.ones_like(a), a)
    f = torch.where(near_parallel, torch.zeros_like(a), 1.0 / inv)
    s = p - v0
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * torch.sum(d * q, dim=-1)
    t = f * torch.sum(e2 * q, dim=-1)
    return ~near_parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) & (t <= 1.0)


def _tile_intersects(tri_a: torch.Tensor, tri_b: torch.Tensor) -> torch.Tensor:
    """(Ba, 3, 3) x (Bb, 3, 3) -> (Ba, Bb) bool pairwise intersection."""
    amin = tri_a.amin(dim=1)[:, None]
    amax = tri_a.amax(dim=1)[:, None]
    bmin = tri_b.amin(dim=1)[None]
    bmax = tri_b.amax(dim=1)[None]
    aabb = torch.all((amin <= bmax) & (bmin <= amax), dim=-1)

    v0b = tri_b[:, 0][None]
    e1b = (tri_b[:, 1] - tri_b[:, 0])[None]
    e2b = (tri_b[:, 2] - tri_b[:, 0])[None]
    v0a = tri_a[:, 0][:, None]
    e1a = (tri_a[:, 1] - tri_a[:, 0])[:, None]
    e2a = (tri_a[:, 2] - tri_a[:, 0])[:, None]

    hit = torch.zeros(aabb.shape, dtype=torch.bool, device=tri_a.device)
    for k in range(3):                          # edges of A against triangle B
        p = tri_a[:, k][:, None]
        d = tri_a[:, (k + 1) % 3][:, None] - p
        hit |= _edge_hits_tri(p, d, v0b, e1b, e2b)
    for k in range(3):                          # edges of B against triangle A
        p = tri_b[:, k][None]
        d = (tri_b[:, (k + 1) % 3] - tri_b[:, k])[None]
        hit |= _edge_hits_tri(p, d, v0a, e1a, e2a)
    return hit & aabb


def _count_pairs(tri_a, face_ids_a, tri_b, face_ids_b, self_mode: bool = False,
                 block_a: int = 128, block_b: int = 1024) -> int:
    """Intersecting pairs over tiles. In ``self_mode`` the unordered pairs
    (i < j) that share no vertex (torch-mesh-isect's adjacency exclusion)."""
    total = torch.zeros((), dtype=torch.int64, device=tri_a.device)
    for sa in range(0, tri_a.shape[0], block_a):
        ta = tri_a[sa: sa + block_a]
        for sb in range(0, tri_b.shape[0], block_b):
            tb = tri_b[sb: sb + block_b]
            hit = _tile_intersects(ta, tb)
            if self_mode:
                ia = torch.arange(sa, sa + ta.shape[0], device=ta.device)
                ib = torch.arange(sb, sb + tb.shape[0], device=ta.device)
                fa, fb = face_ids_a[sa: sa + block_a], face_ids_b[sb: sb + block_b]
                shared = torch.any(fa[:, None, :, None] == fb[None, :, None, :], dim=(-1, -2))
                hit = hit & (ia[:, None] < ib[None]) & ~shared
            total += hit.sum()
    return int(total)


def count_self_collisions(verts, faces, max_collisions: int = 1000, block_a: int = 128,
                          block_b: int = 1024) -> int:
    """Intersecting triangle pairs within one mesh, pairs sharing a vertex
    excluded, capped at ``max_collisions`` (the BVH's output buffer,
    ``compute_collision:74-89``)."""
    tris = pack_triangles(verts, faces)
    faces = torch.as_tensor(faces, device=tris.device).long()
    n = _count_pairs(tris, faces, tris, faces, self_mode=True, block_a=block_a,
                     block_b=block_b)
    return min(n, max_collisions)


def count_cross_collisions(verts_a, faces_a, verts_b, faces_b, max_collisions: int = 1000,
                           block_a: int = 128, block_b: int = 1024) -> int:
    """Intersecting (triangle of A, triangle of B) pairs, capped; the
    reference's fused-mesh difference ``compute_collision(fused) −
    compute_collision(A) − compute_collision(B)``."""
    n = _count_pairs(pack_triangles(verts_a, faces_a), None, pack_triangles(verts_b, faces_b),
                     None, block_a=block_a, block_b=block_b)
    return min(n, max_collisions)


def collision_curve(human_verts, human_faces, asset_verts, asset_faces, displacements,
                    direction, block_a: int = 128, block_b: int = 1024) -> np.ndarray:
    """(D,) int64 cross-mesh count per depth candidate, the human moved
    rigidly along ``direction``; not capped (the local-minimum filter wants
    the raw curve)."""
    direction = torch.as_tensor(direction, dtype=torch.float32)
    direction = direction / torch.linalg.norm(direction)
    tris_h = pack_triangles(human_verts, human_faces)
    tris_a = pack_triangles(asset_verts, asset_faces).to(tris_h.device)
    direction = direction.to(tris_h.device)
    disps = torch.as_tensor(displacements, dtype=torch.float32).reshape(-1)
    return np.asarray([_count_pairs(tris_h + float(d) * direction, None, tris_a, None,
                                    block_a=block_a, block_b=block_b)
                       for d in disps.tolist()], np.int64)


def filter_candidate_indices(collisions, kernel_size: int) -> np.ndarray:
    """Local-minimum displacement filter -> kept centre indices, the window
    of ``extract_candidates:118-125``: centre c in [k/2, D−k/2) is skipped
    when both immediate neighbours are zero, else kept when collisions[c] <=
    min(collisions[c−k/2 : c−1] + collisions[c+1 : c+k/2]) (the immediate
    left neighbour excluded, the right included, as the reference). The
    centre index itself is returned, not the reference's off-by-k/2
    candidate (dead code upstream, as in ``coma_tpu``)."""
    collisions = np.asarray(collisions, np.float64)
    half = kernel_size // 2
    kept = []
    for c in range(half, len(collisions) - half):
        if collisions[c - 1] == 0.0 and collisions[c + 1] == 0.0:
            continue
        surrounding = np.concatenate([collisions[c - half:c - 1], collisions[c + 1:c + half]])
        if surrounding.size and collisions[c] <= surrounding.min():
            kept.append(c)
    return np.asarray(kept, np.int64)
