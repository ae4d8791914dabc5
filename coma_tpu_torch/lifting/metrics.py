"""Sample-quality metrics: the intersection-volume ratio (the silhouette IoU
is ``lifting/rasterizer.silhouette_iou``).

Counterpart of ``coma_tpu/lifting/metrics.py`` (reference:
``src/generation/compute_metrics.py:compute_metrics:85-112``, where the
boolean volume is a Blender shell-out): a regular grid over the human's
box, point-in-mesh by the parity of +z ray crossings, ratio = #(inside A
and inside B) / #(inside A); at the threshold-aware setting a ratio within
the gray zone of the post-filter's 0.05 is re-evaluated at twice the
resolution.

The crossing counts are integers, so they are summed over chunks: at 128³
points one (points x 256 faces) float32 temporary would be 2.1 GB, and the
test holds about ten of them. On the grid a ray's hit height depends only on
its column (x_i, y_j), so :func:`intersection_volume_ratio` tests each
triangle against the columns of its own box (a ``window`` x ``window`` patch;
the rest against every column) and counts the grid points below each hit
with a sorted search; the tests are ``coma_tpu``'s expressions on the same
operands, so the counts are the dense ones exactly.
"""
from __future__ import annotations

import torch

FACE_CHUNK = 256
POINT_CHUNK = 65536
WINDOW = 16
# the query's xy nudge: rays through shared edges (the diagonal of a quad) count once
NUDGE = (7.3e-6, 3.1e-6, 0.0)


def _hit(v0, v1, v2, qx, qy):
    """Whether the +z ray from (qx, qy) meets triangle (v0, v1, v2), and the
    height z_hit where it does; ``coma_tpu``'s 2D barycentric expressions in
    its order, broadcast over the operands' shapes."""
    e0x, e0y = v1[..., 0] - v0[..., 0], v1[..., 1] - v0[..., 1]
    e1x, e1y = v2[..., 0] - v0[..., 0], v2[..., 1] - v0[..., 1]
    px, py = qx - v0[..., 0], qy - v0[..., 1]
    denom = e0x * e1y - e0y * e1x
    safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom), denom)
    u = (px * e1y - py * e1x) / safe
    v = (e0x * py - e0y * px) / safe
    inside = (u >= 0) & (v >= 0) & (u + v <= 1) & (torch.abs(denom) > 1e-12)
    z_hit = v0[..., 2] + u * (v1[..., 2] - v0[..., 2]) + v * (v2[..., 2] - v0[..., 2])
    return inside, z_hit


def _crossings(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
               chunk: int = FACE_CHUNK, point_chunk: int = POINT_CHUNK) -> torch.Tensor:
    """(P,) int32 count of +z ray crossings per point (P, 3)."""
    tri = verts[faces.long()]                                    # (F, 3, 3)
    count = torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    for ps in range(0, points.shape[0], point_chunk):
        pts = points[ps: ps + point_chunk]
        for fs in range(0, tri.shape[0], chunk):
            t = tri[None, fs: fs + chunk]                        # (1, C, 3, 3)
            inside, z_hit = _hit(t[..., 0, :], t[..., 1, :], t[..., 2, :], pts[:, 0:1],
                                 pts[:, 1:2])
            crossing = inside & (z_hit > pts[:, 2:3])
            count[ps: ps + point_chunk] += crossing.sum(dim=1, dtype=torch.int32)
    return count


def _grid_crossings(axes, verts: torch.Tensor, faces: torch.Tensor, window: int = WINDOW,
                    chunk: int = FACE_CHUNK) -> torch.Tensor:
    """(n³,) int32 crossings of the grid points (x_i, y_j, z_k), nudged as
    :func:`points_inside_mesh` nudges them, in ``meshgrid(indexing="ij")``
    order; equal to :func:`_crossings` on those points."""
    ax, ay, az = axes
    n = ax.shape[0]
    nudge = torch.tensor(NUDGE, dtype=ax.dtype, device=ax.device)
    qx, qy, qz = ax + nudge[0], ay + nudge[1], az + nudge[2]
    tri = verts[faces.long()]                                    # (F, 3, 3)
    # per column, +1 at k = 0 and -1 at the first grid point at or above each
    # hit; the running sum over k counts the hits above every point
    diff = torch.zeros(n * n * (n + 1), dtype=torch.int32, device=ax.device)

    def add(inside, z_hit, col):
        above = torch.searchsorted(qz, z_hit.contiguous())
        one = inside.to(torch.int32)
        base = col * (n + 1)
        diff.index_add_(0, base.reshape(-1), one.reshape(-1))
        diff.index_add_(0, (base + above).reshape(-1), -one.reshape(-1))

    # each triangle's column range, widened by one on each side
    step = (ax[-1] - ax[0]) / max(n - 1, 1), (ay[-1] - ay[0]) / max(n - 1, 1)
    lo = [(tri[:, :, k].amin(dim=1) - (ax, ay)[k][0]) / step[k] for k in range(2)]
    hi = [(tri[:, :, k].amax(dim=1) - (ax, ay)[k][0]) / step[k] for k in range(2)]
    first = [torch.floor(v) - 1 for v in lo]
    last = [torch.ceil(v) + 1 for v in hi]
    finite = torch.stack([torch.isfinite(v) for v in first + last]).all(dim=0)
    fits = finite & (last[0] - first[0] < window) & (last[1] - first[1] < window)

    small = torch.nonzero(fits).flatten()
    if small.numel():
        off = torch.arange(window, device=ax.device)
        i = first[0][small].long()[:, None, None] + off[None, :, None]
        j = first[1][small].long()[:, None, None] + off[None, None, :]
        in_grid = (i >= 0) & (i < n) & (j >= 0) & (j < n)
        i, j = i.clamp(0, n - 1), j.clamp(0, n - 1)
        t = tri[small][:, None, None]                            # (N, 1, 1, 3, 3)
        inside, z_hit = _hit(t[..., 0, :], t[..., 1, :], t[..., 2, :], qx[i], qy[j])
        add(inside & in_grid, z_hit, i * n + j)

    large = torch.nonzero(~fits).flatten()
    if large.numel():
        col = torch.arange(n * n, device=ax.device)
        cx, cy = qx[col // n], qy[col % n]
        for s in range(0, large.numel(), chunk):
            t = tri[large[s: s + chunk]][:, None]                # (C, 1, 3, 3)
            inside, z_hit = _hit(t[..., 0, :], t[..., 1, :], t[..., 2, :], cx[None], cy[None])
            add(inside, z_hit, col[None].expand_as(inside))
    count = torch.cumsum(diff.view(n * n, n + 1), dim=1, dtype=torch.int32)[:, :n]
    return count.reshape(-1)


def points_inside_mesh(points: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor
                       ) -> torch.Tensor:
    """(P,) bool ray-parity inside test (the mesh assumed watertight). The
    query's xy is nudged by a tiny irrational offset so rays through shared
    edges do not count twice."""
    eps = torch.tensor(NUDGE, dtype=points.dtype, device=points.device)
    return _crossings(points + eps, verts, faces) % 2 == 1


def intersection_volume_ratio(verts_a: torch.Tensor, faces_a: torch.Tensor,
                              verts_b: torch.Tensor, faces_b: torch.Tensor,
                              resolution: int = 64) -> torch.Tensor:
    """|V(A ∩ B)| / |V(A)| by parity sampling on a resolution³ grid over A's
    box; a float32 scalar tensor."""
    lo = verts_a.amin(dim=0)
    hi = verts_a.amax(dim=0)
    n = resolution
    grid = torch.arange(n, dtype=verts_a.dtype, device=verts_a.device) + 0.5
    axes = [grid / n * (hi[k] - lo[k]) + lo[k] for k in range(3)]
    in_a = _grid_crossings(axes, verts_a, faces_a) % 2 == 1
    in_b = _grid_crossings(axes, verts_b, faces_b) % 2 == 1
    count_a = in_a.sum()
    count_ab = (in_a & in_b).sum()
    return count_ab.float() / torch.clamp(count_a, min=1).float()


def intersection_volume_ratio_adaptive(verts_a, faces_a, verts_b, faces_b,
                                       threshold: float = 0.05, gray_zone: float = 0.012,
                                       resolution: int = 64, fine_resolution: int = 128):
    """The ratio at ``resolution``; if it falls within ``threshold ±
    gray_zone``, where a sampling error could flip the post-filter's
    decision (``filter.py:76-87``), the ratio at ``fine_resolution``.
    (``coma_tpu``'s tolerance analysis: res-64 error ≤ 0.0053 on closed-form
    oracles, so 0.012 refines every case that could flip.) Returns (the
    ratio as a float, whether the fine grid was taken); ``coma_tpu``'s returns
    the ratio alone."""
    ratio = float(intersection_volume_ratio(verts_a, faces_a, verts_b, faces_b,
                                            resolution=resolution))
    refined = abs(ratio - threshold) <= gray_zone
    if refined:
        ratio = float(intersection_volume_ratio(verts_a, faces_a, verts_b, faces_b,
                                                resolution=fine_resolution))
    return ratio, refined


def mesh_volume(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Exact volume by the divergence theorem (watertight mesh)."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return torch.abs(torch.sum(torch.sum(v0 * torch.linalg.cross(v1, v2, dim=-1), dim=-1))
                     / 6.0)
