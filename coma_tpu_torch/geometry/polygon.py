"""OpenCV's ``cv2.convexHull`` + ``cv2.fillConvexPoly(mask, hull, 255)`` on
int32 points, batched on the device.

``coma_tpu`` rasterizes each candidate placement mask with those two calls
(``pipelines/rendering.py:candidate_mask_grid``); the card has no OpenCV.
OpenCV's fill is not a point-in-polygon test: with ``LINE_8`` and
``shift = 0`` it

1. draws every hull edge, from the previous vertex to the next, as an
   8-connected Bresenham line (``LineIterator``, left to right, the error
   starting at dx - 2 dy) after clipping it to the image (``clipLine``, in
   double precision, truncated to integers), then
2. fills, for each row from the top vertex's down to the row above the
   bottom vertex's, the span between the two edges' 16.16 fixed-point x
   (each edge stepping by ``trunc((2 (xe - xs) 2^16 + h) / 2h)`` a row,
   both ends rounded half up), clipped to the image. The bottom row holds
   only what the lines drew. Hulls of fewer than three points draw lines
   only.

Both steps are reproduced in integer and double arithmetic, so the masks are
OpenCV's to the pixel. The hull is Andrew's monotone chain: duplicates and
collinear points dropped, positive signed area (counter-clockwise with y up,
OpenCV's default orientation), which fixes each edge's direction and so
its clipping.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_XY_SHIFT = 16
_HALF = 1 << (_XY_SHIFT - 1)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """(n, 2) integer points -> (h, 2) int64 hull vertices in OpenCV's
    orientation (positive signed area); h is 1 or 2 for degenerate input."""
    pts = sorted(set(map(tuple, np.asarray(points, np.int64).tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[Tuple[int, int]] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[Tuple[int, int]] = []
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def pad_hulls(hulls: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Hulls -> (vertices (M, K, 2) int64, the last vertex repeated past
    each count; counts (M,) int64)."""
    K = max([len(h) for h in hulls] + [1])
    verts = np.zeros((len(hulls), K, 2), np.int64)
    counts = np.zeros(len(hulls), np.int64)
    for i, h in enumerate(hulls):
        verts[i, : len(h)] = h
        verts[i, len(h):] = h[-1]
        counts[i] = len(h)
    return verts, counts


def _clip_lines(x1, y1, x2, y2, width: int, height: int):
    """OpenCV's ``clipLine`` on int64 tensors: (visible, x1, y1, x2, y2)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return ((x < 0).long() + (x > right).long() * 2 + (y < 0).long() * 4
                + (y > bottom).long() * 8)

    def step(num, d_num, d_den):
        # (int64)((double)num * d_num / d_den), the denominator kept off 0
        # where the branch is not taken
        den = torch.where(d_den == 0, torch.ones_like(d_den), d_den).double()
        return torch.trunc(num.double() * d_num.double() / den).long()

    c1, c2 = code(x1, y1), code(x2, y2)
    clip = ((c1 & c2) == 0) & ((c1 | c2) != 0)

    take = clip & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, torch.zeros_like(c1), torch.full_like(c1, bottom))
    x1 = torch.where(take, x1 + step(a - y1, x2 - x1, y2 - y1), x1)
    y1 = torch.where(take, a, y1)
    c1 = torch.where(take, (x1 < 0).long() + (x1 > right).long() * 2, c1)
    take = clip & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, torch.zeros_like(c2), torch.full_like(c2, bottom))
    x2 = torch.where(take, x2 + step(a - y2, x2 - x1, y2 - y1), x2)
    y2 = torch.where(take, a, y2)
    c2 = torch.where(take, (x2 < 0).long() + (x2 > right).long() * 2, c2)

    clip = clip & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    take = clip & (c1 != 0)
    a = torch.where(c1 == 1, torch.zeros_like(c1), torch.full_like(c1, right))
    y1 = torch.where(take, y1 + step(a - x1, y2 - y1, x2 - x1), y1)
    x1 = torch.where(take, a, x1)
    c1 = torch.where(take, torch.zeros_like(c1), c1)
    take = clip & (c2 != 0)
    a = torch.where(c2 == 1, torch.zeros_like(c2), torch.full_like(c2, right))
    y2 = torch.where(take, y2 + step(a - x2, y2 - y1, x2 - x1), y2)
    x2 = torch.where(take, a, x2)
    c2 = torch.where(take, torch.zeros_like(c2), c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(x1, y1, x2, y2, width: int, height: int):
    """Flat pixel index and validity (..., L) of OpenCV's 8-connected lines
    from (x1, y1) to (x2, y2), int64 tensors (...)."""
    visible, x1, y1, x2, y2 = _clip_lines(x1, y1, x2, y2, width, height)
    swap = x2 < x1                                   # LineIterator's leftToRight
    x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    y1, y2 = torch.where(swap, y2, y1), torch.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = torch.where(dy < 0, -torch.ones_like(dy), torch.ones_like(dy))
    dy = dy.abs()
    vert = dy > dx
    major = torch.maximum(dx, dy)
    minor = torch.minimum(dx, dy)
    length = int(major.max().item()) + 1 if major.numel() else 1
    k = torch.arange(length, device=x1.device)
    shape = (1,) * x1.dim() + (length,)
    k = k.reshape(shape)
    major_, minor_ = major[..., None], minor[..., None]
    # minor steps after k major ones: ceil((2 minor k - major) / (2 major)),
    # the closed form of the error recurrence
    den = torch.clamp(2 * major_, min=1)
    m = torch.div(2 * minor_ * k - major_ + den - 1, den, rounding_mode="floor").clamp(min=0)
    xs = torch.where(vert[..., None], x1[..., None] + m, x1[..., None] + k)
    ys = torch.where(vert[..., None], y1[..., None] + sy[..., None] * k,
                     y1[..., None] + sy[..., None] * m)
    valid = visible[..., None] & (k <= major_)
    xs = xs.clamp(0, width - 1)
    ys = ys.clamp(0, height - 1)
    return ys * width + xs, valid


def fill_convex_polygons(verts: torch.Tensor, counts: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """(M, H, W) uint8 in {0, 255}: mask i is ``cv2.fillConvexPoly`` of the
    hull ``verts[i, :counts[i]]`` (int64 (M, K, 2), as :func:`pad_hulls`
    gives them) on a zero image."""
    M, K, _ = verts.shape
    dev = verts.device
    out = torch.zeros(M * height * width, dtype=torch.uint8, device=dev)
    if M == 0:
        return out.view(0, height, width)
    x, y = verts[..., 0], verts[..., 1]
    e = torch.arange(K, device=dev)
    edge_ok = e[None, :] < counts[:, None]                           # (M, K)
    prev = torch.remainder(e[None, :] - 1, counts[:, None])          # edge prev -> e
    px = torch.gather(x, 1, prev)
    py = torch.gather(y, 1, prev)

    # 1. the outline
    flat, valid = _line_pixels(px, py, x, y, width, height)          # (M, K, L)
    valid = valid & edge_ok[..., None]
    flat = flat + (torch.arange(M, device=dev) * (height * width))[:, None, None]
    out[flat[valid]] = 255

    # 2. the spans between the two edges that cross each row
    up_is_prev = py < y
    xu, yu = torch.where(up_is_prev, px, x), torch.where(up_is_prev, py, y)
    xl, yl = torch.where(up_is_prev, x, px), torch.where(up_is_prev, y, py)
    h = yl - yu
    sloped = edge_ok & (h > 0)
    h1 = torch.clamp(h, min=1)
    dxe = torch.div((xl - xu) * (2 << _XY_SHIFT) + h1, 2 * h1, rounding_mode="trunc")
    rows = torch.arange(height, device=dev)
    r = rows[None, None, :]                                          # (1, 1, H)
    active = sloped[..., None] & (r >= yu[..., None]) & (r < yl[..., None])
    xfix = xu[..., None] * (1 << _XY_SHIFT) + dxe[..., None] * (r - yu[..., None])
    big = torch.iinfo(torch.int64).max
    left = torch.where(active, xfix, torch.full_like(xfix, big)).amin(dim=1)     # (M, H)
    right = torch.where(active, xfix, torch.full_like(xfix, -big)).amax(dim=1)
    inf_big = torch.full_like(x, big)
    ymin = torch.where(edge_ok, y, inf_big).amin(dim=1)
    ymax = torch.where(edge_ok, y, -inf_big).amax(dim=1)
    xmin = torch.where(edge_ok, x, inf_big).amin(dim=1)
    xmax = torch.where(edge_ok, x, -inf_big).amax(dim=1)
    drawn = (counts >= 3) & (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
    row_ok = drawn[:, None] & (rows[None] >= ymin[:, None]) & (rows[None] < ymax[:, None])
    row_ok = row_ok & (active.sum(dim=1) >= 2)
    x0 = torch.div(left + _HALF, 1 << _XY_SHIFT, rounding_mode="floor")
    x1 = torch.div(right + _HALF, 1 << _XY_SHIFT, rounding_mode="floor")
    cols = torch.arange(width, device=dev)
    span = (row_ok[..., None] & (cols >= x0[..., None]) & (cols <= x1[..., None]))
    out = out.view(M, height, width)
    out[span] = 255
    return out


def fill_convex_hulls(quads: np.ndarray, height: int, width: int, device) -> torch.Tensor:
    """``cv2.fillConvexPoly(zeros, cv2.convexHull(q), 255)`` for each int
    point set q of (M, n, 2) -> (M, H, W) uint8 on ``device``."""
    verts, counts = pad_hulls([convex_hull(q) for q in np.asarray(quads)])
    return fill_convex_polygons(torch.as_tensor(verts, device=device),
                                torch.as_tensor(counts, device=device), height, width)
