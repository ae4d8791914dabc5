"""Batched orthographic silhouette rasterizer (PyTorch).

Counterpart of the silhouette half of ``coma_tpu/lifting/rasterizer.py``
(reference: the Blender segmap renders of
``initialize_depth.py:select_human:134-201`` and
``compute_metrics.py:get_rendered_human_segmap:39``): per-pixel
point-in-triangle coverage with edge functions at pixel centres, and a
z-buffer of barycentric depth, with ``coma_tpu``'s coverage rule
(``flip_y``: camera +y up maps to image rows down) and its degenerate-area
guard.

``coma_tpu`` scans every triangle over every pixel in chunks. Here each
triangle's pixel box decides its route, and both routes evaluate the same
expressions on the same operands, so the result is the dense one exactly:

- a triangle whose box (padded by one pixel) fits a ``window`` x ``window``
  patch is tested only at that patch's pixels, and its coverage or depth is
  scattered into the image with ``amax``/``amin`` (a body at 512² has
  pixel-sized triangles: this is nearly all of them);
- the others are tested against every pixel, ``chunk`` triangles at a time,
  as ``coma_tpu`` does.

Every function takes a leading batch of meshes, so the candidates of depth
initialisation render in one pass. The textured renderer (attributes,
shading, shadows) is not here.
"""
from __future__ import annotations

from typing import Optional

import torch

from coma_tpu_torch.lifting.cameras import OrthoCamera, project_points

WINDOW = 16
CHUNK = 64


def _pixel_centres(height: int, width: int, like: torch.Tensor, flip_y: bool):
    """(px (1, W), py (H, 1)) as ``coma_tpu`` forms them."""
    ys = torch.arange(height, dtype=like.dtype, device=like.device) + 0.5
    if flip_y:
        ys = height - ys
    xs = torch.arange(width, dtype=like.dtype, device=like.device) + 0.5
    return xs[None, :], ys[:, None]


def _patch_route(tri: torch.Tensor, height: int, width: int, window: int, flip_y: bool):
    """Per triangle (N, 3, >=2): (fits a patch (N,) bool, first column (N,),
    first row (N,)). The box is widened by a pixel on each side, so no
    rounding of the edge functions can reach a pixel outside it."""
    x, y = tri[..., 0], tri[..., 1]
    xmin, xmax = x.amin(dim=-1), x.amax(dim=-1)
    ymin, ymax = y.amin(dim=-1), y.amax(dim=-1)
    c0 = torch.floor(xmin - 0.5) - 1
    c1 = torch.ceil(xmax - 0.5) + 1
    if flip_y:
        r0 = torch.floor(height - 0.5 - ymax) - 1
        r1 = torch.ceil(height - 0.5 - ymin) + 1
    else:
        r0 = torch.floor(ymin - 0.5) - 1
        r1 = torch.ceil(ymax - 0.5) + 1
    finite = torch.isfinite(c0) & torch.isfinite(c1) & torch.isfinite(r0) & torch.isfinite(r1)
    fits = finite & (c1 - c0 < window) & (r1 - r0 < window)
    zero = torch.zeros_like(c0)
    c0 = torch.where(finite, c0, zero).clamp(-window - 1, width + 1)
    r0 = torch.where(finite, r0, zero).clamp(-window - 1, height + 1)
    return fits, c0.long(), r0.long()


def _patch_pixels(c0, r0, height: int, width: int, window: int, like, flip_y: bool):
    """The patch's pixel centres px, py (N, S, S), its flat pixel index (N, S,
    S) clamped into the image, and whether each pixel lies in the image."""
    off = torch.arange(window, device=c0.device)
    cols = c0[:, None, None] + off[None, None, :]
    rows = r0[:, None, None] + off[None, :, None]
    in_image = (cols >= 0) & (cols < width) & (rows >= 0) & (rows < height)
    px = cols.to(like.dtype) + 0.5
    py = rows.to(like.dtype) + 0.5
    if flip_y:
        py = height - py
    flat = rows.clamp(0, height - 1) * width + cols.clamp(0, width - 1)
    return px, py, flat, in_image


def _cover(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Edge-function coverage of triangles (N, 3, 2) at pixels broadcast to
    (N, ...), with the degenerate-area guard."""
    expand = (slice(None),) + (None,) * (px.dim() - 1)
    x0, y0 = tri[:, 0, 0][expand], tri[:, 0, 1][expand]
    x1, y1 = tri[:, 1, 0][expand], tri[:, 1, 1][expand]
    x2, y2 = tri[:, 2, 0][expand], tri[:, 2, 1][expand]

    def edge(ax, ay, bx, by):
        return (bx - ax) * (py - ay) - ((by - ay) * (px - ax))

    e0 = edge(x0, y0, x1, y1)
    e1 = edge(x1, y1, x2, y2)
    e2 = edge(x2, y2, x0, y0)
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    area = torch.abs((x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0))
    return inside & (area > 1e-12)


def _depth(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Barycentric depth of triangles (N, 3, 3) at pixels broadcast to (N,
    ...); +inf where a pixel is not covered."""
    expand = (slice(None),) + (None,) * (px.dim() - 1)
    x0, y0, z0 = (tri[:, 0, k][expand] for k in range(3))
    x1, y1, z1 = (tri[:, 1, k][expand] for k in range(3))
    x2, y2, z2 = (tri[:, 2, k][expand] for k in range(3))
    denom = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom), denom)
    dx = px - x0
    dy = py - y0
    u = (dx * (y2 - y0) - dy * (x2 - x0)) / safe
    v = (dy * (x1 - x0) - dx * (y1 - y0)) / safe
    inside = (u >= 0) & (v >= 0) & (u + v <= 1) & (torch.abs(denom) > 1e-12)
    z = z0 + u * (z1 - z0) + v * (z2 - z0)
    return torch.where(inside, z, torch.full_like(z, float("inf")))


def _rasterize(tri_px: torch.Tensor, height: int, width: int, chunk: int, window: int,
               flip_y: bool, depth: bool) -> torch.Tensor:
    """Coverage (0/1) or minimum depth per pixel, (B, H, W) float, of
    triangles (B, T, 3, 2|3); see the module docstring for the two routes."""
    B, T = tri_px.shape[:2]
    HW = height * width
    fill = float("inf") if depth else 0.0
    reduce = "amin" if depth else "amax"
    evaluate = _depth if depth else _cover
    out = torch.full((B * HW,), fill, dtype=tri_px.dtype, device=tri_px.device)
    tri = tri_px.reshape(B * T, 3, tri_px.shape[-1])
    owner = torch.arange(B, device=tri.device).repeat_interleave(T)

    fits, c0, r0 = _patch_route(tri, height, width, window, flip_y)
    small = torch.nonzero(fits).flatten()
    if small.numel():
        px, py, flat, in_image = _patch_pixels(c0[small], r0[small], height, width, window,
                                               tri, flip_y)
        val = evaluate(tri[small], px, py)
        if depth:
            val = torch.where(in_image, val, torch.full_like(val, fill))
        else:
            val = (val & in_image).to(tri.dtype)
        flat = flat + (owner[small] * HW)[:, None, None]
        out.scatter_reduce_(0, flat.flatten(), val.flatten(), reduce, include_self=True)

    large = torch.nonzero(~fits).flatten()
    if large.numel():
        px, py = _pixel_centres(height, width, tri, flip_y)
        view = out.view(B, HW)
        for s in range(0, large.numel(), chunk):
            idx = large[s: s + chunk]
            val = evaluate(tri[idx], px[None], py[None]).reshape(len(idx), HW)
            if not depth:
                val = val.to(tri.dtype)
            rows = owner[idx][:, None].expand(-1, HW)
            view.scatter_reduce_(0, rows, val, reduce, include_self=True)
    return out.view(B, height, width)


def rasterize_silhouette(tri_px: torch.Tensor, height: int, width: int, chunk: int = CHUNK,
                         flip_y: bool = True, window: int = WINDOW) -> torch.Tensor:
    """Binary coverage mask (..., H, W) of triangles (..., T, 3, 2) in pixel
    coordinates: True where any triangle covers the pixel centre."""
    lead = tri_px.shape[:-3]
    tri = tri_px.reshape((-1,) + tri_px.shape[-3:])
    cov = _rasterize(tri, height, width, chunk, window, flip_y, depth=False)
    return (cov > 0).reshape(lead + (height, width))


def rasterize_depth(tri_px: torch.Tensor, height: int, width: int, chunk: int = CHUNK,
                    flip_y: bool = True, window: int = WINDOW) -> torch.Tensor:
    """Z-buffer (..., H, W): per pixel the minimum interpolated depth over
    the covering triangles (..., T, 3, 3) (pixel x, pixel y, depth); +inf
    where uncovered."""
    lead = tri_px.shape[:-3]
    tri = tri_px.reshape((-1,) + tri_px.shape[-3:])
    z = _rasterize(tri, height, width, chunk, window, flip_y, depth=True)
    return z.reshape(lead + (height, width))


def render_silhouette(camera: OrthoCamera, verts: torch.Tensor, faces: torch.Tensor,
                      chunk: int = CHUNK, occluder_verts: Optional[torch.Tensor] = None,
                      occluder_faces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project and rasterize one mesh -> (H, W) bool. With occluders a pixel
    belongs to the mesh only where it is the nearest surface (the reference
    renders the human with the asset, so what lies behind it vanishes)."""
    return render_silhouettes_batch(camera, verts[None], faces, chunk, occluder_verts,
                                    occluder_faces)[0]


def silhouette_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of binary masks over the last two axes (reference:
    ``initialize_depth.py:175-178``), float32."""
    a = a.bool()
    b = b.bool()
    inter = (a & b).sum(dim=(-2, -1))
    union = (a | b).sum(dim=(-2, -1))
    return inter.float() / torch.clamp(union, min=1).float()


def render_silhouettes_batch(camera: OrthoCamera, verts_batch: torch.Tensor,
                             faces: torch.Tensor, chunk: int = CHUNK,
                             occluder_verts: Optional[torch.Tensor] = None,
                             occluder_faces: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every mesh of (B, V, 3) in one pass -> (B, H, W) bool; the occluder's
    z-buffer is computed once and shared by all of them."""
    W, H = camera.resolution
    faces = faces.long()
    pz = project_points(camera, verts_batch)                      # (B, V, 3)
    if occluder_verts is None:
        return rasterize_silhouette(pz[:, faces][..., :2], H, W, chunk=chunk)
    occ = project_points(camera, occluder_verts)
    z_occ = rasterize_depth(occ[occluder_faces.long()], H, W, chunk=chunk)
    z_mesh = rasterize_depth(pz[:, faces], H, W, chunk=chunk)
    return torch.isfinite(z_mesh) & (z_mesh <= z_occ[None])
