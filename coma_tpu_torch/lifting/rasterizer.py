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
  patch, or else one four times as wide, is tested only at that patch's
  pixels, and its coverage or depth is scattered into the image with
  ``amax``/``amin`` (a body at 512² has pixel-sized triangles: this is
  nearly all of them; a shadow map fitted to an asset, mid-sized ones);
- the others are tested against every pixel, ``chunk`` triangles at a time,
  as ``coma_tpu`` does (``window = 0`` sends every triangle there).

The silhouette and depth functions take a leading batch of meshes, so the
candidates of depth initialisation (and the 8 ambient-occlusion directions
of the textured renderer) render in one pass.

The textured half (reference: the Cycles renders of
``render_objects.py:90,309`` and ``utils/blenderproc.py:100-180``) follows
``coma_tpu`` term by term: :func:`rasterize_attributes` is its
winner-take-all attribute pass (nearest depth; on equal depth the lowest
triangle index, as ``argmin`` within a chunk and the strict ``<`` across
chunks give it), computed here as a scatter-``amin`` of depth over both
routes, then a scatter-``amin`` of the index over the triangles that reach
it, then the winner's barycentrics at each pixel centre. On it
:func:`render_textured` adds bilinear textures, two-sided Lambert, the
shadow-mapped light (PCF, soft area-light directions), hemisphere ambient
occlusion, the sky environment, GGX specular, one-bounce reflective-shadow-
map GI and the ACES tonemap. Products with the light frame's basis are
written as three multiply-adds, so no matmul (and no TF32) is involved.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from coma_tpu_torch.lifting.cameras import OrthoCamera, project_points

WINDOW = 16
CHUNK = 64
PATCH_PIXELS = 1 << 24   # pixel tests per batch of patches (bounds the temporaries)


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


def _routes(tri: torch.Tensor, height: int, width: int, window: int, flip_y: bool):
    """([(patch size, triangle indices, first columns, first rows)], one entry
    per batch of a patch tier, the smallest tier first; the indices of the
    triangles left for the dense chunks)."""
    batches = []
    left = torch.ones(tri.shape[0], dtype=torch.bool, device=tri.device)
    for size in ((window, 4 * window) if window > 0 else ()):
        fits, c0, r0 = _patch_route(tri, height, width, size, flip_y)
        idx = torch.nonzero(fits & left).flatten()
        step = max(PATCH_PIXELS // (size * size), 1)
        for s in range(0, idx.numel(), step):
            sub = idx[s: s + step]
            batches.append((size, sub, c0[sub], r0[sub]))
        left = left & ~fits
    return batches, torch.nonzero(left).flatten()


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


def _barycentric(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(u, v, depth) of triangles (N, 3, 3) at pixels broadcast to (N, ...),
    the depth +inf where a pixel is not covered; ``coma_tpu``'s expressions."""
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
    return u, v, torch.where(inside, z, torch.full_like(z, float("inf")))


def _depth(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Barycentric depth of triangles (N, 3, 3) at pixels broadcast to (N,
    ...); +inf where a pixel is not covered."""
    return _barycentric(tri, px, py)[2]


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

    batches, large = _routes(tri, height, width, window, flip_y)
    for size, idx, c0, r0 in batches:
        px, py, flat, in_image = _patch_pixels(c0, r0, height, width, size, tri, flip_y)
        val = evaluate(tri[idx], px, py)
        if depth:
            val = torch.where(in_image, val, torch.full_like(val, fill))
        else:
            val = (val & in_image).to(tri.dtype)
        flat = flat + (owner[idx] * HW)[:, None, None]
        out.scatter_reduce_(0, flat.flatten(), val.flatten(), reduce, include_self=True)

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


# ---------------------------------------------------------------------------
# The textured half: attributes, shading, shadows, environment, GI
# ---------------------------------------------------------------------------

def rasterize_attributes(tri_px: torch.Tensor, tri_uv: torch.Tensor, tri_mat: torch.Tensor,
                         tri_n: torch.Tensor, height: int, width: int, chunk: int = CHUNK,
                         flip_y: bool = True, tri_aux: Optional[torch.Tensor] = None,
                         window: int = WINDOW):
    """Z-buffered attribute pass of triangles (T, 3, 3) (pixel x, pixel y,
    depth) with corner UVs (T, 3, 2), materials (T,), face normals (T, 3) and
    optional corner attributes ``tri_aux`` (T, 3, K), interpolated like the
    UVs -> (zbuf (H, W), uv (H, W, 2), mat (H, W), normal (H, W, 3)[, aux
    (H, W, K)]) of the nearest triangle per pixel; on equal depth the lowest
    index wins. Uncovered pixels: zbuf +inf, everything else 0."""
    T = tri_px.shape[0]
    HW = height * width
    dev, dt = tri_px.device, tri_px.dtype
    inf = float("inf")
    zbuf = torch.full((HW,), inf, dtype=dt, device=dev)
    win = torch.full((HW,), T, dtype=torch.long, device=dev)   # T: no triangle
    batches, large = _routes(tri_px, height, width, window, flip_y)
    px_d, py_d = _pixel_centres(height, width, tri_px, flip_y)

    def patch_depth(size, idx, c0, r0):
        px, py, flat, in_image = _patch_pixels(c0, r0, height, width, size, tri_px, flip_y)
        z = _depth(tri_px[idx], px, py)
        return torch.where(in_image, z, torch.full_like(z, inf)), flat

    def dense_depth(idx):
        return _depth(tri_px[idx], px_d[None], py_d[None]).reshape(len(idx), HW)

    for size, idx, c0, r0 in batches:
        z, flat = patch_depth(size, idx, c0, r0)
        zbuf.scatter_reduce_(0, flat.flatten(), z.flatten(), "amin", include_self=True)
    for s in range(0, large.numel(), chunk):
        zbuf = torch.minimum(zbuf, dense_depth(large[s: s + chunk]).amin(dim=0))
    # the winner: the lowest index among the triangles at the nearest depth
    for size, idx, c0, r0 in batches:
        z, flat = patch_depth(size, idx, c0, r0)
        hit = torch.isfinite(z) & (z == zbuf[flat])
        cand = torch.where(hit, idx[:, None, None].expand_as(flat), torch.full_like(flat, T))
        win.scatter_reduce_(0, flat.flatten(), cand.flatten(), "amin", include_self=True)
    for s in range(0, large.numel(), chunk):
        idx = large[s: s + chunk]
        z = dense_depth(idx)
        hit = torch.isfinite(z) & (z == zbuf[None])
        cand = torch.where(hit, idx[:, None].expand_as(z), torch.full_like(z, T, dtype=torch.long))
        win = torch.minimum(win, cand.amin(dim=0))

    covered = win < T
    w = win.clamp(max=max(T - 1, 0))
    px_flat = px_d.expand(height, width).reshape(HW)
    py_flat = py_d.expand(height, width).reshape(HW)
    u, v, _ = _barycentric(tri_px[w], px_flat, py_flat)
    u, v = u[:, None], v[:, None]
    cov = covered[:, None]

    def interpolate(corners):
        c = corners[w]
        val = c[:, 0] + u * (c[:, 1] - c[:, 0]) + v * (c[:, 2] - c[:, 0])
        return torch.where(cov, val, torch.zeros_like(val)).reshape(height, width, -1)

    uv_img = interpolate(tri_uv)
    mat_img = torch.where(covered, tri_mat[w], torch.zeros_like(tri_mat[w])).reshape(height, width)
    n_img = torch.where(cov, tri_n[w], torch.zeros_like(tri_n[w])).reshape(height, width, 3)
    zbuf = zbuf.reshape(height, width)
    if tri_aux is None:
        return zbuf, uv_img, mat_img, n_img
    return zbuf, uv_img, mat_img, n_img, interpolate(tri_aux)


def _dot3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row vectors (..., 3) times matrices (..., 3, 3) broadcast against them,
    as three multiply-adds in ``p @ m``'s order (no matmul, no TF32)."""
    return p[..., 0:1] * m[..., 0, :] + p[..., 1:2] * m[..., 1, :] + p[..., 2:3] * m[..., 2, :]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last axis of (..., 3) tensors."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    n = torch.sqrt(_dot(a, a))
    return n[..., None] if keepdim else n


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _golden_angle(dtype, device) -> torch.Tensor:
    """π (1 + √5) in ``dtype``, rounded as ``coma_tpu`` forms it."""
    five = torch.tensor(5.0, dtype=dtype, device=device)
    return torch.tensor(math.pi, dtype=dtype, device=device) * (1.0 + torch.sqrt(five))


def _light_frame(casters: torch.Tensor, d: torch.Tensor, res: int):
    """Orthographic light frames fitted to the caster footprint, one per
    direction d (D, 3) (unit, surface -> light) -> (basis (D, 3, 3), world ->
    light coordinates, its third column looking along -d so that smaller
    raster depth is nearer the light; to_shadow_px, mapping light
    coordinates (D, ..., 3) to shadow-map pixels with depth in the same
    pixel scale; px_per_world (D,)). Shared by the shadow, AO and RSM passes
    so their projections agree."""
    z_up = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    y_up = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
    up = torch.where((torch.abs(d[:, 2]) < 0.9)[:, None], z_up, y_up)
    lx = _cross(up, d)
    lx = lx / _norm(lx, keepdim=True)
    ly = _cross(d, lx)
    basis = torch.stack([lx, ly, -d], dim=-1)
    lverts = _dot3(casters.reshape(1, -1, 3), basis[:, None])           # (D, 3C, 3)
    lo = lverts[..., :2].amin(dim=1)
    hi = lverts[..., :2].amax(dim=1)
    span = torch.clamp((hi - lo).amax(dim=-1), min=1e-6)
    px_per_world = (res - 2.0) / span

    def to_shadow_px(p):
        lead = (p.shape[0],) + (1,) * (p.dim() - 2)
        xy = (p[..., :2] - lo.reshape(lead + (2,))) * px_per_world.reshape(lead + (1,)) + 1.0
        z = p[..., 2] * px_per_world.reshape(lead)
        return torch.cat([xy, z[..., None]], dim=-1)

    return basis, to_shadow_px, px_per_world


def _directional_visibility(casters: torch.Tensor, pos_img: torch.Tensor, d: torch.Tensor,
                            res: int, bias_px: float, pcf: int, chunk: int) -> torch.Tensor:
    """(D, H, W): per direction d (D, 3), the fraction of ``pcf``² shadow-map
    taps that are unoccluded at each pixel's world position (H, W, 3). One
    depth-only pass per direction, all directions in one batched raster;
    pixels outside the caster footprint are lit."""
    basis, to_shadow_px, _ = _light_frame(casters, d, res)
    D = d.shape[0]
    lverts = _dot3(casters.reshape(1, -1, 3), basis[:, None])
    shadow_z = rasterize_depth(to_shadow_px(lverts).reshape(D, -1, 3, 3), res, res,
                               chunk=chunk, flip_y=False).reshape(D, res * res)
    sp = to_shadow_px(_dot3(pos_img[None], basis[:, None, None]))       # (D, H, W, 3)
    inb = ((sp[..., 0] >= 0) & (sp[..., 0] <= res - 1)
           & (sp[..., 1] >= 0) & (sp[..., 1] <= res - 1))
    H, W = pos_img.shape[:2]
    r = pcf // 2
    rows = torch.round(sp[..., 1]).long()
    cols = torch.round(sp[..., 0]).long()
    lit = torch.zeros(D, H, W, dtype=pos_img.dtype, device=pos_img.device)
    for dy in range(-r, pcf - r):
        for dx in range(-r, pcf - r):
            iy = torch.clamp(rows + dy, 0, res - 1)
            ix = torch.clamp(cols + dx, 0, res - 1)
            occ = torch.gather(shadow_z, 1, (iy * res + ix).reshape(D, -1)).reshape(D, H, W)
            lit = lit + (sp[..., 2] <= occ + bias_px).to(pos_img.dtype)
    lit = lit / (pcf * pcf)
    return torch.where(inb, lit, torch.ones_like(lit))


def cosine_hemisphere_dirs(n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``n`` deterministic cosine-weighted directions on the +z hemisphere
    (a Fibonacci spiral on the unit disk projected up, Malley's method).
    Formed on the CPU, whose ``cos``/``sin`` the card's differ from in the
    last bit, so that every device rasterizes the same light frames."""
    i = torch.arange(n, dtype=dtype) + 0.5
    r = torch.sqrt(i / n)
    theta = _golden_angle(dtype, "cpu") * i
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - r * r, min=1e-12))
    return torch.stack([x, y, z], dim=-1).to(device)


def make_sky_env(sky=(0.62, 0.72, 0.88), horizon=(0.85, 0.83, 0.78),
                 ground=(0.35, 0.32, 0.28), height: int = 16, width: int = 4,
                 device="cuda") -> torch.Tensor:
    """A small lat-long environment (height, width, 3) float32: sky at the
    zenith, a warm horizon band, dark ground (the reference's Cycles world
    shader, ``blenderproc.py:100-113``)."""
    t = torch.linspace(0.0, 1.0, height, device=device)[:, None]       # 0 zenith, 1 nadir
    sky_c, hor_c, gnd_c = (torch.tensor(c, dtype=torch.float32, device=device)
                           for c in (sky, horizon, ground))
    upper = sky_c[None] * (1 - t * 2) + hor_c[None] * (t * 2)
    lower = hor_c[None] * (2 - t * 2) + gnd_c[None] * (t * 2 - 1)
    col = torch.where(t < 0.5, upper, lower)
    return col[:, None, :].expand(height, width, 3).contiguous()


def sample_env(env_map: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long lookup: directions (..., 3) -> radiance (..., 3);
    row = polar angle from +z, column = azimuth with wrap."""
    He, We, _ = env_map.shape
    d = dirs / torch.clamp(_norm(dirs, keepdim=True), min=1e-12)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    r = theta / math.pi * (He - 1)
    c = (phi + math.pi) / (2 * math.pi) * We
    r0 = torch.clamp(torch.floor(r).long(), 0, He - 1)
    r1 = torch.clamp(r0 + 1, max=He - 1)
    c0 = torch.remainder(torch.floor(c).long(), We)
    c1 = torch.remainder(c0 + 1, We)
    wr = (r - r0.to(r.dtype))[..., None]
    wc = (c - torch.floor(c))[..., None]
    return (env_map[r0, c0] * (1 - wr) * (1 - wc) + env_map[r0, c1] * (1 - wr) * wc
            + env_map[r1, c0] * wr * (1 - wc) + env_map[r1, c1] * wr * wc)


def _sample_texture(textures: torch.Tensor, uv_img: torch.Tensor,
                    mat_img: torch.Tensor) -> torch.Tensor:
    """Bilinear texture fetch with wrap (OBJ convention: v runs bottom-up)
    from layers (M, S, S, 3) at UVs (..., 2) and materials (...)."""
    S = textures.shape[1]
    uu = torch.remainder(uv_img[..., 0], 1.0) * (S - 1)
    vv = (1.0 - torch.remainder(uv_img[..., 1], 1.0)) * (S - 1)
    x0 = torch.floor(uu).long()
    y0 = torch.floor(vv).long()
    x1 = torch.clamp(x0 + 1, max=S - 1)
    y1 = torch.clamp(y0 + 1, max=S - 1)
    wx = (uu - x0.to(uu.dtype))[..., None]
    wy = (vv - y0.to(vv.dtype))[..., None]
    m = mat_img.long()
    return (textures[m, y0, x0] * (1 - wy) * (1 - wx) + textures[m, y0, x1] * (1 - wy) * wx
            + textures[m, y1, x0] * wy * (1 - wx) + textures[m, y1, x1] * wy * wx)


def _rsm_indirect(casters, tri_uv, tri_mat, tri_n, textures, tri_w, pos_img, n_img,
                  light: torch.Tensor, res: int, samples: int, radius_frac: float,
                  chunk: int) -> torch.Tensor:
    """One-bounce indirect irradiance (H, W, 3) from a reflective shadow map
    (Dachsbacher & Stamminger 2005): position, normal and flux rasterized
    from the light once, then ``samples`` Fibonacci-disk taps around each
    pixel's light-space projection (the single-bounce slice of Cycles' GI;
    multiply by the surface albedo)."""
    basis, to_shadow_px, ppw = _light_frame(casters, light[None], res)
    tri_px_l = to_shadow_px(_dot3(tri_w.reshape(1, -1, 3), basis[:, None]))[0].reshape(-1, 3, 3)
    zbuf_l, uv_l, mat_l, n_l, pos_l = rasterize_attributes(
        tri_px_l, tri_uv, tri_mat, tri_n, res, res, chunk=chunk, flip_y=False, tri_aux=tri_w)
    hit_l = torch.isfinite(zbuf_l)
    albedo_l = _sample_texture(textures, uv_l, mat_l)
    flux_l = albedo_l * torch.abs(_dot(n_l, light))[..., None]
    flux_l = torch.where(hit_l[..., None], flux_l, torch.zeros_like(flux_l))

    sp = to_shadow_px(_dot3(pos_img[None], basis[:, None, None]))[0]     # (H, W, 3)
    ppw = ppw[0]
    R_px = radius_frac * res
    dtype, dev = pos_img.dtype, pos_img.device
    i = torch.arange(samples, dtype=dtype) + 0.5                        # on the CPU, as above
    rr = torch.sqrt(i / samples) * R_px
    th = _golden_angle(dtype, "cpu") * i
    offs = torch.stack([rr * torch.cos(th), rr * torch.sin(th)], dim=-1).to(dev)
    d0sq = (2.0 / ppw) ** 2
    gathered = torch.zeros_like(pos_img)
    for ox, oy in offs:                     # 0-d tensors: no host sync
        ix = torch.clamp(torch.round(sp[..., 0] + ox).long(), 0, res - 1)
        iy = torch.clamp(torch.round(sp[..., 1] + oy).long(), 0, res - 1)
        xs, ns, fx, ok = pos_l[iy, ix], n_l[iy, ix], flux_l[iy, ix], hit_l[iy, ix]
        vec = xs - pos_img
        dist2 = _dot(vec, vec)
        inv = torch.rsqrt(torch.clamp(dist2, min=1e-12))
        dirn = vec * inv[..., None]
        g = torch.abs(_dot(n_img, dirn)) * torch.abs(_dot(ns, dirn)) / (dist2 + d0sq)
        gathered = gathered + fx * torch.where(ok, g, torch.zeros_like(g))[..., None]
    area = math.pi * (R_px / ppw) ** 2 / samples / math.pi
    return gathered * area


def filmic_tonemap(rgb: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (Narkowicz 2015), Cycles' "Filmic" view's
    soft highlight shoulder."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e), 0.0, 1.0)


def render_textured(tri_px, tri_uv, tri_mat, tri_n, textures, height: int, width: int,
                    chunk: int = CHUNK, flip_y: bool = True, light_dir=(0.25, 0.15, 0.95),
                    ambient: float = 0.35, background: float = 1.0, tri_w=None,
                    shadow_casters=None, shadow_res: int = 512, shadow_bias_px: float = 2.0,
                    pcf: int = 3, ao_samples: int = 0, ao_res: int = 256,
                    light_samples: int = 1, light_cone_deg: float = 0.0,
                    specular: float = 0.0, roughness: float = 0.35, view_dir=(0.0, 0.0, 1.0),
                    env_map=None, tonemap: bool = False, gi_samples: int = 0,
                    gi_res: int = 128, gi_radius_frac: float = 0.35, gi_strength: float = 1.0):
    """Textured render -> (rgb (H, W, 3) in [0, 1], coverage (H, W)).

    Two-sided Lambert against a directional light plus an ambient term,
    bilinear UV textures with wrap. With world triangles ``tri_w`` (T, 3, 3):
    a shadow map from the light (``pcf``² percentage-closer taps), averaged
    over ``light_samples`` directions in a ``light_cone_deg`` cone when both
    are set (an area light's penumbra); ``ao_samples`` hemisphere directions
    of ambient occlusion at ``ao_res`` gate the ambient term; ``gi_samples``
    reflective-shadow-map taps add one bounce. ``env_map`` (see
    :func:`make_sky_env`) replaces the flat white ambient, ``specular`` adds
    a GGX lobe, ``tonemap`` the ACES curve; the background stays flat.
    ``shadow_casters`` (C, 3, 3) limits the occluders (default: all)."""
    dtype, dev = tri_px.dtype, tri_px.device
    if tri_w is None:
        zbuf, uv_img, mat_img, n_img = rasterize_attributes(
            tri_px, tri_uv, tri_mat, tri_n, height, width, chunk, flip_y)
        pos_img = None
    else:
        zbuf, uv_img, mat_img, n_img, pos_img = rasterize_attributes(
            tri_px, tri_uv, tri_mat, tri_n, height, width, chunk, flip_y, tri_aux=tri_w)
    covered = torch.isfinite(zbuf)
    tex = _sample_texture(textures, uv_img, mat_img)
    light = torch.tensor(light_dir, dtype=dtype, device=dev)
    light = light / _norm(light)
    lambert = torch.abs(_dot(n_img, light))

    lit, ao = 1.0, 1.0
    if tri_w is not None:
        casters = tri_w if shadow_casters is None else shadow_casters
        if light_samples > 1 and light_cone_deg > 0.0:
            # Fibonacci directions on the light's disk, within the cone
            # (formed on the CPU, as cosine_hemisphere_dirs says why)
            lc = light.cpu()
            up = torch.tensor([0.0, 0.0, 1.0] if abs(float(lc[2])) < 0.9 else [0.0, 1.0, 0.0],
                              dtype=dtype)
            t1 = _cross(up, lc)
            t1 = t1 / _norm(t1)
            t2 = _cross(lc, t1)
            i = torch.arange(light_samples, dtype=dtype) + 0.5
            cone = torch.deg2rad(torch.tensor(light_cone_deg, dtype=dtype))
            rr = torch.sqrt(i / light_samples) * torch.tan(cone)
            th = _golden_angle(dtype, "cpu") * i
            dirs = (lc[None] + (rr * torch.cos(th))[:, None] * t1[None]
                    + (rr * torch.sin(th))[:, None] * t2[None])
            dirs = (dirs / _norm(dirs, keepdim=True)).to(dev)
        else:
            dirs = light[None]
        lit = _directional_visibility(casters, pos_img, dirs, shadow_res, shadow_bias_px, pcf,
                                      chunk).mean(dim=0)
        if ao_samples > 0:
            ao = _directional_visibility(
                casters, pos_img, cosine_hemisphere_dirs(ao_samples, dtype, dev), ao_res,
                shadow_bias_px, 1, chunk).mean(dim=0)

    env = 1.0 if env_map is None else sample_env(env_map, n_img)
    amb = ambient * env * (ao if isinstance(ao, float) else ao[..., None])
    direct = ((1.0 - ambient) * lambert * lit)[..., None]
    if gi_samples > 0 and tri_w is not None:
        indirect = _rsm_indirect(casters, tri_uv, tri_mat, tri_n, textures, tri_w, pos_img,
                                 n_img, light, gi_res, gi_samples, gi_radius_frac, chunk)
        direct = direct + gi_strength * (1.0 - ambient) * indirect
    diffuse = tex * (amb + direct)

    if specular > 0.0:
        # GGX NDF x Schlick Fresnel against the primary light, shadow-gated,
        # two-sided (the Cycles Principled BSDF default is the target)
        view = torch.tensor(view_dir, dtype=dtype, device=dev)
        view = view / _norm(view)
        half = light + view
        half = half / torch.clamp(_norm(half), min=1e-12)
        ndh = torch.abs(_dot(n_img, half))
        alpha2 = (roughness * roughness) ** 2
        denom = ndh * ndh * (alpha2 - 1.0) + 1.0
        ndf = alpha2 / torch.clamp(math.pi * denom * denom, min=1e-6)
        fresnel = 0.04 + 0.96 * (1.0 - torch.abs(_dot(half, view))) ** 5
        spec = specular * ndf * fresnel * lambert * lit
        rgb = diffuse + spec[..., None]
    else:
        rgb = diffuse
    # tonemap the covered pixels, then composite the flat background
    rgb = filmic_tonemap(rgb) if tonemap else torch.clamp(rgb, 0.0, 1.0)
    return torch.where(covered[..., None], rgb, torch.full_like(rgb, background)), covered

