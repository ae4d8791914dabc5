"""Ray-marched 3-D occupancy volume rendering (the mayavi stand-in).

Counterpart of ``coma_tpu/visualization/volume.py``. Reference parity:
``src/visualization/visualize_occupancy.py:27-66`` renders the occupancy
``prob_field`` with ``mayavi.mlab.pipeline.volume`` (emission-absorption
volume rendering) and composites the canonicalized object mesh into the same
scene. Here: a fixed-step front-to-back emission-absorption ray march over
the voxel grid (trilinear sampling, depth slabs of 16 steps so only a (16,
H, W) sample block is live) with the object mesh composited depth-correctly
from the port's z-buffer rasterizer.

Semantics kept from the reference:
* ``ignore_percentage = 0.1`` — field values below 10% of the max are
  zeroed before rendering (``visualize_occupancy.py:26-28``).
* the mesh is drawn in VOXEL coordinates: ``verts / voxel_size + R / 2``
  (``visualize_occupancy.py:52-56``), uniform light-gray (0.8, 0.8, 0.8).
* white background, square viewport.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["render_occupancy_volume", "save_occupancy_volume_render"]

IGNORE_PERCENTAGE = 0.1  # visualize_occupancy.py:26


def _jet(v: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear jet over [0, 1] -> (..., 3)."""
    r = torch.clamp(1.5 - torch.abs(4.0 * v - 3.0), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(4.0 * v - 2.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(4.0 * v - 1.0), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def _orbit_axes(elev_deg: float, azim_deg: float, device="cpu"):
    """Right/up/forward float32 unit vectors of an orbit camera looking at
    the grid center (forward points INTO the scene)."""
    el = torch.deg2rad(torch.tensor(elev_deg, dtype=torch.float32, device=device))
    az = torch.deg2rad(torch.tensor(azim_deg, dtype=torch.float32, device=device))
    fwd = -torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                        torch.sin(el)])
    world_up = torch.tensor([0.0, 0.0, 1.0], device=device)
    right = torch.linalg.cross(fwd, world_up)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-6)
    up = torch.linalg.cross(right, fwd)
    return right, up, fwd


def _trilinear(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinearly sample ``field`` (X, Y, Z) at voxel-space ``pts`` (..., 3);
    a tap outside the grid reads its clamped index and is then zeroed
    (an absorbing boundary)."""
    X, Y, Z = field.shape
    p = pts - 0.5  # voxel centers at integer+0.5
    lo_f = torch.floor(p)
    frac = p - lo_f
    lo = lo_f.to(torch.int64)
    flat_field = field.reshape(-1)
    acc = torch.zeros(pts.shape[:-1], dtype=field.dtype, device=field.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = lo[..., 0] + dx
                iy = lo[..., 1] + dy
                iz = lo[..., 2] + dz
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                inb = ((ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
                       & (iz >= 0) & (iz < Z))
                flat = (ix.clamp(0, X - 1) * (Y * Z) + iy.clamp(0, Y - 1) * Z
                        + iz.clamp(0, Z - 1))
                acc = acc + torch.where(inb, w, torch.zeros_like(w)) * flat_field[flat]
    return acc


def render_occupancy_volume(
    prob_field: torch.Tensor,                       # (X, Y, Z) occupancy field
    mesh_zbuf: Optional[torch.Tensor] = None,       # (H, W) cam-depth or None
    mesh_rgb: Optional[torch.Tensor] = None,        # (H, W, 3) shaded mesh
    *,
    resolution: int = 512,
    num_steps: int = 192,
    slab: int = 16,
    elev_deg: float = 20.0,
    azim_deg: float = 35.0,
    density: float = 60.0,
    ignore_percentage: float = IGNORE_PERCENTAGE,
) -> torch.Tensor:
    """Emission-absorption render of the occupancy field -> (H, W, 3) on the
    field's device.

    Front-to-back compositing over ``num_steps`` fixed steps (rounded up to a
    multiple of ``slab``, as ``coma_tpu`` does), marched in depth slabs of
    ``slab`` steps and composited step by step inside each slab. A mesh pass
    (``mesh_zbuf``/``mesh_rgb`` from :func:`save_occupancy_volume_render`) is
    composited depth-correctly: volume samples behind the surface are
    occluded, the surface color is attenuated by the transmittance
    accumulated in front of it.
    """
    num_steps = ((num_steps + slab - 1) // slab) * slab
    dev = prob_field.device

    f = prob_field.to(torch.float32)
    vmax = torch.clamp(f.max(), min=1e-12)
    f = torch.where(f > ignore_percentage * vmax, f, torch.zeros_like(f)) / vmax

    X, Y, Z = prob_field.shape
    R = max(X, Y, Z)
    H = W = resolution
    center = torch.tensor([X, Y, Z], dtype=torch.float32, device=dev) / 2.0
    right, up, fwd = _orbit_axes(elev_deg, azim_deg, dev)

    # orthographic footprint covering the grid diagonal
    span = 1.05 * float(np.sqrt(3.0)) * R
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W - 0.5
    ys = 0.5 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    origin = (center + (px * span)[..., None] * right + (py * span)[..., None] * up
              - (0.5 * span) * fwd)                   # (H, W, 3) on the near plane
    dt = span / num_steps

    if mesh_zbuf is None:
        mesh_zbuf = torch.full((H, W), float("inf"), dtype=torch.float32, device=dev)
        mesh_rgb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)

    ts = (torch.arange(num_steps, dtype=torch.float32, device=dev) + 0.5) * dt
    color = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((H, W), dtype=torch.float32, device=dev)
    for t_slab in ts.reshape(num_steps // slab, slab):
        pos = origin[None] + t_slab[:, None, None, None] * fwd       # (S, H, W, 3)
        v = _trilinear(f, pos)                                       # (S, H, W)
        # samples at/behind the mesh surface are occluded by it
        v = torch.where(t_slab[:, None, None] < mesh_zbuf[None], v, torch.zeros_like(v))
        alpha = 1.0 - torch.exp(-density * v * dt / R)
        rgb = _jet(v)
        for a, col in zip(alpha, rgb):                               # front to back
            color = color + (trans * a)[..., None] * col
            trans = trans * (1.0 - a)

    # composite the mesh surface, then the white background
    hit = torch.isfinite(mesh_zbuf)
    color = color + torch.where(hit, trans, torch.zeros_like(trans))[..., None] * mesh_rgb
    trans = torch.where(hit, torch.zeros_like(trans), trans)
    color = color + trans[..., None]
    return torch.clamp(color, 0.0, 1.0)


def mesh_pass(
    verts: np.ndarray, faces: np.ndarray, grid_shape, voxel_size: float, resolution: int,
    elev_deg: float, azim_deg: float, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The object mesh's (zbuf (H, W), shaded rgb (H, W, 3)) in the volume
    camera: world vertices placed in voxel space as the reference does
    (``verts / voxel_size + R / 2``), gray (0.8) with a headlight Lambert
    term."""
    from coma_tpu_torch.lifting.rasterizer import rasterize_attributes

    H = W = resolution
    grid_shape = np.asarray(grid_shape, np.float32)
    vvox = np.asarray(verts, np.float32) / voxel_size + grid_shape / 2.0

    right, up, fwd = (a.cpu().numpy() for a in _orbit_axes(elev_deg, azim_deg))
    center = grid_shape / 2.0
    span = 1.05 * float(np.sqrt(3.0)) * float(grid_shape.max())
    rel = vvox - center
    cx = rel @ right
    cy = rel @ up
    cz = rel @ fwd + 0.5 * span   # depth from the near plane
    pxv = (cx / span + 0.5) * W
    pyv = (0.5 - cy / span) * H
    f = np.asarray(faces, np.int64)
    tri_px = np.stack(
        [np.stack([pxv[f[:, k]], pyv[f[:, k]], cz[f[:, k]]], -1) for k in range(3)], 1)
    e1 = vvox[f[:, 1]] - vvox[f[:, 0]]
    e2 = vvox[f[:, 2]] - vvox[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    T = len(f)
    zbuf, _, _, nrm = rasterize_attributes(
        torch.as_tensor(np.float32(tri_px), device=device),
        torch.zeros((T, 3, 2), dtype=torch.float32, device=device),
        torch.zeros((T,), dtype=torch.int32, device=device),
        torch.as_tensor(np.float32(n), device=device),
        height=H, width=W, flip_y=False,
    )[:4]
    lambert = torch.abs(nrm @ -torch.as_tensor(fwd, device=device))
    shade = 0.8 * (0.35 + 0.65 * lambert)      # (0.8, 0.8, 0.8) gray
    return zbuf, shade[..., None].expand(H, W, 3)


def save_occupancy_volume_render(
    path: str,
    prob_field: np.ndarray,
    mesh: Optional[Tuple[np.ndarray, np.ndarray]] = None,  # verts(world), faces
    voxel_size: float = 1.0,
    resolution: int = 512,
    num_steps: int = 192,
    elev_deg: float = 20.0,
    azim_deg: float = 35.0,
    device="cuda",
) -> np.ndarray:
    """Render on ``device`` and write a PNG (when ``path``); returns the (H,
    W, 3) float32 image.

    ``mesh`` vertices are world-space canonicalized coordinates (see
    :func:`mesh_pass`)."""
    from coma_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    mesh_zbuf = mesh_rgb = None
    if mesh is not None:
        mesh_zbuf, mesh_rgb = mesh_pass(mesh[0], mesh[1], np.shape(prob_field), voxel_size,
                                        resolution, elev_deg, azim_deg, dev)
    img = render_occupancy_volume(
        torch.as_tensor(np.asarray(prob_field), device=dev), mesh_zbuf, mesh_rgb,
        resolution=resolution, num_steps=num_steps, elev_deg=elev_deg, azim_deg=azim_deg,
    ).cpu().numpy()
    if path:
        from coma_tpu_torch.utils.png import write_png

        write_png(path, (img * 255).astype(np.uint8))
    return img
