"""Affordance visualization without Blender, mayavi, matplotlib or PIL.

Counterpart of ``coma_tpu/visualization/viz.py``. Reference parity:
- ``src/visualization/visualize_human.py`` (per-vertex affordance weights as
  vertex colors on the SMPL-X star mesh, Blender) -> vertex-colored PLY mesh
  (byte-equal to ``coma_tpu``'s) + a PNG preview.
- ``src/visualization/visualize_occupancy.py`` (mayavi volume render) ->
  a slice grid + max-projections (``visualization/volume.py`` renders the
  volume).
- ``utils/visualization/visualize_video.py`` (per-step PNGs -> mp4 via an
  ffmpeg shell-out) -> same, ffmpeg.

``coma_tpu`` draws the preview and the slice grid with matplotlib, which the
card machine lacks: the preview is the port's rasterizer over the same face
colours from the same view, the grid the same six panels through a numpy
copy of matplotlib's ``inferno``. Text is stamped with a 5x7 bitmap font.
"""
from __future__ import annotations

import os
import subprocess
from typing import List, Optional

import numpy as np
import torch

from coma_tpu_torch.utils.colormap import inferno_rgb, jet_rgb
from coma_tpu_torch.utils.png import write_png

# matplotlib's default face colour 'C0' (#1f77b4), for a preview without weights
_C0 = np.array([0x1F, 0x77, 0xB4], np.float64) / 255.0
PANEL_PX, GAP_PX = 192, 12     # the slice grid's panel side and spacing


def _unit_weights(weights: np.ndarray) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    return (w - w.min()) / max(w.max() - w.min(), 1e-12)


def save_vertex_colored_mesh(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    weights: np.ndarray,
    cmap=jet_rgb,
) -> None:
    """Binary PLY mesh with per-vertex colors from normalized weights."""
    colors = np.clip(np.round(cmap(_unit_weights(weights)) * 255), 0, 255).astype(np.uint8)
    n_v, n_f = len(verts), len(faces)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n_v}",
        "property double x", "property double y", "property double z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {n_f}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    vertex = np.empty(n_v, np.dtype([("xyz", "<f8", 3), ("rgb", "u1", 3)]))
    vertex["xyz"] = np.asarray(verts, "<f8")
    vertex["rgb"] = colors
    face = np.empty(n_f, np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
    face["n"] = 3
    face["idx"] = np.asarray(faces, "<i4")
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(vertex.tobytes())
        fh.write(face.tobytes())


def preview_face_colors(faces: np.ndarray, weights: Optional[np.ndarray]) -> np.ndarray:
    """(F, 3) face colours of the preview: jet of the mean normalized vertex
    weight (``coma_tpu``'s ``tri.set_fc``), or matplotlib's 'C0' without
    weights."""
    faces = np.asarray(faces)
    if weights is None:
        return np.tile(_C0, (len(faces), 1))
    return jet_rgb(_unit_weights(weights)[faces].mean(axis=1))


def render_mesh_preview(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    weights: Optional[np.ndarray] = None,
    resolution: int = 512,
    elev: float = 15.0,
    azim: float = 45.0,
    device="cuda",
) -> np.ndarray:
    """PNG preview of a (weight-colored) mesh; returns the (H, W, 3) float
    image. Orthographic, from matplotlib's view angles (``elev``, ``azim``),
    framing the cube of side the mesh's largest extent around its mean
    vertex (``coma_tpu``'s axis limits); flat face colours
    (:func:`preview_face_colors`) on white."""
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.lifting.rasterizer import rasterize_attributes
    from coma_tpu_torch.visualization.volume import _orbit_axes

    dev = resolve_device(device)
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    extent = float(np.ptp(v, axis=0).max())
    center = v.mean(axis=0)
    right, up, fwd = (a.cpu().numpy().astype(np.float64) for a in _orbit_axes(elev, azim))
    span = max(float(np.sqrt(3.0)) * extent, 1e-12)   # the cube's diagonal fits
    rel = v - center
    H = W = resolution
    px = (rel @ right / span + 0.5) * W
    py = (0.5 - rel @ up / span) * H
    depth = rel @ fwd + 0.5 * span
    tri_px = np.stack([px, py, depth], -1)[f]
    T = len(f)
    zbuf, _, mat, _ = rasterize_attributes(
        torch.as_tensor(np.float32(tri_px), device=dev),
        torch.zeros((T, 3, 2), dtype=torch.float32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev),
        torch.zeros((T, 3), dtype=torch.float32, device=dev),
        height=H, width=W, flip_y=False,
    )[:4]
    covered = torch.isfinite(zbuf).cpu().numpy()
    colors = preview_face_colors(f, weights)
    img = np.where(covered[..., None], colors[mat.cpu().numpy()], 1.0).astype(np.float32)
    if path:
        write_png(path, np.round(img * 255).astype(np.uint8))
    return img


def occupancy_slice_panels(prob_field: np.ndarray) -> List[np.ndarray]:
    """The six panels of :func:`visualize_occupancy_slices`, in ``coma_tpu``'s
    order: z-slices at 30/50/70% (``prob_field[int(R * frac)]``), then the
    max-projections over axes 0, 1, 2."""
    R = prob_field.shape[0]
    panels = [prob_field[int(R * frac)] for frac in (0.3, 0.5, 0.7)]
    return panels + [prob_field.max(axis=axis) for axis in (0, 1, 2)]


def visualize_occupancy_slices(path: str, prob_field: np.ndarray) -> np.ndarray:
    """Occupancy field (R, R, R) as a 2x3 grid (three z-slices over three
    max-projections), each panel coloured by ``inferno`` from 0 to its own
    maximum (``imshow(..., cmap="inferno", vmin=0)``), scaled to
    ``PANEL_PX`` by nearest sampling, on white; returns the (H, W, 3) float
    image. (``coma_tpu``'s ``mesh`` and ``threshold`` arguments, which it
    never reads, are left out.)"""
    panels = occupancy_slice_panels(np.asarray(prob_field))
    P, g = PANEL_PX, GAP_PX
    img = np.ones((2 * P + 3 * g, 3 * P + 4 * g, 3), np.float64)
    for k, panel in enumerate(panels):
        rows = np.arange(P) * panel.shape[0] // P
        cols = np.arange(P) * panel.shape[1] // P
        rgb = inferno_rgb(panel, vmin=0.0)[rows][:, cols]
        r, c = divmod(k, 3)
        y0, x0 = g + r * (P + g), g + c * (P + g)
        img[y0:y0 + P, x0:x0 + P] = rgb
    if path:
        write_png(path, np.round(img * 255).astype(np.uint8))
    return img.astype(np.float32)


def frames_to_video(frames_dir: str, out_path: str, fps: int = 10) -> bool:
    """PNG frames -> mp4 via ffmpeg (reference: ``visualize_video.py:38``).

    Returns False when ffmpeg is unavailable."""
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
             "-i", os.path.join(frames_dir, "*.png"),
             "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True,
        )
        return True
    except (FileNotFoundError, subprocess.CalledProcessError):
        return False


# 5x7 glyphs, one 5-bit row per entry (bit 4 the leftmost pixel); lower case
# is drawn as upper case and any other character as '?'.
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 17, 31, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    "!": (4, 4, 4, 4, 0, 0, 4), "?": (14, 17, 1, 2, 4, 0, 4),
    ".": (0, 0, 0, 0, 0, 12, 12), ",": (0, 0, 0, 0, 12, 4, 8),
    "-": (0, 0, 0, 31, 0, 0, 0), "_": (0, 0, 0, 0, 0, 0, 31),
    ":": (0, 12, 12, 0, 12, 12, 0), "/": (0, 1, 2, 4, 8, 16, 0),
    "(": (2, 4, 8, 8, 8, 4, 2), ")": (8, 4, 2, 2, 2, 4, 8),
    "=": (0, 0, 31, 0, 31, 0, 0), "+": (0, 4, 4, 31, 4, 4, 0),
    "%": (24, 25, 2, 4, 8, 19, 3), "'": (12, 4, 8, 0, 0, 0, 0),
}


def _text_mask(message: str) -> np.ndarray:
    """(7, 6 * len(message)) bool: each glyph 5 wide and a blank column."""
    rows = []
    for ch in message:
        glyph = _FONT.get(ch.upper(), _FONT["?"])
        bits = (np.asarray(glyph)[:, None] >> np.arange(4, -1, -1)) & 1
        rows.append(np.concatenate([bits, np.zeros((7, 1), int)], axis=1))
    return np.concatenate(rows, axis=1).astype(bool) if rows else np.zeros((7, 0), bool)


def write_message_on_img(image: np.ndarray, message: str) -> np.ndarray:
    """Stamp a sentinel/debug message onto an image (RGB uint8) in red.

    Reference parity: ``utils/misc.py:write_message_on_img:88-92`` (used by
    ``predict_human.py`` to annotate failure images, e.g. "NO HUMANS"), at
    ``coma_tpu``'s anchor (``(max(0, H - 150), H - 20)``, the text's top
    left); the glyphs are a 5x7 bitmap font, not PIL's."""
    out = np.array(image, copy=True)
    H, W = out.shape[:2]
    x0, y0 = max(0, H - 150), H - 20
    mask = _text_mask(message)
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y0, xs + x0
    keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    out[ys[keep], xs[keep]] = (255, 0, 0)
    return out
