"""Bilinear point sampling and ROIAlign as plain tensor code (gathers and weights).

Counterpart of ``coma_tpu/ops/sampling.py``: detectron2's ``point_sample``
(``F.grid_sample`` with ``align_corners=False`` and zero padding) and
``ROIAlign(aligned=True)`` (ROIAlignV2) with the fixed 2x2 sub-grid that
``coma_tpu`` uses in place of detectron2's adaptive ``sampling_ratio=0``.
The corner gathers, their validity tests and the weights are ``coma_tpu``'s,
operation for operation, so zero padding and the frame's edges agree with
it; ``F.grid_sample`` is not used.

Layout is ``coma_tpu``'s, channels last: a feature map is (H, W, C), or
(B, H, W, C) with boxes and points carrying the same leading B. The FPN
pooling gathers every box's samples from its own level of one flattened
(Σ B·H_l·W_l, C) buffer, in chunks of ROIs so the (R, Sq, Sq, C) corner
transients stay bounded.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _bilinear(flat: torch.Tensor, base, H, W, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear samples of the (H, W) map stored from row ``base``
    of ``flat`` (N, C), at continuous pixel positions ``x``, ``y`` (pixel
    centres at integers). ``base``, ``H``, ``W`` broadcast against ``x``."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    zero = flat.new_zeros(())

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.minimum(torch.clamp(yi, min=0), torch.as_tensor(H - 1, dtype=yi.dtype,
                                                                   device=yi.device)).long()
        xc = torch.minimum(torch.clamp(xi, min=0), torch.as_tensor(W - 1, dtype=xi.dtype,
                                                                   device=xi.device)).long()
        v = flat[base + yc * W + xc]
        return torch.where(valid[..., None], v, zero)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


def _batch_base(feat: torch.Tensor, like: torch.Tensor):
    """(B, H, W, C) map -> row offset of each batch item, broadcast to ``like``
    (B, ...); 0 for an unbatched (H, W, C) map."""
    if feat.dim() == 3:
        return 0
    B, H, W, _ = feat.shape
    base = torch.arange(B, device=feat.device) * (H * W)
    return base.reshape((B,) + (1,) * (like.dim() - 1))


def grid_sample_bilinear(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (H, W, C) or (B, H, W, C) at normalized ``coords``
    (..., 2) or (B, ..., 2) in [0, 1] (x first): position ``coord * size -
    0.5``, zero outside the map. Returns (..., C)."""
    H, W, C = feat.shape[-3:]
    x = coords[..., 0] * W - 0.5
    y = coords[..., 1] * H - 0.5
    return _bilinear(feat.reshape(-1, C), _batch_base(feat, x), H, W, x, y)


def point_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """detectron2 ``point_sample``: ``feat`` (H, W, C), ``coords`` (P, 2) -> (P, C)."""
    return grid_sample_bilinear(feat, coords)


def _subsample_offsets(S: int, q: int, device) -> torch.Tensor:
    """Sub-sample centres along a box: bin i, sub j at (i + (j + 0.5)/q) / S."""
    i = torch.arange(S, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(q, device=device, dtype=torch.float32)[None, :]
    return (i + (j + 0.5) / q).reshape(-1) / S


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, output_size: int, spatial_scale: float,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlignV2: ``feat`` (H, W, C), ``boxes`` (R, 4) xyxy in image
    coordinates -> (R, S, S, C), each bin the mean of a q x q sub-grid."""
    S, q = output_size, sampling_ratio
    H, W, C = feat.shape
    b = boxes * spatial_scale - 0.5
    x0, y0, x1, y1 = b.unbind(-1)
    bw = torch.clamp(x1 - x0, min=1e-6)
    bh = torch.clamp(y1 - y0, min=1e-6)
    u = _subsample_offsets(S, q, feat.device)
    xs = x0[:, None] + u[None, :] * bw[:, None]            # (R, Sq)
    ys = y0[:, None] + u[None, :] * bh[:, None]
    R, n = xs.shape
    gx = xs[:, None, :].expand(R, n, n)
    gy = ys[:, :, None].expand(R, n, n)
    coords = torch.stack([(gx + 0.5) / W, (gy + 0.5) / H], dim=-1)
    vals = grid_sample_bilinear(feat, coords)              # (R, Sq, Sq, C)
    return vals.reshape(R, S, q, S, q, C).mean(dim=(2, 4))


def _fpn_level_assignment(boxes: torch.Tensor, num_levels: int, canonical_level: int,
                          canonical_size: float) -> torch.Tensor:
    """detectron2 ``ROIPooler``'s rule, 0-based: ``floor(canonical +
    log2(sqrt(area) / canonical_size))`` clamped to the levels."""
    areas = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
             * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(areas) / canonical_size + 1e-8))
    return (torch.clamp(lvl, 2, 2 + num_levels - 1) - 2).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor, output_size: int,
                         strides: tuple, canonical_level: int = 4,
                         canonical_size: float = 224.0, sampling_ratio: int = 2,
                         chunk: int = 1024) -> torch.Tensor:
    """FPN level-aware ROIAlign: ``feats`` are (H_l, W_l, C) for p2..p5, or
    (B, H_l, W_l, C) with ``boxes`` (B, R, 4); ``strides`` their image
    strides. Each box is pooled only at its assigned level. Returns (R, S,
    S, C), or (B, R, S, S, C)."""
    S, q = output_size, sampling_ratio
    batched = feats[0].dim() == 4
    if not batched:
        feats, boxes = [f[None] for f in feats], boxes[None]
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    device = boxes.device
    dims = [tuple(f.shape[1:3]) for f in feats]
    sizes = [B * h * w for h, w in dims]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(feats))], device=device)
    flat = torch.cat([f.reshape(-1, C) for f in feats], dim=0)
    Hs = torch.tensor([h for h, _ in dims], device=device)
    Ws = torch.tensor([w for _, w in dims], device=device)
    inv_stride = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=device)
    u = _subsample_offsets(S, q, device)

    lvl = _fpn_level_assignment(boxes, len(strides), canonical_level, canonical_size)
    img = torch.arange(B, device=device)[:, None].expand(B, R)
    boxes, lvl, img = boxes.reshape(-1, 4), lvl.reshape(-1), img.reshape(-1)
    out = []
    for s in range(0, B * R, chunk):
        bx, lv, im = boxes[s:s + chunk], lvl[s:s + chunk], img[s:s + chunk]
        Hb, Wb = Hs[lv][:, None, None], Ws[lv][:, None, None]
        base = (offsets[lv] + im * Hs[lv] * Ws[lv])[:, None, None]
        b = bx * inv_stride[lv][:, None] - 0.5
        x0b, y0b = b[:, 0], b[:, 1]
        bw = torch.clamp(b[:, 2] - x0b, min=1e-6)
        bh = torch.clamp(b[:, 3] - y0b, min=1e-6)
        n = S * q
        gx = (x0b[:, None] + u[None, :] * bw[:, None])[:, None, :].expand(-1, n, n)
        gy = (y0b[:, None] + u[None, :] * bh[:, None])[:, :, None].expand(-1, n, n)
        vals = _bilinear(flat, base, Hb, Wb, gx, gy)        # (r, Sq, Sq, C)
        out.append(vals.reshape(-1, S, q, S, q, C).mean(dim=(2, 4)))
    pooled = torch.cat(out, dim=0).reshape(B, R, S, S, C)
    return pooled if batched else pooled[0]


def _multilevel_roi_align_dense(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                                output_size: int, strides: tuple, canonical_level: int = 4,
                                canonical_size: float = 224.0,
                                sampling_ratio: int = 2) -> torch.Tensor:
    """Every box pooled at every level and contracted with the one-hot level
    assignment: L x the gathers of :func:`multilevel_roi_align`, its oracle."""
    lvl = _fpn_level_assignment(boxes, len(strides), canonical_level, canonical_size)
    onehot = F.one_hot(lvl, len(strides)).T.to(feats[0].dtype)    # (L, R)
    pooled = torch.stack([roi_align(f, boxes, output_size, 1.0 / s, sampling_ratio)
                          for f, s in zip(feats, strides)])       # (L, R, S, S, C)
    return torch.einsum("lrijc,lr->rijc", pooled, onehot)
