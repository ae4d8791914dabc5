"""The in-loop person segmenter.

Counterpart of ``coma_tpu/models/segmentation.py:29-114``: a U-Net
person-vs-background segmenter, run at its training scale (128²) and
resized back, thresholded into the person mask that the adaptive-mask loop
dilates. The committed checkpoint ``coma_tpu/data/person_segmenter.npz``
loads into it through ``models/flax_params.py``. The host-side instance
utilities of the ``segment_human`` stage (``coma_tpu/models/segmentation.py:
121-159``) are plain numpy.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.layers import Conv, GroupNorm, upsample_nearest2x

# the committed trained checkpoint, read by path (the port imports nothing of coma_tpu)
SEGMENTER_CHECKPOINT = (Path(__file__).resolve().parents[2]
                        / "coma_tpu" / "data" / "person_segmenter.npz")


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    base_channels: int = 32
    depth: int = 4
    dtype: torch.dtype = torch.float32


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        for i, c in enumerate((in_ch, channels)):
            self.add_module(f"conv{i}", Conv(c, channels, 3, padding=1, dtype=dtype, device=device))
            self.add_module(f"norm{i}", GroupNorm(8, channels, 1e-6, device=device))

    def forward(self, x):
        for i in range(2):
            x = F.silu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
        return x


class PersonSegmenter(nn.Module):
    """U-Net: images (B, 3, H, W) in [0, 1] -> person logits (B, H, W)."""

    def __init__(self, config: SegmenterConfig = SegmenterConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        ch, dt = cfg.base_channels, cfg.dtype
        in_ch = 3
        for d in range(cfg.depth):
            self.add_module(f"down_{d}", ConvBlock(in_ch, ch << d, dt, device=device))
            in_ch = ch << d
        self.bottleneck = ConvBlock(in_ch, ch << cfg.depth, dt, device=device)
        for d in reversed(range(cfg.depth)):
            self.add_module(f"up_{d}", ConvBlock((ch << (d + 1)) + (ch << d), ch << d, dt,
                                                 device=device))
        self.head = Conv(ch, 1, 1, dtype=dt, device=device)

    def forward(self, images):
        depth = self.config.depth
        x, skips = images, []
        for d in range(depth):
            x = getattr(self, f"down_{d}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for d in reversed(range(depth)):
            x = torch.cat([upsample_nearest2x(x), skips[d]], dim=1)
            x = getattr(self, f"up_{d}")(x)
        return self.head(x)[:, 0]


def probs_to_mask(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return (torch.sigmoid(logits) >= threshold).float()


def _resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "linear")``: a triangle filter widened by the
    scale when downsampling (antialiased), plain bilinear when upsampling."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def person_probs_canonical(
    model: PersonSegmenter,
    images: torch.Tensor,       # (B, 3, H, W) in [0, 1]
    work_res: int = 128,
) -> torch.Tensor:
    """Person probabilities (B, H, W) at the input resolution, predicted at
    the model's training scale ``work_res``² and resized back."""
    B, _, H, W = images.shape
    x = images
    if (H, W) != (work_res, work_res):
        x = _resize_linear(x, (work_res, work_res))
    probs = torch.sigmoid(model(x))
    if (H, W) != (work_res, work_res):
        probs = _resize_linear(probs[:, None], (H, W))[:, 0]
    return probs


def make_person_segment_fn(model: PersonSegmenter, work_res: int = 128,
                           threshold: float = 0.5):
    """``images (B, 3, H, W) -> (B, H, W)`` float person mask for the loop."""

    def fn(images):
        return (person_probs_canonical(model, images, work_res) >= threshold).float()

    return fn


# ----------------------------------------------------------------------
# Instance utilities (host-side, for the segment_human stage)
# ----------------------------------------------------------------------

def connected_instances(mask: np.ndarray, min_area: int = 64) -> List[Dict[str, np.ndarray]]:
    """A binary person mask split into instances by connected components
    (4-connectivity, ``scipy.ndimage.label``): ``[{'mask' (H, W) bool,
    'bbox' xyxy float32, 'area'}]`` for each component of at least
    ``min_area`` pixels; callers fill in the score."""
    from scipy import ndimage

    labeled, n = ndimage.label(mask > 0)
    out = []
    for i in range(1, n + 1):
        inst = labeled == i
        area = int(inst.sum())
        if area < min_area:
            continue
        ys, xs = np.nonzero(inst)
        bbox = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)
        out.append(dict(mask=inst, bbox=bbox, area=area))
    return out


def seg2bbox(mask: np.ndarray) -> np.ndarray:
    """Tight xyxy box of a binary mask (the reference's ``seg2bbox``)."""
    ys, xs = np.nonzero(mask)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])


def merge_bbox(bboxes: List[np.ndarray]) -> np.ndarray:
    """Union of xyxy boxes (the reference's ``merge_bbox``)."""
    if not bboxes:
        raise ValueError("merge_bbox needs at least one box")
    all_b = np.stack(bboxes, axis=0)
    return np.array([all_b[:, 0].min(), all_b[:, 1].min(), all_b[:, 2].max(), all_b[:, 3].max()])
