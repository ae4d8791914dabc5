"""The in-loop person segmenter.

Counterpart of ``coma_tpu/models/segmentation.py:29-114``: a U-Net
person-vs-background segmenter, run at its training scale (128²) and
resized back, thresholded into the person mask that the adaptive-mask loop
dilates. The committed checkpoint ``coma_tpu/data/person_segmenter.npz``
loads into it through ``models/flax_params.py``. The host-side instance
utilities come with the ``segment_human`` stage.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.layers import Conv, GroupNorm, upsample_nearest2x


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
