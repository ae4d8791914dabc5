"""Per-step adaptive-mask inpainting video (the reference's
``utils/visualization/visualize_video.py``).

Counterpart of ``coma_tpu/visualization/video.py``: the frames are composed
from the loop's per-step outputs (``AdaptiveMaskInpaintPipeline.generate(
..., return_intermediates=True)``) and written as an animated GIF with the
port's numpy encoder (``utils/gif.py``; the card machine has no PIL and no
ffmpeg). Usage::

    images, inter = pipe.generate(img, mask, ctx, neg, return_intermediates=True)
    write_adaptive_mask_video(inter, pipe.vae_decode_fn, "steps.gif", sample=0)
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from coma_tpu_torch.utils.gif import write_gif


def _to_uint8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)


@torch.no_grad()
def compose_step_frames(intermediates, vae_decode_fn: Callable, vae_scaling: float = 0.18215,
                        sample: int = 0, every: int = 1) -> np.ndarray:
    """Per-step outputs ``mask_lat`` (S, B, 1, h, w) and ``pred_x0`` (S, B, 4,
    h, w) -> (S', H, 2W, 3) uint8 frames of every ``every``-th step: the
    decoded x̂0 on the left, the adaptive mask (nearest-upsampled) on the
    right. ``vae_decode_fn`` maps (N, 4, h, w) latents to (N, 3, H, W)."""
    steps = list(range(0, intermediates["pred_x0"].shape[0], every))
    pred_x0 = intermediates["pred_x0"][steps, sample]                   # (S', 4, h, w)
    decoded = torch.clamp(vae_decode_fn(pred_x0 / vae_scaling) / 2 + 0.5, 0, 1).float()
    H, W = decoded.shape[-2:]
    masks = intermediates["mask_lat"][steps, sample].float()             # (S', 1, h, w)
    masks = F.interpolate(masks, size=(H, W), mode="nearest-exact")
    panel = torch.cat([decoded, masks.expand(-1, 3, -1, -1).to(decoded.device)], dim=-1)
    return _to_uint8(panel.permute(0, 2, 3, 1).cpu().numpy())


def write_adaptive_mask_video(intermediates, vae_decode_fn: Callable, out_path: str,
                              vae_scaling: float = 0.18215, sample: int = 0, every: int = 1,
                              fps: int = 8) -> np.ndarray:
    """Compose and write the GIF; returns the frames."""
    frames = compose_step_frames(intermediates, vae_decode_fn, vae_scaling, sample, every)
    write_gif(frames, out_path, fps)
    return frames
