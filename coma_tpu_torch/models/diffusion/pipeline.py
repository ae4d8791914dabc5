"""Adaptive-mask inpainting pipeline, the flagship loop of 2D HOI generation.

Counterpart of ``coma_tpu/models/diffusion/pipeline.py``: a 9-channel
SD-inpaint denoise loop under classifier-free guidance that, at the
provoke-scheduled steps, decodes the predicted x̂0, segments the emerging
person, dilates the mask by a step-scheduled count, intersects it with the
default mask (falling back to the default mask when the person is too
small), and re-encodes the masked image latents mid-loop.

``coma_tpu`` compiles the 50 steps into one ``lax.scan``; here they are a
Python loop over eager PyTorch calls, and a provoke step is taken or skipped
on the host. Layout is NCHW: images (B, 3, H, W), masks (B, H, W), latents
(B, 4, h, w). The full-frame path, ``provoke_decode_factor`` and the provoke
crop (``provoke_crop_latent``: decode, segment and re-encode only a window
around each image's default-mask box; its offsets are chosen on the host)
are ported; the per-step intermediates are not yet.

Randomness comes from one noise source (:class:`TorchNoise` by default): the
initial latents, the default-mask encode, and one draw per provoke step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from coma_tpu_torch.models.diffusion.ddim import (
    DDIMSchedule,
    add_noise,
    ddim_step_traced,
    inpaint_timesteps,
    make_ddim_schedule,
)
from coma_tpu_torch.models.diffusion.vae import sample_latents


def default_dilate_schedule(num_inference_steps: int = 50) -> List[int]:
    """[20]*5 + [10]*5 + [5]*5 + [4]*5 + [3]*5 + [2]*5 + [1]*5 + [0]*15 at 50 steps."""
    step_num = int(num_inference_steps * 0.1)
    final = num_inference_steps - step_num * 7
    sched = []
    for v in (20, 10, 5, 4, 3, 2, 1):
        sched += [v] * step_num
    return sched + [0] * final


def default_provoke_schedule(num_inference_steps: int = 50) -> List[int]:
    """1-indexed steps that adapt the mask: {2,4,...,10, 12,14,...,40, 45}."""
    assert num_inference_steps == 50, "reference schedule is for 50 steps"
    return list(range(2, 11, 2)) + list(range(12, 41, 2)) + [45]


@dataclasses.dataclass(frozen=True)
class AdaptiveMaskConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    strength: float = 1.0
    human_detection_thres: float = 0.008
    enforce_full_mask_ratio: float = 0.0
    vae_scale: int = 8
    use_adaptive_mask: bool = True
    # decode x̂0 at 1/f resolution in the provoke steps (f=1: the reference)
    provoke_decode_factor: int = 1
    # provoke rounds on a (c, c)-latent window around each image's
    # default-mask box (0: the full frame). Outside the default mask the
    # adapted mask is discarded by the AND anyway; the window's re-encoded
    # masked latents are pasted into the step-0 encode. Two approximations,
    # as in coma_tpu: the VAE's mid-block attention couples the whole frame,
    # so cropped decodes and encodes differ from full-frame ones (the masks
    # agree), and the too-small test counts person pixels inside the window
    # only, against the full frame's threshold. Pick c with
    # :func:`choose_crop_latent`.
    provoke_crop_latent: int = 0

    def dilate_schedule(self) -> List[int]:
        return default_dilate_schedule(self.num_inference_steps)

    def provoke_flags(self) -> np.ndarray:
        """Per-step booleans (0-indexed)."""
        flags = np.zeros(self.num_inference_steps, dtype=bool)
        if self.use_adaptive_mask:
            for one_indexed in default_provoke_schedule(self.num_inference_steps):
                flags[one_indexed - 1] = True
        return flags


def mask_bbox_center(mask: np.ndarray) -> np.ndarray:
    """(H, W) binary mask -> (cy, cx) int32 box centre (the frame's centre
    when the mask is empty)."""
    H, W = mask.shape

    def axis_center(any_line: np.ndarray, n: int) -> int:
        idx = np.flatnonzero(any_line)
        return (int(idx[0]) + int(idx[-1]) + 1) // 2 if len(idx) else n // 2

    m = np.asarray(mask) > 0
    return np.array([axis_center(m.any(axis=1), H), axis_center(m.any(axis=0), W)], np.int32)


def crop_offsets(default_mask, crop_lat: int, vae_scale: int) -> np.ndarray:
    """(B, 2) int32 latent offsets of a (crop_lat, crop_lat) window centred
    on each image's default-mask box, clamped inside the frame. Host-side:
    ``default_mask`` (B, H, W) is a numpy array or a tensor."""
    m = default_mask.cpu().numpy() if isinstance(default_mask, torch.Tensor) else default_mask
    B, H, W = m.shape
    h, w = H // vae_scale, W // vae_scale
    out = np.zeros((B, 2), np.int32)
    for b in range(B):
        cy, cx = mask_bbox_center(m[b])
        out[b] = (np.clip(cy // vae_scale - crop_lat // 2, 0, h - crop_lat),
                  np.clip(cx // vae_scale - crop_lat // 2, 0, w - crop_lat))
    return out


def choose_crop_latent(
    default_masks: np.ndarray,
    vae_scale: int = 8,
    halo: int = 6,
    buckets: Tuple[int, ...] = (24, 32, 40, 48, 56),
    max_area_ratio: float = 0.75,
) -> int:
    """The smallest bucket covering every image's default-mask box plus
    ``halo`` latent pixels on each side, or 0 (no crop) when none fits or
    the fitting window covers more than ``max_area_ratio`` of the latent
    area (a near-full-frame crop saves little and keeps the approximation;
    pass 1.0 to validate an explicit choice)."""
    m = np.asarray(default_masks) > 0
    if m.ndim == 2:
        m = m[None]
    need = 0
    for i in range(m.shape[0]):
        ys, xs = np.any(m[i], axis=1), np.any(m[i], axis=0)
        if not ys.any():
            continue
        yext = int(ys.argmax() + ys[::-1].argmax())
        xext = int(xs.argmax() + xs[::-1].argmax())
        ext = max(m.shape[1] - yext, m.shape[2] - xext)
        need = max(need, -(-ext // vae_scale) + 2 * halo)
    lat_side = min(m.shape[1], m.shape[2]) // vae_scale
    for b in buckets:
        if need <= b < lat_side:
            return 0 if (b / lat_side) ** 2 > max_area_ratio else b
    return 0


def dilate_mask(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Binary dilation of (B, H, W) with a 3x3 ones kernel, ``iterations``
    times (3x3 max-pools; the border does not grow past the frame)."""
    m = mask[:, None]
    for _ in range(int(iterations)):
        m = F.max_pool2d(m, 3, stride=1, padding=1)
    return m[:, 0]


def binarize_mask(mask: torch.Tensor) -> torch.Tensor:
    """mask < 0.5 -> 0, else 1."""
    return (mask >= 0.5).to(mask.dtype)


def resize_nearest(mask: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W) -> (B, *size), ``jax.image.resize(..., "nearest")``."""
    return F.interpolate(mask[:, None], size=tuple(size), mode="nearest-exact")[:, 0]


def downsample_mask(mask: torch.Tensor, vae_scale: int) -> torch.Tensor:
    """(B, H, W) -> (B, 1, H/8, W/8), nearest."""
    B, H, W = mask.shape
    return resize_nearest(mask, (H // vae_scale, W // vae_scale))[:, None]


class TorchNoise:
    """Standard-normal draws from one seeded :class:`torch.Generator`, in the
    loop's order: initial latents, default-mask encode, provoke steps."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device)

    def latents(self, shape) -> torch.Tensor:
        return self._draw(shape)

    def mask_encode(self, shape) -> torch.Tensor:
        return self._draw(shape)

    def adapt(self, step: int, shape) -> torch.Tensor:
        return self._draw(shape)


class AdaptiveMaskInpaintPipeline:
    """Pass the model functions and call :meth:`generate`.

    unet_fn: (latents (2B, 9, h, w), timesteps (2B,), context (2B, L, C)) -> eps (2B, 4, h, w)
    vae_encode_fn: images (B, 3, H, W) in [-1, 1] -> moments (B, 8, h, w)
    vae_decode_fn: UNSCALED latents (B, 4, h, w) -> images (B, 3, H, W) in about [-1, 1]
    segment_fn: images (B, 3, H, W) in [0, 1] -> person masks (B, H, W) in {0, 1};
        None disables adaptation (the reference's 'baseline' mode)
    """

    def __init__(
        self,
        unet_fn: Callable,
        vae_encode_fn: Callable,
        vae_decode_fn: Callable,
        segment_fn: Optional[Callable],
        config: AdaptiveMaskConfig = AdaptiveMaskConfig(),
        vae_scaling: float = 0.18215,
    ):
        self.unet_fn = unet_fn
        self.vae_encode_fn = vae_encode_fn
        self.vae_decode_fn = vae_decode_fn
        self.segment_fn = segment_fn
        self.config = config
        self.vae_scaling = vae_scaling
        self.schedule: DDIMSchedule = make_ddim_schedule(config.num_inference_steps)

    def _encode_image(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return sample_latents(self.vae_encode_fn(images), noise, self.vae_scaling)

    def _mask_latents(self, mask, init_image, noise) -> Tuple[torch.Tensor, torch.Tensor]:
        """mask (B, H, W) + init image -> (mask latent (B, 1, h, w), masked-image
        latents (B, 4, h, w))."""
        mask = binarize_mask(mask)
        masked_image = init_image * (mask[:, None] < 0.5)
        return (downsample_mask(mask, self.config.vae_scale),
                self._encode_image(masked_image, noise))

    def unet_eps(self, latents, mask_lat, masked_lat, t: float, context) -> torch.Tensor:
        """Guided eps: the unconditional and conditional halves in one UNet call."""
        B = latents.shape[0]
        lat_in = torch.cat([latents] * 2, dim=0)
        extra = torch.cat([torch.cat([mask_lat, masked_lat], dim=1)] * 2, dim=0)
        lat_in = torch.cat([lat_in, extra], dim=1)
        t_in = torch.full((2 * B,), t, dtype=torch.float32, device=latents.device)
        eps_uncond, eps_text = self.unet_fn(lat_in, t_in, context).chunk(2, dim=0)
        return eps_uncond + self.config.guidance_scale * (eps_text - eps_uncond)

    def adapt(self, pred_x0, default_mask, init_image, dilate: int, use_default: bool,
              noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode x̂0, segment, dilate ∧ default mask, re-encode."""
        cfg = self.config
        B, _, H, W = init_image.shape
        f = max(1, int(cfg.provoke_decode_factor))
        if f > 1:
            x0 = F.avg_pool2d(pred_x0, f)
            Hs, Ws = H // f, W // f
            dmask = resize_nearest(default_mask, (Hs, Ws))
            dilate = (dilate + f - 1) // f
        else:
            x0, dmask, Hs, Ws = pred_x0, default_mask, H, W
        image = torch.clamp(self.vae_decode_fn(x0 / self.vae_scaling) / 2 + 0.5, 0, 1)
        human = self.segment_fn(image).to(init_image.dtype)      # (B, Hs, Ws)
        adapted = ((dilate_mask(human, dilate) > 0) & (dmask > 0)).to(human.dtype)
        if f > 1:
            adapted = resize_nearest(adapted, (H, W))
        # fall back to the default mask when the detected person is tiny or
        # the timestep forces the full mask
        too_small = human.sum(dim=(1, 2)) < Hs * Ws * cfg.human_detection_thres
        fallback = too_small | use_default
        mask = torch.where(fallback[:, None, None], default_mask, adapted)
        return self._mask_latents(mask, init_image, noise)

    def adapt_cropped(self, pred_x0, default_mask, init_crops, base_masked_lat, offs,
                      dilate: int, use_default: bool, noise: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The provoke round on each image's (c, c)-latent window at
        ``offs``: decode, segment, dilate ∧ default mask, then re-encode the
        masked window into the step-0 encode ``base_masked_lat``."""
        cfg = self.config
        B, H, W = default_mask.shape
        s = cfg.vae_scale
        c = init_crops.shape[-1] // s
        lat = lambda a, b: a[b, :, offs[b][0]:offs[b][0] + c, offs[b][1]:offs[b][1] + c]
        pix = lambda a, b: a[b, offs[b][0] * s:(offs[b][0] + c) * s,
                             offs[b][1] * s:(offs[b][1] + c) * s]
        x0_c = torch.stack([lat(pred_x0, b) for b in range(B)])
        image_c = torch.clamp(self.vae_decode_fn(x0_c / self.vae_scaling) / 2 + 0.5, 0, 1)
        human_c = self.segment_fn(image_c).to(default_mask.dtype)   # (B, c·s, c·s)
        dmask_c = torch.stack([pix(default_mask, b) for b in range(B)])
        adapted_c = ((dilate_mask(human_c, dilate) > 0) & (dmask_c > 0)).to(human_c.dtype)
        # the reference's area test (1130-1132) keeps the full frame's denominator
        too_small = human_c.sum(dim=(1, 2)) < H * W * cfg.human_detection_thres
        fallback = (too_small | use_default)[:, None, None]
        mask_c = torch.where(fallback, dmask_c, adapted_c)
        pasted = torch.zeros_like(default_mask)
        for b in range(B):
            pix(pasted, b).copy_(adapted_c[b])
        mask_lat = downsample_mask(binarize_mask(torch.where(fallback, default_mask, pasted)),
                                   s)
        masked_c = init_crops * (binarize_mask(mask_c)[:, None] < 0.5)
        lat_c = self._encode_image(masked_c, noise)
        masked_lat = base_masked_lat.clone()
        for b in range(B):
            lat(masked_lat, b).copy_(lat_c[b])
        return mask_lat, masked_lat

    @torch.no_grad()
    def generate(
        self,
        init_image: torch.Tensor,       # (B, 3, H, W) in [-1, 1]
        default_mask: torch.Tensor,     # (B, H, W) in {0, 1}
        prompt_embeds: torch.Tensor,    # (B, L, C) conditional
        negative_embeds: torch.Tensor,  # (B, L, C) unconditional
        noise=None,
    ) -> torch.Tensor:
        """Run the adaptive-mask inpainting; returns images (B, 3, H, W) in [0, 1].

        ``noise`` is the noise source (see :class:`TorchNoise`); by default a
        :class:`TorchNoise` over a generator on the images' device seeded with 0.
        """
        cfg = self.config
        B, _, H, W = init_image.shape
        h, w = H // cfg.vae_scale, W // cfg.vae_scale
        if noise is None:
            noise = TorchNoise(torch.Generator(init_image.device).manual_seed(0))

        timesteps, _ = inpaint_timesteps(self.schedule, cfg.strength)
        n_steps = len(timesteps)
        dilate = cfg.dilate_schedule()[:n_steps]
        provoke = cfg.provoke_flags()[:n_steps]
        use_default = (np.asarray(timesteps)
                       < self.schedule.num_train_timesteps * cfg.enforce_full_mask_ratio)
        default_mask = binarize_mask(default_mask)

        # the draws may come from another device (a CPU generator, a replay)
        draw = lambda t: t.to(device=init_image.device, dtype=init_image.dtype)
        lat_noise = draw(noise.latents((B, 4, h, w)))
        if cfg.strength >= 1.0:
            latents = lat_noise * self.schedule.init_noise_sigma
        else:
            # coma_tpu samples the image latents with the same draw
            image_latents = self._encode_image(init_image, lat_noise)
            latents = add_noise(self.schedule, image_latents, lat_noise, int(timesteps[0]))
        mask_lat, masked_lat = self._mask_latents(default_mask, init_image,
                                                  draw(noise.mask_encode((B, 4, h, w))))
        context = torch.cat([negative_embeds, prompt_embeds], dim=0)
        adaptive = self.segment_fn is not None and cfg.use_adaptive_mask

        c = int(cfg.provoke_crop_latent)
        use_crop = 0 < c < min(h, w)
        if use_crop and cfg.provoke_decode_factor > 1:
            raise ValueError("provoke_crop_latent and provoke_decode_factor > 1 are "
                             "alternative provoke-round accelerators; set one")
        if use_crop and adaptive:
            offs = crop_offsets(default_mask, c, cfg.vae_scale).tolist()
            Cp = c * cfg.vae_scale
            init_crops = torch.stack([
                init_image[b, :, oy * cfg.vae_scale:oy * cfg.vae_scale + Cp,
                           ox * cfg.vae_scale:ox * cfg.vae_scale + Cp]
                for b, (oy, ox) in enumerate(offs)])
            base_masked_lat = masked_lat      # the step-0 (default-mask) encode

        for i in range(n_steps):
            eps = self.unet_eps(latents, mask_lat, masked_lat, float(timesteps[i]), context)
            latents, pred_x0 = ddim_step_traced(self.schedule, i, eps, latents)
            if adaptive and provoke[i] and use_crop:
                mask_lat, masked_lat = self.adapt_cropped(
                    pred_x0, default_mask, init_crops, base_masked_lat, offs, dilate[i],
                    bool(use_default[i]), draw(noise.adapt(i, (B, 4, c, c))))
            elif adaptive and provoke[i]:
                mask_lat, masked_lat = self.adapt(
                    pred_x0, default_mask, init_image, dilate[i], bool(use_default[i]),
                    draw(noise.adapt(i, (B, 4, h, w))))

        image = self.vae_decode_fn(latents / self.vae_scaling)
        return torch.clamp(image / 2 + 0.5, 0.0, 1.0)
