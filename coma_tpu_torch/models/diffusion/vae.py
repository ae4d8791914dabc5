"""AutoencoderKL (the SD VAE), NCHW.

Counterpart of ``coma_tpu/models/diffusion/vae.py``: the VAE of the
adaptive-mask loop — the initial mask-latent encode, the 21 in-loop decodes
of x̂0 and re-encodes, and the final decode. SD-1.x config: 4 latent
channels, block_out_channels (128, 256, 512, 512), 2 layers per block,
one-head mid-block self-attention (K3 on the card, D = 512), scaling factor
0.18215. Submodules carry ``coma_tpu``'s Flax names.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.layers import Conv, Dense, GroupNorm, upsample_nearest2x
from coma_tpu_torch.ops.attention import scaled_dot_attention

SD_VAE_SCALING = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SD_VAE_SCALING
    dtype: torch.dtype = torch.float32


def tiny_vae_config(dtype=torch.float32) -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                     norm_num_groups=8, dtype=dtype)


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: VAEConfig, device=None):
        super().__init__()
        dt, g = cfg.dtype, cfg.norm_num_groups
        self.norm1 = GroupNorm(g, in_ch, 1e-6, device=device)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dt, device=device)
        self.norm2 = GroupNorm(g, out_ch, 1e-6, device=device)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dt, device=device)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, dtype=dt, device=device)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, cfg: VAEConfig, device=None):
        super().__init__()
        dt, C = cfg.dtype, channels
        self.group_norm = GroupNorm(cfg.norm_num_groups, C, 1e-6, device=device)
        self.to_q = Dense(C, C, dtype=dt, device=device)
        self.to_k = Dense(C, C, dtype=dt, device=device)
        self.to_v = Dense(C, C, dtype=dt, device=device)
        self.to_out = Dense(C, C, dtype=dt, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = (p(h)[:, None] for p in (self.to_q, self.to_k, self.to_v))  # 1 head
        out = self.to_out(scaled_dot_attention(q, k, v)[:, 0])
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    """Images (B, 3, H, W) in [-1, 1] -> moments (B, 8, H/8, W/8), mean ‖ logvar."""

    def __init__(self, config: VAEConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, chs = cfg.dtype, cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, chs[0], 3, padding=1, dtype=dt, device=device)
        ch = chs[0]
        for i, out in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", VAEResnet(ch, out, cfg, device=device))
                ch = out
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv(ch, ch, 3, stride=2, dtype=dt, device=device))
        self.mid_res_0 = VAEResnet(ch, ch, cfg, device=device)
        self.mid_attn = VAEAttention(ch, cfg, device=device)
        self.mid_res_1 = VAEResnet(ch, ch, cfg, device=device)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch, 1e-6, device=device)
        lat2 = 2 * cfg.latent_channels
        self.conv_out = Conv(ch, lat2, 3, padding=1, dtype=dt, device=device)
        self.quant_conv = Conv(lat2, lat2, 1, dtype=dt, device=device)

    def forward(self, x):
        cfg = self.config
        h = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(cfg.block_out_channels) - 1:
                # diffusers' downsampler: asymmetric (0, 1) pad, then a valid stride-2 conv
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(h)


class Decoder(nn.Module):
    """Unscaled latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in about [-1, 1]."""

    def __init__(self, config: VAEConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, chs = cfg.dtype, cfg.block_out_channels
        lat = cfg.latent_channels
        self.post_quant_conv = Conv(lat, lat, 1, dtype=dt, device=device)
        ch = chs[-1]
        self.conv_in = Conv(lat, ch, 3, padding=1, dtype=dt, device=device)
        self.mid_res_0 = VAEResnet(ch, ch, cfg, device=device)
        self.mid_attn = VAEAttention(ch, cfg, device=device)
        self.mid_res_1 = VAEResnet(ch, ch, cfg, device=device)
        for i, out in list(enumerate(chs))[::-1]:
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", VAEResnet(ch, out, cfg, device=device))
                ch = out
            if i > 0:
                self.add_module(f"up_{i}_upsample",
                                Conv(ch, ch, 3, padding=1, dtype=dt, device=device))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch, 1e-6, device=device)
        self.conv_out = Conv(ch, cfg.in_channels, 3, padding=1, dtype=dt, device=device)

    def forward(self, z):
        cfg = self.config
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for i in reversed(range(len(cfg.block_out_channels))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i > 0:
                h = getattr(self, f"up_{i}_upsample")(upsample_nearest2x(h))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def sample_latents(moments: torch.Tensor, noise: torch.Tensor, scaling: float) -> torch.Tensor:
    """DiagonalGaussian sample from encoder moments (B, 2c, h, w), scaled.
    ``noise`` is the standard-normal draw, (B, c, h, w)."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return (mean + std * noise.to(mean.dtype)) * scaling
