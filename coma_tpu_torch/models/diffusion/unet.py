"""Stable-Diffusion UNet (UNet2DConditionModel), NCHW.

Counterpart of ``coma_tpu/models/diffusion/unet.py``: the 9-channel
SD-inpainting UNet of the reference's adaptive-mask loop, SD-1.x config
(block_out_channels (320, 640, 1280, 1280), 2 layers per down block,
cross-attention dim 768, 8 heads, GEGLU feed-forwards). Submodules carry
``coma_tpu``'s Flax names, so ``models/flax_params.py`` maps its params
across. Mixed precision follows Flax (``models/layers.py``): Dense and Conv
compute in ``config.dtype``, the norms in fp32.

Attention runs through :func:`coma_tpu_torch.ops.attention.scaled_dot_attention`:
on the card, every self- and cross-attention launches kernel K3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.layers import Conv, Dense, GroupNorm, LayerNorm, upsample_nearest2x
from coma_tpu_torch.ops.attention import scaled_dot_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9           # 4 latent + 1 mask + 4 masked-image latents
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8    # SD-1.x: number of heads (naming quirk kept)
    # SD-2.x: per-block head counts; when set this overrides attention_head_dim
    heads_per_block: Optional[Tuple[int, ...]] = None
    norm_num_groups: int = 32
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    dtype: torch.dtype = torch.float32

    @property
    def num_heads(self) -> int:
        return self.attention_head_dim

    def heads_for(self, block_index: Optional[int]) -> int:
        """Head count of down/up block ``block_index`` (``None``: the mid block,
        which runs at the deepest block's count)."""
        if self.heads_per_block is None:
            return self.attention_head_dim
        return self.heads_per_block[-1 if block_index is None else block_index]


def sd2_inpaint_unet_config(dtype=torch.bfloat16) -> UNetConfig:
    """``stabilityai/stable-diffusion-2-inpainting``: cross-dim 1024, 64-wide
    heads -> (5, 10, 20, 20) per block."""
    return UNetConfig(cross_attention_dim=1024, heads_per_block=(5, 10, 20, 20), dtype=dtype)


def tiny_unet_config(dtype=torch.float32) -> UNetConfig:
    """A miniature config for tests (same topology)."""
    return UNetConfig(
        block_out_channels=(32, 64, 64, 64),
        layers_per_block=1,
        cross_attention_dim=32,
        attention_head_dim=2,
        norm_num_groups=8,
        dtype=dtype,
    )


def timestep_embedding(t: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal embedding (diffusers: flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    exponent = (-math.log(10000.0)
                * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1).to(dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, cfg: UNetConfig, device=None):
        super().__init__()
        dt, g = cfg.dtype, cfg.norm_num_groups
        self.norm1 = GroupNorm(g, in_ch, 1e-5, device=device)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dt, device=device)
        self.time_emb_proj = Dense(temb_dim, out_ch, dtype=dt, device=device)
        self.norm2 = GroupNorm(g, out_ch, 1e-5, device=device)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dt, device=device)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, dtype=dt, device=device)
                              if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, cfg: UNetConfig,
                 context_dim: Optional[int] = None, device=None):
        super().__init__()
        dt, inner = cfg.dtype, query_dim
        ctx = context_dim or query_dim
        self.heads = heads
        self.to_q = Dense(query_dim, inner, use_bias=False, dtype=dt, device=device)
        self.to_k = Dense(ctx, inner, use_bias=False, dtype=dt, device=device)
        self.to_v = Dense(ctx, inner, use_bias=False, dtype=dt, device=device)
        self.to_out = Dense(inner, inner, dtype=dt, device=device)

    def forward(self, x, context=None):  # (B, L, C)
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        B, Lq, inner = q.shape
        Lk = k.shape[1]
        hd = inner // self.heads
        split = lambda a, L: a.reshape(B, L, self.heads, hd).transpose(1, 2)
        out = scaled_dot_attention(split(q, Lq), split(k, Lk), split(v, Lk))
        return self.to_out(out.transpose(1, 2).reshape(B, Lq, inner))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.proj_in = Dense(dim, dim * 8, dtype=cfg.dtype, device=device)
        self.proj_out = Dense(dim * 4, dim, dtype=cfg.dtype, device=device)

    def forward(self, x):
        a, b = self.proj_in(x).chunk(2, dim=-1)
        # exact (erf) GELU, as diffusers' GEGLU
        return self.proj_out(a * F.gelu(b))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5, device=device)
        self.attn1 = Attention(dim, heads, cfg, device=device)
        self.norm2 = LayerNorm(dim, 1e-5, device=device)
        self.attn2 = Attention(dim, heads, cfg, cfg.cross_attention_dim, device=device)
        self.norm3 = LayerNorm(dim, 1e-5, device=device)
        self.ff = GEGLUFeedForward(dim, cfg, device=device)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, block: Optional[int] = None,
                 device=None):
        super().__init__()
        self.norm = GroupNorm(cfg.norm_num_groups, channels, 1e-6, device=device)
        self.proj_in = Conv(channels, channels, 1, dtype=cfg.dtype, device=device)
        self.block0 = TransformerBlock(channels, cfg.heads_for(block), cfg, device=device)
        self.proj_out = Conv(channels, channels, 1, dtype=cfg.dtype, device=device)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.block0(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1, dtype=cfg.dtype,
                         device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=cfg.dtype, device=device)

    def forward(self, x):
        return self.conv(upsample_nearest2x(x))


class UNet2DCondition(nn.Module):
    """Latents (B, in_channels, h, w), timesteps (B,), context (B, L, C) ->
    eps (B, 4, h, w) in ``config.dtype``."""

    def __init__(self, config: UNetConfig = UNetConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        chs = cfg.block_out_channels
        ch0, temb_dim = chs[0], chs[0] * 4
        dt = cfg.dtype
        self.time_embed_0 = Dense(ch0, temb_dim, dtype=dt, device=device)
        self.time_embed_2 = Dense(temb_dim, temb_dim, dtype=dt, device=device)
        self.conv_in = Conv(cfg.in_channels, ch0, 3, padding=1, dtype=dt, device=device)

        skip_chs, ch = [ch0], ch0
        for i, out in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}",
                                ResnetBlock(ch, out, temb_dim, cfg, device=device))
                ch = out
                if cfg.cross_attn_blocks[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    SpatialTransformer(ch, cfg, block=i, device=device))
                skip_chs.append(ch)
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch, cfg, device=device))
                skip_chs.append(ch)

        self.mid_res_0 = ResnetBlock(ch, chs[-1], temb_dim, cfg, device=device)
        self.mid_attn = SpatialTransformer(chs[-1], cfg, device=device)
        self.mid_res_1 = ResnetBlock(chs[-1], chs[-1], temb_dim, cfg, device=device)
        ch = chs[-1]

        for i, out in list(enumerate(chs))[::-1]:
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(
                    ch + skip_chs.pop(), out, temb_dim, cfg, device=device))
                ch = out
                if cfg.cross_attn_blocks[i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    SpatialTransformer(ch, cfg, block=i, device=device))
            if i > 0:
                self.add_module(f"up_{i}_upsample", Upsample(ch, cfg, device=device))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch, 1e-5, device=device)
        self.conv_out = Conv(ch, cfg.out_channels, 3, padding=1, dtype=dt, device=device)

    def forward(self, sample, timesteps, context):
        cfg = self.config
        chs = cfg.block_out_channels
        temb = timestep_embedding(timesteps, chs[0], cfg.dtype)
        temb = self.time_embed_2(F.silu(self.time_embed_0(temb)))

        h = self.conv_in(sample)
        skips = [h]
        for i in range(len(chs)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.cross_attn_blocks[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i < len(chs) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)

        for i in reversed(range(len(chs))):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if cfg.cross_attn_blocks[i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i > 0:
                h = getattr(self, f"up_{i}_upsample")(h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))
