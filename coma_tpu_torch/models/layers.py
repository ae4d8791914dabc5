"""Layers with Flax's mixed-precision semantics, and Flax's initializers.

``flax.linen.Dense`` and ``Conv`` with ``dtype=bf16`` keep fp32 parameters
and cast their input and parameters to bf16 for the product; ``GroupNorm``
and ``LayerNorm`` without a ``dtype`` compute in, and return, fp32. The
layers here do the same, so a model built from them rounds at the same
points as its ``coma_tpu`` counterpart. Parameter names follow PyTorch
(``weight`` (out, in[, kh, kw]), ``bias``); ``models/flax_params.py`` maps
Flax's names and layouts onto them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if use_bias else None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class GroupNorm(nn.Module):
    """Returns fp32 whatever the input dtype (Flax ``GroupNorm`` without ``dtype``)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    """Over the last axis; returns fp32 (Flax ``LayerNorm`` without ``dtype``)."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features, device=device))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), ``jax.image.resize(..., "nearest")``."""
    return F.interpolate(x, scale_factor=2, mode="nearest-exact")


# ---------------------------------------------------------------------------
# Flax's default initializers, for --random_weights runs
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_flax_default_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` as ``flax.linen``'s ``init`` would:
    Dense/Conv kernels lecun-normal (truncated), biases zero, norm scales one,
    embeddings normal with std 1/√features, ``position_embedding`` normal(0.01).
    ``torch.nn``'s Linear, Conv2d, ConvTranspose2d (fan-in over its input
    channels, as Flax's ``ConvTranspose``) and LayerNorm count as the Flax
    layers they stand for. The numbers differ from JAX's; their
    distributions do not."""
    for sub in module.modules():
        if isinstance(sub, (Dense, Conv, nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (sub.weight[:, 0].numel() if isinstance(sub, nn.ConvTranspose2d)
                      else sub.weight[0].numel())
            _lecun_normal_(sub.weight, fan_in, generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (GroupNorm, LayerNorm, nn.LayerNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, Embed):
            sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.weight.shape[1]), generator=generator)
    for name, p in module.named_parameters():
        if name.split(".")[-1] == "position_embedding":
            p.normal_(0.0, 0.01, generator=generator)
    return module
