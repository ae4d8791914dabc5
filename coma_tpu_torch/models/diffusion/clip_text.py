"""CLIP text encoder (ViT-L/14 text tower).

Counterpart of ``coma_tpu/models/diffusion/clip_text.py``: 77-token causal
transformer, 768 wide, 12 layers, quick-GELU, final layer norm. Its
attention is written inline with the causal mask, as in ``coma_tpu``; it
does not go through ``ops/attention.py``, so it runs as plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from coma_tpu_torch.models.layers import Dense, Embed, LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    # OpenAI CLIP (SD-1.x) uses quick_gelu; OpenCLIP ViT-H (SD-2.x) uses gelu
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.float32


def sd2_clip_text_config(dtype=torch.float32) -> CLIPTextConfig:
    """OpenCLIP ViT-H text tower of SD-2 inpainting: 23 layers, 1024 wide,
    16 heads, exact gelu."""
    return CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                          hidden_act="gelu", dtype=dtype)


def tiny_clip_config(dtype=torch.float32) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                          dtype=dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        C, dt = cfg.hidden_size, cfg.dtype
        self.heads = cfg.num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(C, C, dtype=dt, device=device))

    def forward(self, x, mask):
        B, L, C = x.shape
        H = self.heads
        D = C // H
        split = lambda a: a.reshape(B, L, H, D).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        probs = torch.softmax(scores + mask, dim=-1)
        out = torch.matmul(probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        C, dt = cfg.hidden_size, cfg.dtype
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else nn.functional.gelu
        self.layer_norm1 = LayerNorm(C, 1e-5, device=device)
        self.self_attn = CLIPAttention(cfg, device=device)
        self.layer_norm2 = LayerNorm(C, 1e-5, device=device)
        self.fc1 = Dense(C, 4 * C, dtype=dt, device=device)
        self.fc2 = Dense(4 * C, C, dtype=dt, device=device)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    """Token ids (B, L) -> last hidden states (B, L, hidden_size), fp32."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, device=device)
        # a parameter of config.dtype, as in coma_tpu
        self.position_embedding = nn.Parameter(torch.empty(
            cfg.max_positions, cfg.hidden_size, dtype=cfg.dtype, device=device))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg, device=device))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, 1e-5, device=device)

    def forward(self, input_ids):
        cfg = self.config
        L = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :L]
        causal = torch.triu(torch.full((L, L), torch.finfo(cfg.dtype).min, dtype=cfg.dtype,
                                       device=x.device), diagonal=1)[None, None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        return self.final_layer_norm(x)
