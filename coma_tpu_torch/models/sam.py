"""Segment Anything (SAM), box-prompted mask prediction, in PyTorch.

Counterpart of ``coma_tpu/models/sam.py`` (the reference's SAM predictors,
``utils/adaptive_mask_inpainting.py:1246-1455``, on ``sam_vit_b``):

- :class:`ImageEncoderViT`: 16x16 patch embedding, a learned absolute
  position embedding, transformer blocks with windowed attention (global at
  ``global_attn_indexes``) and decomposed relative position embeddings, and
  a two-conv neck to 256 channels. Channels last inside, as SAM's own ViT.
- :class:`PromptEncoder`: random-Fourier positional encoding; a box is two
  corner points with learned corner embeddings.
- :class:`MaskDecoder`: a two-layer two-way transformer, 4x transposed-conv
  upscaling and hypernetwork MLPs giving mask logits and IoU predictions.

Attention here is plain ``matmul`` + ``softmax`` in float32: ``coma_tpu``
computes it outside any Pallas kernel, and the ViT's logits take a
decomposed relative-position bias that the attention kernel has no input
for. At 1024² the four global blocks build a (B·12, 4096, 4096) float32
score tensor; the bias is added to it in place. LayerNorms use Flax's eps
1e-6 and GELUs are exact, as in ``coma_tpu``.

Module and parameter names follow ``coma_tpu``'s Flax tree, so
``models/flax_params.py`` loads a Flax ``.npz``;
``models/segmenter_weights.py`` loads the official ``sam_vit_b`` state dict.
Images are NCHW at the public functions; the encoder's output is (B, g, g,
256), as in ``coma_tpu``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.segmentation import _resize_linear

LN_EPS = 1e-6   # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768          # ViT-B
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_dim: int = 256
    num_multimask_outputs: int = 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def tiny_sam_config() -> SAMConfig:
    """Small config for hermetic tests (64x64 input)."""
    return SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                     num_heads=2, window_size=2, global_attn_indexes=(1,))


def sam_vit_h_config() -> SAMConfig:
    """ViT-H, the checkpoint the reference registers for every SAM key."""
    return SAMConfig(embed_dim=1280, depth=32, num_heads=16,
                     global_attn_indexes=(7, 15, 23, 31))


def _ln(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=LN_EPS)


# --------------------------------------------------------------------------
# image encoder
# --------------------------------------------------------------------------

def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative position table (2·max(q, k) - 1, C) -> (q, k, C): entry
    [i, j] is table[(i - j) + k - 1] at equal sizes (linearly resized and
    size-ratio scaled otherwise)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = _resize_linear(rel_pos.T[None, :, None, :], (1, max_rel_dist))[0, :, 0].T
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_hw, k_hw):
    """attn (B, qh·qw, kh·kw) + the axial rel-pos terms of q, added in place."""
    qh, qw = q_hw
    kh, kw = k_hw
    Rh = get_rel_pos(qh, kh, rel_pos_h)
    Rw = get_rel_pos(qw, kw, rel_pos_w)
    B = q.shape[0]
    r_q = q.reshape(B, qh, qw, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    view = attn.view(B, qh, qw, kh, kw)
    view.add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
    return attn


class ViTAttention(nn.Module):
    """Multi-head attention with decomposed relative position embeddings over
    an (H, W) token grid."""

    def __init__(self, dim: int, num_heads: int, size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        head = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head))

    def forward(self, x):                              # (B, H, W, C)
        B, H, W, C = x.shape
        nh, head = self.num_heads, C // self.num_heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, nh, head)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, H * W, head).unbind(0)
        attn = (q * (head ** -0.5)) @ k.transpose(1, 2)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = torch.softmax(attn, dim=-1)
        x = (attn @ v).reshape(B, nh, H * W, head).permute(0, 2, 1, 3).reshape(B, H, W, C)
        return self.proj(x)


def window_partition(x, window: int):
    """(B, H, W, C) -> (B·nW, win, win, C), zero-padded at the bottom/right."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(wins, window: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // ((Hp // window) * (Wp // window))
    x = wins.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 grid: int):
        super().__init__()
        self.window_size = window_size                 # 0: global attention
        self.norm1 = _ln(dim)
        self.attn = ViTAttention(dim, num_heads, window_size or grid)
        self.norm2 = _ln(dim)
        self.mlp_lin1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_lin2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        H, W = x.shape[1:3]
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        y = self.mlp_lin1(self.norm2(x))
        return x + self.mlp_lin2(F.gelu(y))


class ImageEncoderViT(nn.Module):
    def __init__(self, config: SAMConfig = SAMConfig()):
        super().__init__()
        cfg = self.config = config
        g, C = cfg.grid, cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, C, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, C))
        for i in range(cfg.depth):
            ws = 0 if i in cfg.global_attn_indexes else cfg.window_size
            self.add_module(f"block_{i}", ViTBlock(C, cfg.num_heads, cfg.mlp_ratio, ws, g))
        self.neck_conv1 = nn.Conv2d(C, cfg.prompt_dim, 1, bias=False)
        self.neck_ln1 = _ln(cfg.prompt_dim)
        self.neck_conv2 = nn.Conv2d(cfg.prompt_dim, cfg.prompt_dim, 3, padding=1, bias=False)
        self.neck_ln2 = _ln(cfg.prompt_dim)

    def forward(self, x):                              # (B, 3, S, S) normalized
        x = self.patch_embed(x).permute(0, 2, 3, 1) + self.pos_embed      # (B, g, g, C)
        for i in range(self.config.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.neck_conv1(x.permute(0, 3, 1, 2))
        x = self.neck_ln1(x.permute(0, 2, 3, 1))
        x = self.neck_conv2(x.permute(0, 3, 1, 2))
        return self.neck_ln2(x.permute(0, 2, 3, 1))       # (B, g, g, 256)


# --------------------------------------------------------------------------
# prompt encoder
# --------------------------------------------------------------------------

class PromptEncoder(nn.Module):
    """Box prompts only (the reference predictors prompt SAM with boxes)."""

    def __init__(self, config: SAMConfig = SAMConfig()):
        super().__init__()
        self.config = config
        d = config.prompt_dim
        self.pe_gaussian = nn.Parameter(torch.zeros(2, d // 2))
        self.point_embed = nn.Parameter(torch.zeros(4, d))    # 2/3: box corners
        self.no_mask_embed = nn.Parameter(torch.zeros(d))

    def _pe(self, coords01):
        c = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ self.pe_gaussian)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense_pe(self):
        g = self.config.grid
        c = (torch.arange(g, dtype=torch.float32, device=self.pe_gaussian.device) + 0.5) / g
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        return self._pe(torch.stack([gx, gy], dim=-1))                    # (g, g, d)

    def forward(self, boxes):                           # (B, 4) xyxy in input pixels
        cfg = self.config
        B = boxes.shape[0]
        corners = (boxes.reshape(B, 2, 2) + 0.5) / cfg.img_size
        sparse = self._pe(corners) + self.point_embed[2:4][None]
        dense = self.no_mask_embed.expand(B, cfg.grid, cfg.grid, cfg.prompt_dim)
        return sparse, dense, self.dense_pe()


# --------------------------------------------------------------------------
# mask decoder (two-way transformer)
# --------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        d = self.q_proj.out_features
        head = d // self.num_heads

        def split(x):
            B, L, _ = x.shape
            return x.reshape(B, L, self.num_heads, head).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = torch.softmax(qh @ kh.transpose(2, 3) / math.sqrt(head), dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(q.shape[0], q.shape[1], d)
        return self.out_proj(out)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, skip_first_layer_pe: bool = False,
                 mlp_dim: int = 2048):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, num_heads)
        self.cross_attn_t2i = DecoderAttention(dim, num_heads, 2)
        self.cross_attn_i2t = DecoderAttention(dim, num_heads, 2)
        for n in range(1, 5):
            self.add_module(f"norm{n}", _ln(dim))
        self.mlp_lin1 = nn.Linear(dim, mlp_dim)
        self.mlp_lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_t2i(q, k, keys))
        queries = queries + self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries)
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_i2t(k, q, queries))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, depth: int = 3):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"lin{i}", nn.Linear(dim if i == 0 else hidden,
                                                 out if i == depth - 1 else hidden))

    def forward(self, x):
        for i in range(self.depth - 1):
            x = F.relu(getattr(self, f"lin{i}")(x))
        return getattr(self, f"lin{self.depth - 1}")(x)


class MaskDecoder(nn.Module):
    def __init__(self, config: SAMConfig = SAMConfig()):
        super().__init__()
        self.config = config
        d = config.prompt_dim
        n_masks = config.num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, d))
        self.mask_tokens = nn.Parameter(torch.zeros(n_masks, d))
        for i in range(2):
            self.add_module(f"layer_{i}", TwoWayBlock(d, 8, skip_first_layer_pe=i == 0))
        self.final_attn = DecoderAttention(d, 8, 2)
        self.norm_final = _ln(d)
        self.upscale1 = nn.ConvTranspose2d(d, d // 4, 2, 2)
        self.upscale_ln = _ln(d // 4)
        self.upscale2 = nn.ConvTranspose2d(d // 4, d // 8, 2, 2)
        for i in range(n_masks):
            self.add_module(f"hyper_{i}", MLP(d, d, d // 8))
        self.iou_head = MLP(d, d, n_masks)

    def forward(self, image_embed, dense_pe, sparse_prompt, dense_prompt):
        """image_embed (B, g, g, d) -> masks (B, M+1, 4g, 4g), iou (B, M+1);
        slot 0 is the single-mask output."""
        d = self.config.prompt_dim
        n_masks = self.mask_tokens.shape[0]
        B, g = image_embed.shape[:2]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens.expand((B,) + out_tokens.shape), sparse_prompt], dim=1)
        src = (image_embed + dense_prompt).reshape(B, g * g, d)
        pos = dense_pe.reshape(1, g * g, d).expand(B, g * g, d)
        queries, keys = tokens, src
        for i in range(2):
            queries, keys = getattr(self, f"layer_{i}")(queries, keys, tokens, pos)
        q, k = queries + tokens, keys + pos
        queries = self.norm_final(queries + self.final_attn(q, k, keys))
        iou_out, mask_out = queries[:, 0], queries[:, 1:1 + n_masks]

        up = self.upscale1(keys.reshape(B, g, g, d).permute(0, 3, 1, 2))
        up = F.gelu(self.upscale_ln(up.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        up = F.gelu(self.upscale2(up))                                    # (B, d/8, 4g, 4g)
        hyper = torch.stack([getattr(self, f"hyper_{i}")(mask_out[:, i]) for i in range(n_masks)],
                            dim=1)                                       # (B, n, d/8)
        masks = torch.einsum("bnc,bchw->bnhw", hyper, up)
        return masks, self.iou_head(iou_out)


# --------------------------------------------------------------------------
# full predict path
# --------------------------------------------------------------------------

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SAM(nn.Module):
    def __init__(self, config: SAMConfig = SAMConfig()):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoderViT(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)

    def forward(self, image, boxes):
        """image (B, 3, S, S), mean/std-normalized; boxes (B, 4) xyxy in input
        pixels -> (mask logits (B, S/4, S/4) of the single-mask slot, iou (B,))."""
        embed = self.image_encoder(image)
        sparse, dense, dense_pe = self.prompt_encoder(boxes)
        masks, iou = self.mask_decoder(embed, dense_pe, sparse, dense)
        return masks[:, 0], iou[:, 0]


def _normalize(x255: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 255] -> SAM's mean/std normalization."""
    mean = torch.as_tensor(SAM_PIXEL_MEAN, device=x255.device)[:, None, None]
    std = torch.as_tensor(SAM_PIXEL_STD, device=x255.device)[:, None, None]
    return (x255 - mean) / std


def preprocess_image(image_uint8: np.ndarray, img_size: int = 1024, device=None) -> torch.Tensor:
    """(H, W, 3) uint8 -> (1, 3, S, S) normalized: longest side resized to
    ``img_size``, zero-padded to a square (ResizeLongestSide + pad)."""
    h, w = image_uint8.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = torch.as_tensor(np.asarray(image_uint8, np.float32), device=device)
    img = _normalize(_resize_linear(img.permute(2, 0, 1)[None], (nh, nw)))
    return F.pad(img, (0, img_size - nw, 0, img_size - nh))


@torch.no_grad()
def sam_predict_box(model: SAM, image_uint8: np.ndarray, box_xyxy: np.ndarray,
                    threshold: float = 0.0) -> np.ndarray:
    """``SamPredictor.predict(box=...)``: a binary (H, W) uint8 mask at the
    image's resolution."""
    h, w = image_uint8.shape[:2]
    S = model.config.img_size
    scale = S / max(h, w)
    device = next(model.parameters()).device
    img = preprocess_image(image_uint8, S, device)
    box = torch.as_tensor(np.asarray(box_xyxy, np.float32), device=device)[None] * scale
    logits, _ = model(img, box)                                            # (1, S/4, S/4)
    logits = _resize_linear(logits[:, None], (S, S))[0, 0]
    logits = logits[: int(round(h * scale)), : int(round(w * scale))]
    logits = _resize_linear(logits[None, None], (h, w))[0, 0]
    return (logits > threshold).cpu().numpy().astype(np.uint8)


def make_box_model(model: SAM):
    """Adapter for ``models/mask_predictors.py``'s BoxPromptModel."""
    def box_model(image: np.ndarray, box: np.ndarray) -> np.ndarray:
        return sam_predict_box(model, image, box)

    return box_model


# --------------------------------------------------------------------------
# in-loop 'ps' segmentation: person seg -> bbox -> SAM refine, on the device
# --------------------------------------------------------------------------

def mask_to_bbox_traced(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) binary -> (..., 4) xyxy float box of the nonzero pixels
    (inclusive corners); an empty mask gives the full-image box."""
    H, W = mask.shape[-2:]
    on = mask > 0
    rows = on.any(dim=-1).to(torch.uint8)
    cols = on.any(dim=-2).to(torch.uint8)
    y0 = rows.argmax(dim=-1)
    y1 = H - 1 - rows.flip(-1).argmax(dim=-1)
    x0 = cols.argmax(dim=-1)
    x1 = W - 1 - cols.flip(-1).argmax(dim=-1)
    box = torch.stack([x0, y0, x1, y1], dim=-1).float()
    full = torch.tensor([0.0, 0.0, W - 1.0, H - 1.0], device=mask.device)
    return torch.where(on.flatten(-2).any(dim=-1)[..., None], box, full)


def make_sam_segment_fn(sam: SAM, seed_fn):
    """The in-loop 'ps' mode (``coma_tpu/models/sam.py:467``): ``seed_fn``
    gives coarse person masks (B, H, W) of images (B, 3, H, W) in [0, 1];
    each mask's box prompts SAM on the image resized to S², and the
    refined logits, resized back, are thresholded at 0."""
    S = sam.config.img_size

    @torch.no_grad()
    def segment_fn(images):
        H, W = images.shape[-2:]
        coarse = seed_fn(images)
        x = _normalize(_resize_linear(images.float() * 255.0, (S, S)))
        boxes = mask_to_bbox_traced(coarse)
        scale = torch.tensor([S / W, S / H, S / W, S / H], device=images.device)
        logits, _ = sam(x, boxes * scale)                                 # (B, S/4, S/4)
        refined = _resize_linear(logits[:, None], (H, W))[:, 0] > 0.0
        return refined.to(images.dtype)

    return segment_fn


@torch.no_grad()
def init_sam_random_(model: SAM, generator: torch.Generator) -> SAM:
    """Seeded random weights for ``--random_weights``: Flax's initializers
    for the linear, convolution and norm layers (``models/layers.py``), and
    normal(0, 1) for the prompt and token embeddings and the Fourier matrix;
    the position embedding and the relative position tables are drawn with
    std 0.02, so the runs exercise them."""
    from coma_tpu_torch.models.layers import init_flax_default_

    init_flax_default_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pe_gaussian", "point_embed", "no_mask_embed", "iou_token", "mask_tokens"):
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            p.normal_(0.0, 0.02, generator=generator)
    return model
