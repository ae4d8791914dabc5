"""PointRend R50-FPN instance segmentation in PyTorch (detectron2's
``pointrend_rcnn_R_50_FPN_3x_coco``, the reference's person segmenter).

Counterpart of ``coma_tpu/models/pointrend.py``. The network runs NCHW on
``torch.nn`` convolutions; every stage after it is batched over images and
keeps ``coma_tpu``'s static shapes: padded top-K proposals, padded
detections with a validity flag, and the five subdivision steps of 784
points. Top-K is a stable descending sort, so ties (the -inf padding and
the suppressed slots among them) fall to the lower index as in
``jax.lax.top_k``, and even invalid detection slots carry ``coma_tpu``'s
boxes. Greedy NMS is exact and batched over (image, level): the
fixed-point iteration ``keep <- valid & ~any_{j<i}(keep_j & IoU_ij > t)``
from ``keep = valid``, repeated until it stops changing. Entry i depends
only on entries j < i, so the fixed point is unique, is the sequential
greedy result, and is reached after at most K rounds (as many as the
longest chain of suppressions); ``NMS_STATS`` counts the rounds.

Module and parameter names follow ``coma_tpu``'s Flax tree, so
``models/flax_params.py`` loads a converted ``.npz``;
``models/segmenter_weights.py`` loads detectron2's own key layout.
``make_pointrend_segment_fn(..., compute_dtype=torch.bfloat16)`` runs the
convolutions and fully connected layers in bf16 on a bf16 copy of the
weights (``--pointrend_fast``); box decoding, scores, NMS and the
subdivision's point selection stay float32.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.segmentation import _resize_linear
from coma_tpu_torch.ops.sampling import grid_sample_bilinear, multilevel_roi_align

# rounds and calls of the fixed-point NMS since the last reset (host counters)
NMS_STATS = {"calls": 0, "rounds": 0, "max_rounds": 0}


def reset_nms_stats() -> None:
    NMS_STATS.update(calls=0, rounds=0, max_rounds=0)


# -------------------------------------------------------------------------
# detectron2-layout ResNet-50 (FrozenBN, stride_in_1x1) + FPN
# -------------------------------------------------------------------------

class FrozenBN(nn.Module):
    """FrozenBatchNorm2d over NCHW, its statistics stored as the checkpoint's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))
        self.eps = eps

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class ConvNorm(nn.Module):
    """Conv2d without bias + FrozenBN (detectron2's ``conv.norm``)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding, bias=False)
        self.norm = FrozenBN(features)

    def forward(self, x):
        return self.norm(self.conv(x))


class D2Bottleneck(nn.Module):
    """detectron2 BottleneckBlock with the stage stride on the 1x1 conv1."""

    def __init__(self, cin: int, bottleneck: int, out_channels: int, stride: int = 1,
                 has_shortcut: bool = False):
        super().__init__()
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, 1, padding=1)
        self.conv3 = ConvNorm(bottleneck, out_channels, 1)
        self.shortcut = ConvNorm(cin, out_channels, 1, stride) if has_shortcut else None

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


RESNET_STAGES = (("res2", 3, 64, 256, 1), ("res3", 4, 128, 512, 2),
                 ("res4", 6, 256, 1024, 2), ("res5", 3, 512, 2048, 2))


class D2ResNet50(nn.Module):
    """Outputs {res2, res3, res4, res5} at strides 4/8/16/32."""

    def __init__(self):
        super().__init__()
        self.stem_conv1 = ConvNorm(3, 64, 7, 2, padding=3)
        cin = 64
        for name, n_blocks, bottleneck, out_ch, stride in RESNET_STAGES:
            for i in range(n_blocks):
                self.add_module(f"{name}_{i}", D2Bottleneck(
                    cin, bottleneck, out_ch, stride if i == 0 else 1, has_shortcut=i == 0))
                cin = out_ch

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.stem_conv1(x)), 3, 2, 1)
        feats = {}
        for name, n_blocks, *_ in RESNET_STAGES:
            for i in range(n_blocks):
                x = getattr(self, f"{name}_{i}")(x)
            feats[name] = x
        return feats


class FPN(nn.Module):
    """1x1 laterals + 3x3 outputs (with bias, no norm), nearest top-down
    upsampling, p6 = the 1x1 stride-2 max pool of p5."""

    def __init__(self, out_channels: int = 256):
        super().__init__()
        for lvl, cin in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            self.add_module(f"fpn_lateral{lvl}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{lvl}", nn.Conv2d(out_channels, out_channels, 3,
                                                          padding=1))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = {lvl: getattr(self, f"fpn_lateral{lvl}")(feats[f"res{lvl}"])
                    for lvl in (2, 3, 4, 5)}
        prev = laterals[5]
        out = {"p5": self.fpn_output5(prev)}
        for lvl in (4, 3, 2):
            lat = laterals[lvl]
            prev = F.interpolate(prev, size=lat.shape[-2:], mode="nearest-exact") + lat
            out[f"p{lvl}"] = getattr(self, f"fpn_output{lvl}")(prev)
        out["p6"] = F.max_pool2d(out["p5"], 1, 2)
        return out


class RPNHead(nn.Module):
    """Shared 3x3 conv -> objectness (A) + anchor deltas (4A) per level."""

    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: List[torch.Tensor]):
        outs = []
        for f in feats:
            t = F.relu(self.conv(f))
            outs.append((self.objectness_logits(t), self.anchor_deltas(t)))
        return outs


class BoxHead(nn.Module):
    """FastRCNNConvFCHead (2 fc) + FastRCNNOutputLayers on (R, 7, 7, C) ROI
    features; float32 out."""

    def __init__(self, num_classes: int = 80, channels: int = 256, side: int = 7):
        super().__init__()
        self.fc1 = nn.Linear(channels * side * side, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.cls_score = nn.Linear(1024, num_classes + 1)
        self.bbox_pred = nn.Linear(1024, num_classes * 4)

    def forward(self, roi_feats):
        R = roi_feats.shape[0]
        x = roi_feats.permute(0, 3, 1, 2).reshape(R, -1).to(self.fc1.weight.dtype)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class CoarseMaskHead(nn.Module):
    """PointRend ConvFCHead: (R, 14, 14, C) point-sampled p2 features ->
    (R, classes, 7, 7) coarse logits, float32."""

    def __init__(self, num_classes: int = 80, channels: int = 256, conv_dim: int = 256,
                 fc_dim: int = 1024, output_side: int = 7):
        super().__init__()
        self.reduce_channel_dim_conv = nn.Conv2d(channels, conv_dim, 1)
        self.reduce_spatial_dim_conv = nn.Conv2d(conv_dim, conv_dim, 2, 2)
        self.fc1 = nn.Linear(conv_dim * output_side ** 2, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.prediction = nn.Linear(fc_dim, num_classes * output_side ** 2)
        self.num_classes, self.output_side = num_classes, output_side

    def forward(self, x):
        R = x.shape[0]
        x = x.permute(0, 3, 1, 2).to(self.fc1.weight.dtype)
        x = F.relu(self.reduce_channel_dim_conv(x))
        x = F.relu(self.reduce_spatial_dim_conv(x)).reshape(R, -1)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        s = self.output_side
        return self.prediction(x).float().reshape(R, self.num_classes, s, s)


class PointHead(nn.Module):
    """StandardPointHead: 3 point-wise fc (256), the coarse logits
    concatenated again at every layer; float32 out."""

    def __init__(self, num_classes: int = 80, channels: int = 256, fc_dim: int = 256,
                 num_fc: int = 3):
        super().__init__()
        d = channels + num_classes
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(d, fc_dim))
            d = fc_dim + num_classes
        self.predictor = nn.Linear(d, num_classes)
        self.num_fc = num_fc

    def forward(self, fine, coarse):     # (R, P, C), (R, P, classes)
        dt = self.predictor.weight.dtype
        coarse = coarse.to(dt)
        x = torch.cat([fine.to(dt), coarse], dim=-1)
        for k in range(self.num_fc):
            x = torch.cat([F.relu(getattr(self, f"fc{k + 1}")(x)), coarse], dim=-1)
        return self.predictor(x).float()


# -------------------------------------------------------------------------
# Box arithmetic (detectron2 Box2BoxTransform / pairwise IoU / greedy NMS)
# -------------------------------------------------------------------------

_SCALE_CLAMP = math.log(1000.0 / 16)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor, weights) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: anchors (..., 4) xyxy, deltas (..., 4)."""
    wx, wy, ww, wh = weights
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=_SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=_SCALE_CLAMP)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU (..., Na, Nb) of xyxy boxes (..., Na, 4), (..., Nb, 4) (no +1)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-9)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy NMS over boxes (..., K, 4) already sorted by score descending;
    a -inf score is padding and never kept. Returns the keep mask (..., K),
    exactly the sequential result, by the fixed-point iteration of the
    module docstring, batched over the leading axes."""
    K = boxes.shape[-2]
    idx = torch.arange(K, device=boxes.device)
    # over[..., i, j]: an earlier box j would suppress box i if kept
    over = (pairwise_iou(boxes, boxes) > iou_thresh) & (idx[None, :] < idx[:, None])
    valid = scores > -math.inf
    keep = valid
    rounds = 0
    while True:
        rounds += 1
        new = valid & ~(over & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    NMS_STATS["calls"] += 1
    NMS_STATS["rounds"] += rounds
    NMS_STATS["max_rounds"] = max(NMS_STATS["max_rounds"], rounds)
    return keep


def greedy_nms_loop(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The sequential form (``coma_tpu``'s K-step loop) for one (K, 4) set:
    the reference :func:`greedy_nms` is held against."""
    K = boxes.shape[0]
    iou = pairwise_iou(boxes, boxes)
    valid = scores > -math.inf
    idx = torch.arange(K, device=boxes.device)
    keep = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    for i in range(K):
        sup = (keep & (iou[i] > iou_thresh) & (idx < i)).any()
        keep[i] = ~sup & valid[i]
    return keep


def topk(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: a stable descending sort, so
    equal values come lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, k) -> (B, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# -------------------------------------------------------------------------
# Anchors
# -------------------------------------------------------------------------

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)


def generate_anchors(hw_per_level: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """d2 DefaultAnchorGenerator (offset 0): per level, (H*W*A, 4) in H, W,
    A order, the order of the RPN head's channels-last flatten."""
    out = []
    for (H, W), stride, size in zip(hw_per_level, FPN_STRIDES, ANCHOR_SIZES):
        cell = []
        for r in ANCHOR_RATIOS:
            w = math.sqrt(size * size / r)
            h = w * r
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        cell = np.asarray(cell, np.float32)
        sx = np.arange(W, dtype=np.float32) * stride
        sy = np.arange(H, dtype=np.float32) * stride
        shift = np.stack(np.broadcast_arrays(sx[None, :, None], sy[:, None, None]), axis=-1)
        shifts = np.concatenate([shift, shift], axis=-1)
        out.append((shifts + cell[None, None]).reshape(-1, 4))
    return out


# -------------------------------------------------------------------------
# Full inference pipeline
# -------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointRendConfig:
    num_classes: int = 80
    pre_nms_topk: int = 1000
    post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    max_detections: int = 100
    box_candidates: int = 500  # flattened class-score candidates fed to NMS
    subdivision_steps: int = 5
    subdivision_points: int = 28 * 28
    coarse_side: int = 7
    # preprocessing (d2 DefaultPredictor): shortest edge 800, BGR, mean only
    test_size: int = 800
    pixel_mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)  # BGR


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    H, W = hw
    return torch.stack([boxes[..., 0].clamp(0, W), boxes[..., 1].clamp(0, H),
                        boxes[..., 2].clamp(0, W), boxes[..., 3].clamp(0, H)], dim=-1)


def regular_grid_coords(side: int, device=None) -> torch.Tensor:
    """(side², 2) cell centres of a regular grid over [0, 1]², x first."""
    c = (torch.arange(side, dtype=torch.float32, device=device) + 0.5) * (1.0 / side)
    gy, gx = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def sample_in_box_points(feat: torch.Tensor, boxes: torch.Tensor, coords: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """d2 ``point_sample_fine_grained_features``: in-box coords (P, 2) or
    (..., R, P, 2) in [0, 1] -> samples (..., R, P, C) of ``feat`` (H, W, C)
    or (B, H, W, C) with boxes (R, 4) or (B, R, 4) in image pixels."""
    H, W = feat.shape[-3:-1]
    if coords.dim() == 2:
        coords = coords.expand(boxes.shape[:-1] + coords.shape)
    x0, y0 = boxes[..., None, 0], boxes[..., None, 1]
    bw = boxes[..., None, 2] - boxes[..., None, 0]
    bh = boxes[..., None, 3] - boxes[..., None, 1]
    ix = x0 + coords[..., 0] * bw
    iy = y0 + coords[..., 1] * bh
    norm = torch.stack([ix / (W * stride), iy / (H * stride)], dim=-1)
    return grid_sample_bilinear(feat, norm)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class PointRendModel(nn.Module):
    """The GeneralizedRCNN graph, batched: a preprocessed image batch (B, 3,
    H, W) BGR, mean-subtracted -> padded detections with (B, D, 224, 224)
    mask logits. The stages are callable one by one."""

    def __init__(self, cfg: PointRendConfig = PointRendConfig()):
        super().__init__()
        self.cfg = cfg
        self.bottom_up = D2ResNet50()
        self.fpn = FPN()
        self.rpn_head = RPNHead()
        self.box = BoxHead(cfg.num_classes)
        self.coarse_head = CoarseMaskHead(cfg.num_classes)
        self.point_head = PointHead(cfg.num_classes)

    def features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) -> FPN maps p2..p6, NCHW, in the weights' dtype."""
        dt = self.fpn.fpn_lateral2.weight.dtype
        return self.fpn(self.bottom_up(image.to(dt)))

    def rpn(self, fpn: Dict[str, torch.Tensor], image_hw: Tuple[int, int]):
        """FPN maps -> (B, post_nms_topk, 4) proposals + validity (B, post)."""
        cfg = self.cfg
        levels = [fpn[f"p{i}"] for i in range(2, 7)]
        B = levels[0].shape[0]
        anchors = generate_anchors([tuple(f.shape[-2:]) for f in levels])
        all_boxes, all_scores = [], []
        for (obj, deltas), anc in zip(self.rpn_head(levels), anchors):
            obj = _channels_last(obj.float()).reshape(B, -1)
            deltas = _channels_last(deltas.float()).reshape(B, -1, 4)
            k = min(cfg.pre_nms_topk, obj.shape[1])
            score, idx = topk(obj, k)
            anc = torch.as_tensor(anc, device=obj.device)[idx]
            boxes = clip_boxes(decode_deltas(anc, _take(deltas, idx), (1, 1, 1, 1)), image_hw)
            pad = cfg.pre_nms_topk - k
            all_boxes.append(F.pad(boxes, (0, 0, 0, pad)))
            all_scores.append(F.pad(score, (0, pad), value=-math.inf))
        boxes = torch.stack(all_boxes, dim=1)              # (B, L, K, 4)
        scores = torch.stack(all_scores, dim=1)            # (B, L, K)
        keep = greedy_nms(boxes, scores, cfg.rpn_nms_thresh)
        scores = torch.where(keep, scores, -math.inf).reshape(B, -1)
        top, idx = topk(scores, cfg.post_nms_topk)
        return _take(boxes.reshape(B, -1, 4), idx), top > -math.inf

    def detect(self, fpn, proposals, prop_valid, image_hw):
        """Proposals (B, R, 4) -> padded (B, max_detections) boxes, scores,
        classes and validity."""
        cfg = self.cfg
        B, R = proposals.shape[:2]
        nc = cfg.num_classes
        feats = [_channels_last(fpn[f"p{i}"]) for i in range(2, 6)]
        roi = multilevel_roi_align(feats, proposals, 7, (4, 8, 16, 32))
        scores, deltas = self.box(roi.reshape((B * R,) + roi.shape[2:]))
        probs = torch.softmax(scores, dim=-1)[:, :-1].reshape(B, R, nc)
        probs = torch.where(prop_valid[..., None], probs, 0.0)
        boxes = clip_boxes(decode_deltas(proposals[:, :, None, :], deltas.reshape(B, R, nc, 4),
                                         (10.0, 10.0, 5.0, 5.0)), image_hw)
        flat = probs.reshape(B, -1)
        flat = torch.where(flat > cfg.box_score_thresh, flat, 0.0)
        cand_scores, cand_idx = topk(flat, min(cfg.box_candidates, flat.shape[1]))
        cand_boxes = _take(boxes.reshape(B, -1, 4), cand_idx)
        cand_cls = cand_idx % nc
        cand_scores = torch.where(cand_scores > 0, cand_scores, -math.inf)
        # batched per-class NMS via the coordinate-offset trick
        offset = cand_cls.float()[..., None] * 10000.0
        keep = greedy_nms(cand_boxes + offset, cand_scores, cfg.box_nms_thresh)
        top, idx = topk(torch.where(keep, cand_scores, -math.inf), cfg.max_detections)
        return dict(boxes=_take(cand_boxes, idx), scores=torch.where(top > -math.inf, top, 0.0),
                    classes=_take(cand_cls, idx), valid=top > -math.inf)

    def coarse_masks(self, p2: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """p2 (B, H, W, C) channels last, boxes (B, D, 4) -> (B·D, classes,
        7, 7) coarse logits from a regular 14x14 in-box grid of p2 samples."""
        side = 14
        grid = regular_grid_coords(side, p2.device)
        feats = sample_in_box_points(p2, boxes, grid, stride=4)     # (B, D, P, C)
        return self.coarse_head(feats.reshape(-1, side, side, feats.shape[-1]))

    def point_rend_masks(self, p2: torch.Tensor, boxes: torch.Tensor,
                         classes: torch.Tensor) -> torch.Tensor:
        """The subdivision inference: the point head on a regular 7x7 grid,
        then 5 rounds of 2x bilinear upsampling that re-evaluate the 784 most
        uncertain points (every point while the grid has at most 784).
        p2 (B, H, W, C) channels last; returns (B, D, 224, 224) logits of
        each detection's class."""
        cfg = self.cfg
        B, D = boxes.shape[:2]
        R = B * D
        coarse = self.coarse_masks(p2, boxes).permute(0, 2, 3, 1).contiguous()  # (R, 7, 7, nc)
        cls = classes.reshape(R, 1, 1)

        def head(coords):            # (R, P, 2) -> (R, P) logits of each ROI's class
            P = coords.shape[1]
            fine = sample_in_box_points(p2, boxes, coords.reshape(B, D, P, 2), stride=4)
            logits = self.point_head(fine.reshape(R, P, -1), grid_sample_bilinear(coarse, coords))
            return logits.gather(-1, cls.expand(R, P, 1))[..., 0]

        side = cfg.coarse_side
        mask = head(regular_grid_coords(side, p2.device).expand(R, side * side, 2))
        mask = mask.reshape(R, side, side)
        for _ in range(cfg.subdivision_steps):
            side *= 2
            mask = _resize_linear(mask[:, None], (side, side))[:, 0]
            if side * side <= cfg.subdivision_points:
                grid = regular_grid_coords(side, p2.device).expand(R, side * side, 2)
                mask = head(grid).reshape(R, side, side)
                continue
            _, pidx = topk(-mask.reshape(R, -1).abs(), cfg.subdivision_points)
            py, px = (pidx // side).float(), (pidx % side).float()
            coords = torch.stack([(px + 0.5) / side, (py + 0.5) / side], dim=-1)
            mask = mask.reshape(R, -1).scatter(1, pidx, head(coords)).reshape(R, side, side)
        return mask.reshape(B, D, side, side)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        hw = tuple(image.shape[-2:])
        fpn = self.features(image)
        proposals, prop_valid = self.rpn(fpn, hw)
        det = self.detect(fpn, proposals, prop_valid, hw)
        det["mask_logits"] = self.point_rend_masks(_channels_last(fpn["p2"]), det["boxes"],
                                                   det["classes"])
        return det


# -------------------------------------------------------------------------
# Image pre/post processing
# -------------------------------------------------------------------------

def preprocess_image(rgb_uint8: np.ndarray, cfg: PointRendConfig = PointRendConfig(),
                     device=None):
    """d2 DefaultPredictor preprocessing: RGB uint8 (H, W, 3) -> BGR float
    (Hp, Wp, 3), shortest edge resized to ``test_size``, mean-subtracted,
    zero-padded to multiples of 32; and (scale_y, scale_x) back to pixels."""
    H, W = rgb_uint8.shape[:2]
    scale = cfg.test_size / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    img = torch.as_tensor(np.asarray(rgb_uint8, np.float32), device=device)
    img = _resize_linear(img.permute(2, 0, 1)[None], (nh, nw))[0].permute(1, 2, 0)
    bgr = img.flip(-1) - torch.tensor(cfg.pixel_mean, device=img.device)
    bgr = F.pad(bgr, (0, 0, 0, (32 - nw % 32) % 32, 0, (32 - nh % 32) % 32))
    return bgr, (H / nh, W / nw)


def merged_person_mask(det: Dict[str, torch.Tensor], image_hw: Tuple[int, int],
                       box_scale: Tuple[float, float], score_thresh: float = 0.8,
                       person_class: int = 0, paste_stride: int = 1,
                       chunk: int = 32) -> torch.Tensor:
    """Paste and merge, batched: detections (B, D, ...) -> one binary person
    mask (B, H, W) at ``image_hw`` (the reference's ``merge_mode='merge'``).
    ``box_scale`` (sy, sx) maps detector coordinates to image pixels. The
    paste is separable bilinear sampling (two products per detection, as in
    ``coma_tpu``), ``chunk`` detections at a time. ``paste_stride > 1``
    pastes on a coarser pixel grid and upsamples it nearest."""
    H, W = image_hw
    s = paste_stride
    ph, pw = H // s, W // s
    sy, sx = box_scale
    dev = det["boxes"].device
    boxes = det["boxes"] * torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=dev)
    keep = det["valid"] & (det["classes"] == person_class) & (det["scores"] >= score_thresh)
    logits = det["mask_logits"].float()
    S = logits.shape[-1]
    ys = (torch.arange(ph, dtype=torch.float32, device=dev) + 0.5) * (H / ph)
    xs = (torch.arange(pw, dtype=torch.float32, device=dev) + 0.5) * (W / pw)
    taps = torch.arange(S, dtype=torch.float32, device=dev)
    merged = torch.zeros(boxes.shape[0], ph, pw, dtype=torch.bool, device=dev)
    for c in range(0, boxes.shape[1], chunk):
        b, k, lg = boxes[:, c:c + chunk], keep[:, c:c + chunk], logits[:, c:c + chunk]
        u = (xs - b[..., 0:1]) / torch.clamp(b[..., 2:3] - b[..., 0:1], min=1e-6)   # (B, d, pw)
        v = (ys - b[..., 1:2]) / torch.clamp(b[..., 3:4] - b[..., 1:2], min=1e-6)   # (B, d, ph)
        wy = torch.clamp(1.0 - ((v * S - 0.5)[..., None] - taps).abs(), min=0.0)
        wx = torch.clamp(1.0 - ((u * S - 0.5)[..., None] - taps).abs(), min=0.0)
        vals = wy @ lg @ wx.transpose(-1, -2)                                        # (B, d, ph, pw)
        inside = ((v > 0) & (v < 1))[..., :, None] & ((u > 0) & (u < 1))[..., None, :]
        merged |= ((vals > 0) & inside & k[..., None, None]).any(dim=1)
    if s > 1:
        merged = F.interpolate(merged.float()[:, None], size=(H, W),
                               mode="nearest-exact")[:, 0] > 0.5
    return merged


def make_pointrend_segment_fn(model: PointRendModel, score_thresh: float = 0.8,
                              compute_dtype=None, paste_stride: int = 1):
    """``images (B, 3, H, W) in [0, 1] -> (B, H, W)`` float person masks:
    the whole detector at every provoke step, batched over images (the
    reference's in-loop PointRendPredictor). ``compute_dtype=torch.bfloat16``
    runs it on a bf16 copy of the weights; ``paste_stride`` coarsens the
    paste grid (:func:`merged_person_mask`)."""
    cfg = model.cfg
    net_model = model if compute_dtype is None else copy.deepcopy(model).to(compute_dtype)

    @torch.no_grad()
    def segment_fn(images):
        H, W = images.shape[-2:]
        net, box_scale = preprocess_batch(images, cfg)
        return merged_person_mask(net_model(net), (H, W), box_scale, score_thresh,
                                  paste_stride=paste_stride).float()

    return segment_fn


def preprocess_batch(images: torch.Tensor, cfg: PointRendConfig):
    """The in-loop preprocessing: images (B, 3, H, W) in [0, 1] -> the
    detector's input (B, 3, Hp, Wp), BGR and mean-subtracted at the shortest
    edge ``test_size``, zero-padded to multiples of 32; and (sy, sx) back to
    the images' pixels."""
    H, W = images.shape[-2:]
    scale = cfg.test_size / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    net = _resize_linear(images.float() * 255.0, (nh, nw))
    mean_rgb = torch.tensor(cfg.pixel_mean[::-1], device=images.device)
    net = (net - mean_rgb[:, None, None]).flip(1)
    return F.pad(net, (0, (32 - nw % 32) % 32, 0, (32 - nh % 32) % 32)), (H / nh, W / nw)


class PointRendPersonSegmenter:
    """RGB image -> person instances (the ``MaskModel`` interface of
    ``models/mask_predictors.py`` and the ``segment_human`` stage): the
    detector on the model's device, the paste on the host."""

    PERSON_CLASS = 0  # COCO

    def __init__(self, model: PointRendModel, score_thresh: float = 0.05):
        self.model = model.eval()
        self.cfg = model.cfg
        self.score_thresh = score_thresh

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> list:
        rgb = np.asarray(image)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        device = next(self.model.parameters()).device
        net_in, (sy, sx) = preprocess_image(rgb, self.cfg, device)
        det = {k: v[0].cpu().numpy() for k, v in self.model(net_in.permute(2, 0, 1)[None]).items()}
        keep = (det["valid"] & (det["classes"] == self.PERSON_CLASS)
                & (det["scores"] >= self.score_thresh))
        boxes_img = det["boxes"][keep] * np.array([sx, sy, sx, sy], np.float32)
        masks = paste_masks(det["mask_logits"][keep], boxes_img, rgb.shape[:2])
        return [dict(mask=m, bbox=b.astype(np.float32), score=float(s), pred_class=0)
                for m, b, s in zip(masks, boxes_img, det["scores"][keep])]


def paste_masks(mask_logits: np.ndarray, boxes: np.ndarray, image_hw: Tuple[int, int],
                threshold: float = 0.5) -> np.ndarray:
    """d2 ``paste_masks_in_image``: per-instance (S, S) logits -> binary
    masks at image resolution (host numpy)."""
    R, S, _ = mask_logits.shape
    H, W = image_hw
    out = np.zeros((R, H, W), bool)
    for i in range(R):
        x0, y0, x1, y1 = boxes[i]
        ix0, iy0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
        ix1, iy1 = min(int(np.ceil(x1)), W), min(int(np.ceil(y1)), H)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        xs = (np.arange(ix0, ix1) + 0.5 - x0) / max(x1 - x0, 1e-6)
        ys = (np.arange(iy0, iy1) + 0.5 - y0) / max(y1 - y0, 1e-6)
        gx = np.clip(xs * S - 0.5, 0, S - 1)
        gy = np.clip(ys * S - 0.5, 0, S - 1)
        x0i = np.floor(gx).astype(int)
        y0i = np.floor(gy).astype(int)
        x1i = np.minimum(x0i + 1, S - 1)
        y1i = np.minimum(y0i + 1, S - 1)
        wx = gx - x0i
        wy = gy - y0i
        m = mask_logits[i]
        vals = (m[np.ix_(y0i, x0i)] * (1 - wy)[:, None] * (1 - wx)[None, :]
                + m[np.ix_(y0i, x1i)] * (1 - wy)[:, None] * wx[None, :]
                + m[np.ix_(y1i, x0i)] * wy[:, None] * (1 - wx)[None, :]
                + m[np.ix_(y1i, x1i)] * wy[:, None] * wx[None, :])
        out[i, iy0:iy1, ix0:ix1] = vals > np.log(threshold / (1 - threshold))
    return out
