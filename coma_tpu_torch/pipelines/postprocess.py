"""Segmentation post-processing: overlap metrics, duplicate removal,
weak-perspective camera conversion (numpy; a copy of
``coma_tpu/pipelines/postprocess.py``).

Reference parity: ``utils/postprocess.py`` — IoU/IoM/intersection-over-chosen
(``:10-107``), bbox conversions (``:110-152``), confidence-ordered duplicate
removal (``process_remove_overlap:195-237``, ``process_segmentation:241-303``
— drop low-confidence boxes overlapping kept ones by >= minoverlap of either
box), and the crop-to-global weak-perspective camera transform
(``local_to_global_cam:155-182``).

Works on plain arrays instead of detectron2 Instances.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def intersection_over_union(seg1: np.ndarray, seg2: np.ndarray) -> float:
    a, b = seg1.astype(bool), seg2.astype(bool)
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0


def intersection_over_maximum(seg1: np.ndarray, seg2: np.ndarray) -> float:
    a, b = seg1.astype(bool), seg2.astype(bool)
    denom = max(a.sum(), b.sum())
    return float(np.logical_and(a, b).sum() / denom) if denom else 0.0


def intersection_over_chosen(seg1: np.ndarray, seg2: np.ndarray, key: str = "seg2") -> float:
    a, b = seg1.astype(bool), seg2.astype(bool)
    denom = b.sum() if key == "seg2" else a.sum()
    return float(np.logical_and(a, b).sum() / denom) if denom else 0.0


def bbox_xyxy_to_xywh(bbox: np.ndarray) -> np.ndarray:
    bbox = np.asarray(bbox, dtype=np.float64)
    out = bbox.copy()
    out[..., 2] = bbox[..., 2] - bbox[..., 0]
    out[..., 3] = bbox[..., 3] - bbox[..., 1]
    return out


def make_bbox_square(bbox_xywh: np.ndarray) -> np.ndarray:
    """Expand to a centered square of side max(w, h)."""
    bbox = np.asarray(bbox_xywh, dtype=np.float64)
    out = bbox.copy()
    side = np.maximum(bbox[..., 2], bbox[..., 3])
    out[..., 0] = bbox[..., 0] + bbox[..., 2] / 2 - side / 2
    out[..., 1] = bbox[..., 1] + bbox[..., 3] / 2 - side / 2
    out[..., 2] = side
    out[..., 3] = side
    return out


def process_remove_overlap(
    bbox_list: Sequence[Sequence[float]],   # xywh
    confidence_list: Sequence[float],
    minoverlap: float = 0.8,
    exconf: float = 0.98,
) -> List[int]:
    """Drop low-confidence boxes overlapping any kept box by >= minoverlap
    of either box's area; confidence >= exconf is always kept.

    Reference: ``utils/postprocess.py:process_remove_overlap:195-237``
    (iteration order: ascending confidence).
    """
    keepidx = list(range(len(bbox_list)))
    order = sorted(
        zip(range(len(bbox_list)), bbox_list, confidence_list), key=lambda t: t[-1]
    )
    for original_idx, bbox, confidence in order:
        if confidence >= exconf:
            continue
        area = bbox[2] * bbox[3]
        for idx, other in enumerate(bbox_list):
            if idx not in keepidx or idx == original_idx:
                continue
            other_area = other[2] * other[3]
            iw = max(min(bbox[0] + bbox[2], other[0] + other[2]) - max(bbox[0], other[0]), 0.0)
            ih = max(min(bbox[1] + bbox[3], other[1] + other[3]) - max(bbox[1], other[1]), 0.0)
            inter = iw * ih
            if inter / area >= minoverlap or inter / other_area >= minoverlap:
                keepidx.remove(original_idx)
                break
    return keepidx


def process_segmentation(
    pred_classes: np.ndarray,   # (N,) int, 0 = person
    pred_boxes: np.ndarray,     # (N, 4) xyxy
    scores: np.ndarray,         # (N,)
    minoverlap: float = 0.8,
    exconf: float = 0.98,
) -> np.ndarray:
    """Indices of surviving instances: persons always kept; non-person
    classes de-duplicated per class (reference:
    ``process_segmentation:241-303``)."""
    survived = list(np.flatnonzero(pred_classes == 0))
    for class_id in sorted(set(pred_classes.tolist())):
        if class_id == 0:
            continue
        idx = np.flatnonzero(pred_classes == class_id)
        boxes_xywh = bbox_xyxy_to_xywh(pred_boxes[idx]).tolist()
        keep = process_remove_overlap(boxes_xywh, scores[idx].tolist(), minoverlap, exconf)
        survived.extend(idx[keep].tolist())
    return np.asarray(sorted(survived), dtype=np.int64)


def local_to_global_cam(bboxes: np.ndarray, cams: np.ndarray, L: int) -> np.ndarray:
    """Weak-perspective camera w.r.t. a crop bbox -> w.r.t. the whole image.

    Reference: ``utils/postprocess.py:local_to_global_cam:155-182``.
    bboxes (N, 4) xyxy; cams (N, 3) [s, tx, ty]; L = max(H, W).
    """
    square = make_bbox_square(bbox_xyxy_to_xywh(bboxes))
    out = []
    for cam, bbox in zip(cams, square):
        x, y, b = bbox[0], bbox[1], bbox[2]
        s_crop = b * cam[0] / 2
        t_crop = cam[1:] + 1 / cam[0]
        s_og = s_crop / L
        t_og = t_crop + np.array([x, y]) / s_crop
        s = s_og * 2
        t = t_og - 0.5 / s_og
        out.append(np.concatenate([[s], t]))
    return np.stack(out)
