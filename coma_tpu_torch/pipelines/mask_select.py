"""Candidate-mask selection by segmentation-overlap band (PyTorch;
counterpart of ``coma_tpu/pipelines/mask_select.py``).

Reference: ``src/generation/select_mask.py:select_masks:17-110`` — keep the
candidate masks whose intersection-over-segmentation ratio lies within the
per-category [min, max] band (``constants/generation/assets.py:112-132``)
and write ``valid_mask_ids`` pickles. Here all masks of a view are counted in
one pass on their device; the ratios are formed in float64 on the host, as
``coma_tpu``'s Python floats are.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import torch


def select_valid_masks(asset_seg: torch.Tensor, candidate_masks: torch.Tensor,
                       minimum_seg_overlap_ratio: float,
                       maximum_seg_overlap_ratio: float) -> List[int]:
    """Indices of the masks (M, H, W), >0 = candidate, whose overlap with the
    segmentation (H, W), >0 = object, over the segmentation's area is within
    the band (both ends included)."""
    seg = asset_seg > 0
    seg_area = int(seg.sum())
    if seg_area == 0 or candidate_masks.shape[0] == 0:
        return []
    inter = ((candidate_masks > 0) & seg[None]).sum(dim=(1, 2)).cpu().tolist()
    return [i for i, n in enumerate(inter)
            if minimum_seg_overlap_ratio <= n / seg_area <= maximum_seg_overlap_ratio]


def save_valid_mask_ids(path: str, supercategory: str, category: str, asset_id: str,
                        view_id: str, valid_mask_ids: List[str]) -> None:
    """The reference's pickle (``select_mask.py:89-91``)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as handle:
        pickle.dump(
            {
                "supercategory": supercategory,
                "category": category,
                "asset_id": asset_id,
                "view_id": view_id,
                "valid_mask_ids": valid_mask_ids,
            },
            handle,
            protocol=pickle.HIGHEST_PROTOCOL,
        )
