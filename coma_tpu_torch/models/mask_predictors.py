"""Adaptive-mask predictor family (the reference's 7 predictor types).

Counterpart of ``coma_tpu/models/mask_predictors.py``, all numpy. Reference
parity: ``utils/adaptive_mask_inpainting.py:1182-1455`` — the
pipeline selects among predictor variants via ``--adaptive_mask_model_type``
(``src/generation/inpaint.py:73-109``):

- ``p`` / ``baseline``: person segmentation, instances merged ('merge') or
  max-confidence.
- ``ps``: person seg -> bbox prompt -> box-prompted refinement (SAM role).
- ``ps_ae``: additionally segments the asset bbox and SUBTRACTS it.
- ``s_pdb_ae`` / ``s_db_ae``: asset bbox seeded from the default mask.
- ``s_ab_ae``: asset bbox accumulated (unioned) over provoke steps.

The segmentation backends are pluggable callables (the port's
``PointRendPersonSegmenter``, or any box-promptable model such as
``models/sam.py``'s ``make_box_model``); this module owns the merge / box-prompt /
asset-exclusion logic, which is the reference's own code, ported exactly.
All predictors return ``{"mask", "asset_mask", "vis"}`` like the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from coma_tpu_torch.models.segmentation import merge_bbox, seg2bbox

MaskModel = Callable[[np.ndarray], List[Dict]]   # image -> instances
BoxPromptModel = Callable[[np.ndarray, np.ndarray], np.ndarray]  # (image, box) -> mask


class PersonMaskPredictor:
    """≈ PointRendPredictor (``:1182-1244``)."""

    def __init__(self, mask_model: MaskModel, merge_mode: str = "merge",
                 threshold: float = 0.8, use_visualizer: bool = False):
        if merge_mode not in ("merge", "max-confidence"):
            raise ValueError(f"merge_mode {merge_mode!r}")
        self.mask_model = mask_model
        self.merge_mode = merge_mode
        self.threshold = threshold
        self.use_visualizer = use_visualizer

    def merge_mask(self, masks: np.ndarray, scores=None) -> np.ndarray:
        if len(masks) == 0:
            return np.zeros(masks.shape[1:] if masks.ndim == 3 else (0, 0), bool)
        if self.merge_mode == "merge":
            return np.any(masks, axis=0)
        return masks[int(np.argmax(scores))]

    def _person_mask(self, image: np.ndarray) -> np.ndarray:
        instances = [
            i for i in self.mask_model(image) if i.get("score", 1.0) >= self.threshold
        ]
        if not instances:
            return np.zeros(image.shape[:2], np.uint8)
        masks = np.stack([i["mask"] for i in instances])
        scores = np.array([i.get("score", 1.0) for i in instances])
        return self.merge_mask(masks, scores).astype(np.uint8)

    def __call__(self, image: np.ndarray) -> Dict:
        return {"asset_mask": None, "mask": self._person_mask(image), "vis": None}


class BoxPromptedHumanPredictor(PersonMaskPredictor):
    """≈ SAMHumanPredictor (``:1246-1293``): person seg -> bbox -> refine."""

    def __init__(self, mask_model: MaskModel, box_model: BoxPromptModel, **kwargs):
        super().__init__(mask_model, **kwargs)
        self.box_model = box_model

    def __call__(self, image: np.ndarray) -> Dict:
        mask = self._person_mask(image)
        if mask.sum() == 0:
            return {"asset_mask": None, "mask": mask, "vis": None}
        bbox = seg2bbox(mask)
        refined = self.box_model(image, bbox).astype(np.uint8)
        return {"asset_mask": None, "mask": refined, "vis": None}


class BoxPromptedHumanPredictorWithAssetExclusion(BoxPromptedHumanPredictor):
    """≈ SAMHumanPredictorWithAssetExclusion (``:1295-1345``): additionally
    segment the asset (from its own bbox prompt) and subtract it."""

    def __init__(self, *args, asset_bbox_provider=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.asset_bbox_provider = asset_bbox_provider

    def _asset_bbox(self, image, human_mask) -> Optional[np.ndarray]:
        if self.asset_bbox_provider is not None:
            return self.asset_bbox_provider(image, human_mask)
        return None

    def __call__(self, image: np.ndarray) -> Dict:
        mask = self._person_mask(image)
        if mask.sum() == 0:
            return {"asset_mask": None, "mask": mask, "vis": None}
        human = self.box_model(image, seg2bbox(mask)).astype(bool)
        asset_bbox = self._asset_bbox(image, human)
        asset_mask = None
        if asset_bbox is not None:
            asset_mask = self.box_model(image, np.asarray(asset_bbox)).astype(bool)
            human = np.logical_and(human, ~asset_mask)  # subtract (``:1334-1341``)
        return {
            "asset_mask": None if asset_mask is None else asset_mask.astype(np.uint8),
            "mask": human.astype(np.uint8),
            "vis": None,
        }


class DefaultBboxAssetExclusionPredictor(BoxPromptedHumanPredictorWithAssetExclusion):
    """≈ SAMHumanPredictorWithDefaultBboxAssetExclusion (``:1347-1402``):
    the asset bbox is seeded from the DEFAULT inpainting mask."""

    def __init__(self, *args, default_mask: Optional[np.ndarray] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.default_mask = default_mask

    def register_default_mask(self, default_mask: np.ndarray) -> None:
        self.default_mask = default_mask

    def _asset_bbox(self, image, human_mask):
        if self.default_mask is None or self.default_mask.sum() == 0:
            return None
        return seg2bbox(self.default_mask)


class AccumulativeBboxAssetExclusionPredictor(DefaultBboxAssetExclusionPredictor):
    """≈ SAMHumanPredictorAccumulativeBboxAssetExclusion (``:1404-1455``):
    the asset bbox is the union of bboxes seen across provoke steps."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.accumulated: List[np.ndarray] = []

    def reset(self) -> None:
        self.accumulated = []

    def _asset_bbox(self, image, human_mask):
        seed = super()._asset_bbox(image, human_mask)
        if seed is not None:
            self.accumulated.append(np.asarray(seed))
        if not self.accumulated:
            return None
        return merge_bbox(self.accumulated)


def build_predictor(
    adaptive_mask_model_type: str,
    mask_model: MaskModel,
    box_model: Optional[BoxPromptModel] = None,
    threshold: float = 0.8,
):
    """The reference's model-type dispatch (``src/generation/inpaint.py:73-109``)."""
    t = adaptive_mask_model_type
    if t in ("p", "baseline"):
        return PersonMaskPredictor(mask_model, threshold=threshold)
    if box_model is None:
        raise ValueError(f"'{t}' needs a box-promptable model")
    if t == "ps":
        return BoxPromptedHumanPredictor(mask_model, box_model, threshold=threshold)
    if t == "ps_ae":
        return BoxPromptedHumanPredictorWithAssetExclusion(
            mask_model, box_model, threshold=threshold
        )
    if t in ("s_pdb_ae", "s_db_ae"):
        return DefaultBboxAssetExclusionPredictor(
            mask_model, box_model, threshold=threshold
        )
    if t == "s_ab_ae":
        return AccumulativeBboxAssetExclusionPredictor(
            mask_model, box_model, threshold=threshold
        )
    raise ValueError(f"unknown adaptive_mask_model_type: {t}")
