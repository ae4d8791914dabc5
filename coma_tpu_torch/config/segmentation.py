"""Segmentation class maps + mode surface (reference:
``constants/segmentation.py`` + ``src/generation/segment_human.py:170-182``).

A copy of ``coma_tpu/config/segmentation.py`` (the port imports nothing of
``coma_tpu``).

The reference drives detectron2 PointRend over COCO's 80 "thing" classes
and keeps only class 0 (person) on its main path
(``predict_human.py:47-51``). Its ``--mode {coco,lvis,odise}`` flag accepts
three values, but ``lvis`` and ``odise`` both ``raise NotImplementedError``
in the reference itself (``segment_human.py:177-181``) — this port mirrors
that surface exactly: the COCO map is shipped (the standard COCO-2017
detection category list, written out here as public data), the LVIS map is
not (its only reference consumer is the unreachable ``lvis`` branch).
"""
from __future__ import annotations

SEGMENTATION_MODES = ("coco", "lvis", "odise")

# reference default (segment_human.py:193) and its allowed choices
DEFAULT_SEGMENTATION_MODE = "coco"
SEGMENTATION_THRESHOLD_CHOICES = (0.8, 0.95)
DEFAULT_SEGMENTATION_THRESHOLD = 0.8

# COCO-2017 "thing" classes in detectron2 contiguous-id order: index 0 is
# person — the only class the pipeline consumes (predict_human.py:47).
COCO_THING_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

COCO_CLASS_ID2NAME = {i: n for i, n in enumerate(COCO_THING_CLASSES)}
COCO_CLASS_NAME2ID = {n: i for i, n in COCO_CLASS_ID2NAME.items()}

PERSON_CLASS_ID = COCO_CLASS_NAME2ID["person"]  # == 0


def run_mode_supported(mode: str) -> bool:
    """True for modes the pipeline implements. Mirrors the reference's
    dispatch: 'coco' works, 'lvis'/'odise' are declared but raise
    (``segment_human.py:177-181``)."""
    if mode not in SEGMENTATION_MODES:
        raise AssertionError(
            f"Segmentation Mode: {mode} --> Not implemented...")
    return mode == "coco"
