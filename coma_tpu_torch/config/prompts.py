"""Diffusion configuration data that the inpaint CLI reads.

A private copy of the constants of ``coma_tpu/config/prompts.py`` that
``cli/inpaint.py`` uses (reference: ``constants/generation/prompts.py`` and
``constants/generation/inpaint_ldm.py``): the per-category and per-view
diffuser configs, the allowed viewpoint augmentations, the model keys and the
number of images per combination.
"""
from __future__ import annotations

SC2DIFFUSERCONFIG = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": {
            "strength": 1.0,
            "controlnet_conditioning_scale": 0.0,
        }
    },
    "motorcycle,bike": {
        "motorcycle,bike": {"strength": 0.9, "controlnet_conditioning_scale": 0.0},
    },
    "umbrella": {"umbrella": dict()},
    "frypan": {"frypan": dict()},
    "BEHAVE": {"backpack": {"strength": 0.98}},
    "INTERCAP": {"suitcase": {"strength": 0.98}},
}

ALLOWED_VIEWPOINT_AUGMENTATIONS = [", full body", "original"]

_VIEW_TEXT = {"view_text": [", full body", "original"]}
SCV2DIFFUSERCONFIG = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": {
            f"view:{i:05}": dict(_VIEW_TEXT) for i in range(8)
        }
    },
    "motorcycle,bike": {
        "motorcycle,bike": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(8)},
    },
    "umbrella": {"umbrella": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(40)}},
    "frypan": {"frypan": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(40)}},
    "cart": {"cart": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(8)}},
    "BEHAVE": {"backpack": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(40)}},
    "INTERCAP": {"suitcase": {f"view:{i:05}": dict(_VIEW_TEXT) for i in range(40)}},
}

HF_MODEL_KEYS = {
    "sd2inpaint": "stabilityai/stable-diffusion-2-inpainting",
    "dreamshaper8": "Lykon/dreamshaper-8-inpainting",
    "absolutereal": "Lykon/absolute-realism-1.6525-inpainting",
    "realisticvision": "Uminosachi/realisticVisionV51_v51VAE-inpainting",
}

NUM_IMG_PER_COMBINATION = 10  # src/generation/inpaint.py:356
