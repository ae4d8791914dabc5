"""Prompt and diffusion configuration data.

A private copy of the constants of ``coma_tpu/config/prompts.py``
(reference: ``constants/generation/prompts.py``,
``constants/generation/inpaint_ldm.py`` and ``constants/openai.py``): the
per-asset human-defined prompts, the per-category and per-view diffuser
configs, the allowed viewpoint augmentations, the SD inpainting model
registry and keys, the number of images per combination and the VLM prompt
template.
"""
from __future__ import annotations

HUMAN_DEFINED_PROMPTS = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": {
            "0a5a346c-cc3b-4280-b358-ccd1c4d8a865": [
                "1 person sits on a chair",
                "1 person moves a chair",
                "1 person leans against a chair",
            ],
        }
    },
    "motorcycle,bike": {
        "motorcycle,bike": {
            "9b9794dda0a6532215a11c390f7ca182": [
                "1 person rides the motorcycle",
                "1 person cleans the motorcycle",
                "1 person examines the motorcycle",
            ],
        }
    },
    "umbrella": {
        "umbrella": {
            "85fto9rtgcvsx2itzy9rd0gwh7758d64": [
                "1 person opens the umbrella",
                "1 person holds the umbrella",
                "1 person closes the umbrella",
            ],
        }
    },
    "frypan": {
        "frypan": {
            "77kk57qyyj3tivpp51tpjw6xia2ds9d9": [
                "1 person cooks with the frypan",
                "1 person washes the frypan",
                "1 person heats the frypan",
            ],
        }
    },
    "BEHAVE": {
        "backpack": {
            "behave_asset": [
                "1 person wears the backpack",
                "1 person zips the backpack",
                "1 person carries the backpack",
            ]
        },
    },
    "INTERCAP": {
        "suitcase": {
            "intercap_asset": [
                "1 person pulls the suitcase",
                "1 person packs the suitcase",
                "1 person unzips the suitcase",
            ]
        },
    },
}

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

# SD inpainting model registry (constants/generation/inpaint_ldm.py)
AVAILABLE_MODELS = {
    "stabilityai/stable-diffusion-2-inpainting": {
        "key": "stabilityai/stable-diffusion-2-inpainting",
        "use_diffusers_format": True,
        "use_inpaint": True,
    },
    "Lykon/dreamshaper-8-inpainting": {
        "key": "Lykon/dreamshaper-8-inpainting",
        "use_diffusers_format": True,
        "use_inpaint": True,
    },
    "Lykon/absolute-realism-1.6525-inpainting": {
        "key": "Lykon/absolute-realism-1.6525-inpainting",
        "use_diffusers_format": True,
        "use_inpaint": True,
    },
    "Uminosachi/realisticVisionV51_v51VAE-inpainting": {
        "key": "Uminosachi/realisticVisionV51_v51VAE-inpainting",
        "use_diffusers_format": True,
        "use_inpaint": True,
    },
}

HF_MODEL_KEYS = {
    "sd2inpaint": "stabilityai/stable-diffusion-2-inpainting",
    "dreamshaper8": "Lykon/dreamshaper-8-inpainting",
    "absolutereal": "Lykon/absolute-realism-1.6525-inpainting",
    "realisticvision": "Uminosachi/realisticVisionV51_v51VAE-inpainting",
}

NUM_IMG_PER_COMBINATION = 10  # src/generation/inpaint.py:356

# constants/openai.py: the GPT-4o prompt template (temperature 0, seed 42)
PROMPT_GENERATION_TEXT = (
    "Generate at most 3 simple subject-verb-object prompt where subject's "
    "word is exactly '1 person' and object's image is given. You should use "
    "diverse and general word but no pronoun for subject. Generated prompt "
    "must align with common sense. Verb must be simple as possible, and "
    "should depict physical interaction between subject and object. Also, "
    "only the interaction with given object is allowed, and no other objects "
    "should be introduced in the prompt."
)
