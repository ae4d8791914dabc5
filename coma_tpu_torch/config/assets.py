"""Asset/dataset configuration data.

A copy of ``coma_tpu/config/assets.py``. Reference parity:
``constants/generation/assets.py`` — dataset root paths, (supercategory,
category) registries, asset whitelists, camera configs,
mask-overlap filter bands, and perturbation intervals. These are experiment
*data* (the published per-category settings), ported with identical keys and
values; the dataset .obj path resolution mirrors
``src/coma/downsample_objects.py:93-130``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

DATASET_PTHS = {
    "3D-FUTURE": "data/3D-FUTURE-model",
    "SHAPENET": "data/ShapeNetCore.v2",
    "SKETCHFAB": "data/SketchFab",
    "SAPIEN": "data/SAPIEN",
    "BEHAVE": "data/BEHAVE",
    "INTERCAP": "data/INTERCAP",
}

DATASET_TYPE2CATEGORIES = {
    "3D-FUTURE": [("Chair", "Lounge Chair / Cafe Chair / Office Chair")],
    "SHAPENET": [("motorcycle,bike", "motorcycle,bike")],
    "SKETCHFAB": [("umbrella", "umbrella"), ("frypan", "frypan")],
    "SAPIEN": [("cart", "cart")],
    "BEHAVE": [("BEHAVE", "backpack")],
    "INTERCAP": [("INTERCAP", "suitcase")],
}

CATEGORY2DATASET_TYPE = {
    supercat_cat: dataset_type
    for dataset_type, pairs in DATASET_TYPE2CATEGORIES.items()
    for supercat_cat in pairs
}

CATEGORY2ASSET = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": [
            "0a5a346c-cc3b-4280-b358-ccd1c4d8a865",
        ],
    },
    "motorcycle,bike": {"motorcycle,bike": ["9b9794dda0a6532215a11c390f7ca182"]},
    "umbrella": {"umbrella": ["85fto9rtgcvsx2itzy9rd0gwh7758d64"]},
    # NOTE: the reference stores this one as a set literal (assets.py:61);
    # normalized to a list here.
    "frypan": {"frypan": ["77kk57qyyj3tivpp51tpjw6xia2ds9d9"]},
    "BEHAVE": {"backpack": ["behave_asset"]},
    "INTERCAP": {"suitcase": ["intercap_asset"]},
}

CATEGORY2CAMERA_CONFIG = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": dict(
            ortho_scale=1.75,
            z_scale=0.5,
            bbox_size=(0.6, 0.6, 1.1),
            elevation=15,
            asset_specific_config={
                "0a5a346c-cc3b-4280-b358-ccd1c4d8a865": dict(
                    ortho_scale=1.75,
                    z_scale=0.5,
                    bbox_size=(0.6, 0.6, 1.1),
                    elevation=15,
                )
            },
        )
    },
    "motorcycle,bike": {
        "motorcycle,bike": dict(ortho_scale=1.0, z_scale=0.45, bbox_size=(0.25, 0.25, 0.5))
    },
    "umbrella": {
        "umbrella": dict(
            view_num=4, perturb_sample_num=10, ortho_scale=1.25, z_scale=1.0,
            bbox_size=(0.2, 0.2, 0.4), elevation=15,
        )
    },
    "frypan": {
        "frypan": dict(
            stride_x=0.07, stride_y=0.06, view_num=4, perturb_sample_num=10,
            ortho_scale=1.3, z_scale=10.0, bbox_size=(0.15, 0.15, 0.3), elevation=15,
        ),
    },
    "cart": {
        "cart": dict(
            stride_x=0.075, stride_y=0.075, ortho_scale=1.5, z_scale=0.6,
            bbox_size=(0.3, 0.3, 0.7), elevation=15,
        ),
    },
    "BEHAVE": {
        "backpack": dict(
            stride_x=0.2, stride_y=0.2, view_num=4, perturb_sample_num=10,
            ortho_scale=2.0, z_scale=2.0, bbox_size=(0.45, 0.45, 0.95), elevation=15,
        ),
    },
    "INTERCAP": {
        "suitcase": dict(
            stride_x=0.15, stride_y=0.15, view_num=4, ortho_scale=1.2, z_scale=1.0,
            bbox_size=(0.5, 0.5, 1.0), elevation=15,
        ),
    },
}

CATEGORY2MASK_FILTER_CONFIG = {
    "Chair": {
        "Lounge Chair / Cafe Chair / Office Chair": dict(
            minimum_seg_overlap_ratio=0.8, maximum_seg_overlap_ratio=0.9
        )
    },
    "umbrella": {
        "umbrella": dict(minimum_seg_overlap_ratio=0.7, maximum_seg_overlap_ratio=0.9)
    },
    "frypan": {
        "frypan": dict(minimum_seg_overlap_ratio=0.1, maximum_seg_overlap_ratio=0.5),
    },
    "cart": {
        "cart": dict(minimum_seg_overlap_ratio=0.21, maximum_seg_overlap_ratio=0.6),
    },
    "BEHAVE": {
        "backpack": dict(minimum_seg_overlap_ratio=0.55, maximum_seg_overlap_ratio=0.59),
    },
    "INTERCAP": {
        "suitcase": dict(minimum_seg_overlap_ratio=0.3, maximum_seg_overlap_ratio=0.4),
    },
}

CATEGORY2PERTURB_CONFIG = {
    "Chair": {"Lounge Chair / Cafe Chair / Office Chair": dict(need_perturb=False)},
    "umbrella": {
        "umbrella": dict(
            need_perturb=True,
            rotation_x=[[-20, 20]],
            rotation_y=[[-20, 20]],
            displacement_z=[[1.1, 1.2]],
        )
    },
    "frypan": {
        "frypan": dict(
            need_perturb=True,
            rotation_x=[[-10, 10]],
            rotation_y=[[-10, 10]],
            displacement_z=[[10.0, 11.0]],
        )
    },
    "cart": {"cart": dict(need_perturb=False)},
    "BEHAVE": {
        "backpack": dict(
            need_perturb=True,
            rotation_x=[[-5, 5]],
            rotation_y=[[-5, 5]],
            displacement_z=[[1.73, 1.83]],
        ),
    },
    "INTERCAP": {
        "suitcase": dict(need_perturb=True, rotation_x=[[-45, 45]]),
    },
}


def resolve_asset_obj_path(
    dataset_type: str,
    supercategory: str,
    category: str,
    asset_id: str,
    disable_lowres_switch_for_behave: bool = False,
    dataset_pths: Optional[Dict[str, str]] = None,
) -> str:
    """Per-dataset .obj path layout (reference: ``downsample_objects.py:93-130``)."""
    dataset_dir = (dataset_pths or DATASET_PTHS)[dataset_type]
    if dataset_type == "BEHAVE":
        if disable_lowres_switch_for_behave:
            return f"{dataset_dir}/objects/{category}/{category}.obj"
        return f"{dataset_dir}/objects/{category}/{category}_canon_lowres_in_gen_coord.obj"
    if dataset_type == "INTERCAP":
        return f"{dataset_dir}/objects/{category}/mesh.obj"
    if dataset_type == "SHAPENET":
        with open(f"{dataset_dir}/taxonomy.json", "r") as fh:
            taxonomy = json.load(fh)
        synset = next(c for c in taxonomy if c["name"] == category)["synsetId"]
        return f"{dataset_dir}/{synset}/{asset_id}/models/model_normalized.obj"
    if dataset_type == "3D-FUTURE":
        return f"{dataset_dir}/{asset_id}/raw_model.obj"
    if dataset_type in ("SKETCHFAB", "SAPIEN"):
        return f"{dataset_dir}/{supercategory}/{asset_id}/model.obj"
    raise ValueError(f"unknown dataset_type: {dataset_type}")


def _load_categories_module(dataset_dir: str):
    """Load ``{dataset_dir}/categories.py`` (the 3D-FUTURE / SketchFab /
    SAPIEN metadata module the reference imports by dotted path,
    ``render_objects.py:372-373,501,676``)."""
    import importlib.util

    pth = os.path.join(dataset_dir, "categories.py")
    spec = importlib.util.spec_from_file_location("_dataset_categories", pth)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def discover_assets(
    dataset_type: str,
    dataset_pths: Optional[Dict[str, str]] = None,
    restrict_to_whitelist: bool = True,
) -> list:
    """Enumerate a dataset's assets the way the reference's per-dataset
    render adapters do (``render_objects.py:352-719``): returns
    ``[(supercategory, category, asset_id, obj_pth), ...]``.

    - 3D-FUTURE: ``model_info.json`` entries -> ``{model_id}/raw_model.obj``
      (``:381-387``)
    - SHAPENET: ``taxonomy.json`` name->synsetId; texture-bearing models under
      ``{synsetId}/{model_id}/models/model_normalized.obj`` (``:560-585``,
      adapter lines per upstream layout)
    - SKETCHFAB / SAPIEN: ``categories.py`` ``_CATEGORIES_3D`` +
      ``{super-category}/*/model.obj`` (``:501-517``, ``:676-692``)
    - BEHAVE: ``objects/{category}/{category}.obj``, supercategory BEHAVE
      (``:561-576``)
    - INTERCAP: ``objects/{category}/mesh.obj``, supercategory INTERCAP
      (``:620-635``)

    With ``restrict_to_whitelist`` the list is intersected with
    ``CATEGORY2ASSET`` exactly like ``render_from_asset_info:47-49``.
    """
    import glob as _glob

    dataset_dir = (dataset_pths or DATASET_PTHS)[dataset_type]
    out = []
    if dataset_type == "3D-FUTURE":
        with open(os.path.join(dataset_dir, "model_info.json")) as fh:
            infos = json.load(fh)
        for info in infos:
            out.append(
                (
                    info.get("super-category", info.get("supercategory", "")),
                    info.get("category", ""),
                    info["model_id"],
                    f"{dataset_dir}/{info['model_id']}/raw_model.obj",
                )
            )
    elif dataset_type == "SHAPENET":
        with open(os.path.join(dataset_dir, "taxonomy.json")) as fh:
            taxonomy = json.load(fh)
        for entry in taxonomy:
            category, synset = entry["name"], entry["synsetId"]
            for obj in sorted(
                # one entry PER MODEL: glob the canonical obj, not the model
                # dir's contents (models/, images/, *.json would each emit a
                # duplicate render job)
                _glob.glob(f"{dataset_dir}/{synset}/*/models/model_normalized.obj")
            ):  # texture-bearing models only (reference ``:570``)
                model_id = obj.split("/")[-3]
                out.append(
                    (
                        category,
                        category,
                        model_id,
                        f"{dataset_dir}/{synset}/{model_id}/models/model_normalized.obj",
                    )
                )
    elif dataset_type in ("SKETCHFAB", "SAPIEN"):
        mod = _load_categories_module(dataset_dir)
        for info in mod._CATEGORIES_3D:
            sc, cat = info["super-category"], info["category"]
            for pth in sorted(_glob.glob(f"{dataset_dir}/{sc}/*/model.obj")):
                out.append((sc, cat, pth.split("/")[-2], pth))
    elif dataset_type == "BEHAVE":
        for d in sorted(_glob.glob(f"{dataset_dir}/objects/*")):
            cat = d.split("/")[-1]
            out.append(("BEHAVE", cat, "behave_asset", f"{d}/{cat}.obj"))
    elif dataset_type == "INTERCAP":
        for d in sorted(_glob.glob(f"{dataset_dir}/objects/*")):
            cat = d.split("/")[-1]
            out.append(("INTERCAP", cat, "intercap_asset", f"{d}/mesh.obj"))
    else:
        raise ValueError(f"unknown dataset_type: {dataset_type}")

    if restrict_to_whitelist:
        out = [
            (sc, cat, aid, pth)
            for sc, cat, aid, pth in out
            if sc in CATEGORY2ASSET
            and cat in CATEGORY2ASSET[sc]
            and aid in CATEGORY2ASSET[sc][cat]
        ]
    return out


def layered_get(config: Dict[str, Any], *keys, default=None):
    """Layered ``.get()`` fallback chain over nested category configs
    (the reference's per-view -> per-category -> default pattern,
    ``inpaint.py:253-267``)."""
    node = config
    for key in keys:
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node
