"""Post-filtering of optimized 3D HOI samples into JSON whitelists.

A copy of ``coma_tpu/pipelines/postfilter.py`` (host only). Reference parity:
``src/coma/filter.py:run_post_filtering:12-124`` — reject samples by
silhouette IoU, boolean-intersection volume ratio, and RANSAC inlier count;
emit per-(supercategory, category, asset[, prompt]) JSON lists of surviving
[view_id, asset_mask_id, prompt, inpaint_id] tuples.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from coma_tpu_torch.affordance.io import load_pickle
from coma_tpu_torch.core.paths import ResultsTree, flatten
from coma_tpu_torch.core.sentinels import is_sentinel


def run_post_filtering(
    supercategories: Optional[List[str]] = None,
    categories: Optional[List[str]] = None,
    prompts: Optional[List[str]] = None,
    results_root: str = "results",
    save_dir: Optional[str] = None,
    IoU_threshold_min: float = 0.7,
    intersection_volume_ratio_threshold_max: float = 0.05,
    inlier_num_threshold_min: int = 1,
    enable_aggregate_total_prompts: bool = False,
    verbose: bool = True,
) -> Dict[str, int]:
    """Returns the rejection statistics (also printed, as the reference does)."""
    tree = ResultsTree(results_root)
    save_dir = save_dir or f"{results_root}/coma/human_postfilterings"

    rejected_iou = rejected_intersection = rejected_inliers = num_mesh = 0
    to_save: Dict[tuple, List[list]] = {}

    for key, path in tree.iter_human_samples(supercategories, categories, prompts):
        base_prompt = key.prompt.split(",")[0]
        # only the allowed viewpoint augmentations survive (reference:
        # filter.py:48-50 — suffix must be ', full body' or empty)
        if key.prompt.replace(base_prompt, "") not in [", full body", ""]:
            continue
        is_total = key.prompt.startswith("total")
        if enable_aggregate_total_prompts != is_total:
            continue

        group = (
            (key.supercategory, key.category, key.asset_id)
            if enable_aggregate_total_prompts
            else (key.supercategory, key.category, key.asset_id, base_prompt)
        )
        to_save.setdefault(group, [])

        payload = load_pickle(path)
        if is_sentinel(payload):
            continue
        num_mesh += 1

        # NOTE: 'interscetion_ratio' [sic] is the reference's on-disk key
        # (compute_metrics.py:237-247); keep it for artifact compatibility.
        iou = payload["IoU"]
        intersection_ratio = payload.get(
            "interscetion_ratio", payload.get("intersection_ratio")
        )
        num_inliers = payload.get("num_inliers")

        if iou < IoU_threshold_min:
            rejected_iou += 1
            continue
        if intersection_ratio > intersection_volume_ratio_threshold_max:
            rejected_intersection += 1
            continue
        if num_inliers is not None and num_inliers < inlier_num_threshold_min:
            rejected_inliers += 1
            continue

        to_save[group].append(
            [key.view_id, key.asset_mask_id, key.prompt, key.inpaint_id]
        )

    for group, survivors in to_save.items():
        # paths use the flattened ('/'->':') names, consistently with the
        # extract stage's whitelist lookup (reference: filter.py:102-105
        # writes the path-split strings, extract_coma.py:48 reads them)
        if enable_aggregate_total_prompts:
            sc, cat, asset = group
            save_pth = f"{save_dir}/{flatten(sc)}/{flatten(cat)}/{asset}/total.json"
        else:
            sc, cat, asset, base_prompt = group
            save_pth = f"{save_dir}/{flatten(sc)}/{flatten(cat)}/{asset}/{base_prompt}.json"
        os.makedirs(os.path.dirname(save_pth), exist_ok=True)
        with open(save_pth, "w") as wf:
            json.dump(survivors, wf, indent=1)

    stats = dict(
        rejected_iou=rejected_iou,
        rejected_intersection=rejected_intersection,
        rejected_inliers=rejected_inliers,
        initial=num_mesh,
        leftover=num_mesh - (rejected_iou + rejected_intersection + rejected_inliers),
    )
    if verbose:
        print("================ POST-FILTERING RESULTS ================")
        print(f"1. REJECTED FROM IoU: {rejected_iou}")
        print(f"2. REJECTED FROM INTERSECTION: {rejected_intersection}")
        print(f"3. REJECTED FROM INLIERS: {rejected_inliers}")
        print(f"4. INITIAL MESHES: {num_mesh}")
        print(f"5. LEFTOVER MESHES: {stats['leftover']}")
        print("========================================================")
    return stats
