"""ComA extraction driver: samples on disk -> aggregated state -> products.

Counterpart of ``coma_tpu/pipelines/extract.py``. Reference parity:
``src/coma/extract_coma.py:run_affordance_extraction:66-503``. Samples are
loaded and prepped on host threads in batches; each batch goes to the device
and is added into accumulators that live there once and are updated in
place: on CUDA by the kernels K1 (contact) and K2 (occupancy), on the CPU by
their plain versions. Over several processes (:func:`aggregate_shards`) each
rank aggregates its shard of the samples, the additive accumulators are
all-reduced, and rank 0 writes the outputs.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from coma_tpu_torch.affordance.io import (
    load_coma_state,
    load_occupancy_state,
    load_pickle,
    save_coma_state,
    save_occupancy_state,
)
from coma_tpu_torch.affordance.state import init_coma_state, init_occupancy_state
from coma_tpu_torch.core.paths import ResultsTree, SampleKey, smplx_downsample_path
from coma_tpu_torch.core.sentinels import is_sentinel
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.ops.contact_kernel import fused_contact_update_batch
from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch
from coma_tpu_torch.parallel.distributed import (
    DistContext,
    allreduce_count,
    allreduce_state,
    process_shard_worklist,
    sync,
    zero_contribution,
)
from coma_tpu_torch.pipelines.affordance_inputs import prepare_affordance_extraction_inputs
from coma_tpu_torch.pipelines.loader import PrefetchingSampleLoader
from coma_tpu_torch.pipelines.products import save_product


def load_postfilter_whitelist(tree: ResultsTree, sc, cat, asset, mainprompt):
    path = tree.postfilter_json(sc, cat, asset, mainprompt)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"postfilter whitelist missing: {path} (run the filter stage first)"
        )
    with open(path, "r") as rf:
        return {tuple(entry) for entry in json.load(rf)}


def collect_scam_samples(
    tree: ResultsTree,
    supercategories: Optional[List[str]],
    categories: Optional[List[str]],
    prompts: Optional[List[str]],
    enable_postfilter: bool,
) -> Dict[tuple, List[SampleKey]]:
    """Group surviving samples by SCAM = (supercategory, category, asset,
    mainprompt) (reference: ``extract_coma.py:147-260``)."""
    scams: Dict[tuple, List[SampleKey]] = {}
    whitelists: Dict[tuple, set] = {}
    for key, path in tree.iter_human_samples(supercategories, categories, prompts):
        if enable_postfilter:
            scam = key.scam
            if scam not in whitelists:
                whitelists[scam] = load_postfilter_whitelist(
                    tree, key.supercategory, key.category, key.asset_id, key.mainprompt
                )
            checker = (key.view_id, key.asset_mask_id, key.prompt, key.inpaint_id)
            if checker not in whitelists[scam]:
                continue
        else:
            payload = load_pickle(path)
            if is_sentinel(payload):
                continue
        scams.setdefault(key.scam, []).append(key)
    return scams


def aggregate_samples_streaming(
    state, keys, prepare_fn, occupancy: bool, batch_size: int = 32,
    num_workers: int = 4,
):
    """Stream samples through a prefetching loader into ``state`` in place:
    the device aggregates batch k while host threads load batch k+1 (the
    reference's loop is strictly serial, ``extract_coma.py:383-425``).
    Each batch is one kernel launch (the slab is the batch).

    Returns (state, num_samples).
    """
    device = state.device
    loader = PrefetchingSampleLoader(
        keys, prepare_fn, batch_size=batch_size, num_workers=num_workers
    )
    n = 0
    for batch in loader:
        to_dev = lambda k: torch.from_numpy(batch[k]).to(device)
        n += int(batch["valid"].sum())
        if occupancy:
            fused_occupancy_update_batch(
                state, to_dev("human_verts"), to_dev("obj_verts"),
                valid=to_dev("valid"), slab=batch_size,
            )
        else:
            fused_contact_update_batch(
                state, to_dev("human_verts"), to_dev("human_normals"),
                to_dev("obj_verts"), to_dev("obj_normals"),
                valid=to_dev("valid"), slab=batch_size,
            )
    return state, n


def aggregate_shards(
    state, keys, prepare_fn, occupancy: bool, ctx: DistContext, batch_size: int = 32,
    num_workers: int = 4,
):
    """This rank's part of a multi-process aggregation, in place.

    The rank aggregates its shard of ``sorted(keys)``
    (:func:`process_shard_worklist`) into its state, the additive
    accumulators are summed over the ranks and the occupancy anchor is
    combined (:func:`allreduce_state`). The carried ``state`` counts once:
    rank 0 aggregates onto it, the other ranks onto zeros. Every rank joins
    every collective, one with an empty shard too. Returns (state, number of
    samples over all ranks), the same on every rank.
    """
    shard = process_shard_worklist(sorted(keys), ctx.rank, ctx.world_size)
    zero_contribution(state, keep=ctx.rank == 0)
    state, n = aggregate_samples_streaming(
        state, shard, prepare_fn, occupancy, batch_size=batch_size, num_workers=num_workers
    )
    n = allreduce_count(n, ctx)   # first: its time is the wait for the slowest rank
    allreduce_state(state, ctx)
    return state, n


def run_affordance_extraction(
    hyperparams: Dict[str, Any],
    hyperparams_key: str,
    supercategories: Optional[List[str]] = None,
    categories: Optional[List[str]] = None,
    prompts: Optional[List[str]] = None,
    results_root: str = "results",
    constants_mesh_dir: str = "./constants/mesh",
    coma_save_dir: Optional[str] = None,
    affordance_save_dir: Optional[str] = None,
    scale_tolerance: float = 3.0,
    skip_done: bool = False,
    verbose: bool = True,
    device="cuda",
    dist: Optional[DistContext] = None,
    batch_size: int = 32,
    timings: Optional[Dict[str, float]] = None,
) -> List[str]:
    """Run extraction for every discovered SCAM on ``device``; returns the
    saved product paths.

    With ``dist`` (``parallel.distributed.initialize()``), on its device:
    each rank aggregates its shard of every SCAM's samples, the
    accumulators are all-reduced, and rank 0 alone writes the pickle, the
    JSON and the product; the other ranks return an empty list. Every rank
    must run the same call.

    ``coma_save_dir`` and ``affordance_save_dir`` are accepted and unused,
    as in ``coma_tpu``: the outputs go where ``results_root``'s tree puts
    them. ``timings`` (optional dict) accumulates phase wall clocks across
    SCAMs: ``aggregate_s`` (load, prep and the device's aggregation, with
    ``dist`` its all-reduce too), ``export_s`` (the state to the host and its
    pickle) and ``product_s`` (the product computed and saved); each phase
    ends in a device synchronisation, so device work is charged to the phase
    that issued it. With ``dist`` only rank 0 adds ``export_s`` and
    ``product_s``."""
    device = resolve_device(dist.device if dist is not None else device)

    def add_time(key: str, t0: float) -> None:
        if timings is not None:
            sync(device)
            timings[key] = timings.get(key, 0.0) + (time.perf_counter() - t0)

    root = dist is None or dist.is_root
    tree = ResultsTree(results_root)
    visualize_type = hyperparams["visualize_type"]
    occupancy = visualize_type == "occupancy"
    quant_mode = hyperparams.get("quant_mode", False)

    human_pth = smplx_downsample_path(hyperparams["human_res"], constants_mesh_dir)
    if not os.path.exists(human_pth):
        # downsample_human collapses any level >= the template's vertex count
        # to the single FULL pickle — follow it
        full_pth = smplx_downsample_path("FULL", constants_mesh_dir)
        if os.path.exists(full_pth):
            human_pth = full_pth
    human_downsample = load_pickle(human_pth)
    H = (
        human_downsample["N_raw"]
        if hyperparams["human_use_downsample_pcd_raw"]
        else human_downsample["N"]
    )

    scams = collect_scam_samples(
        tree, supercategories, categories, prompts, hyperparams["enable_postfilter"]
    )

    saved: List[str] = []
    for scam in sorted(scams.keys()):
        sc, cat, asset, mainprompt = scam
        if quant_mode and mainprompt != "total":
            continue
        keys = scams[scam]

        object_downsample = load_pickle(
            tree.asset_downsample(sc, cat, asset, hyperparams["object_res"])
        )
        O = (
            object_downsample["N_raw"]
            if hyperparams["object_use_downsample_pcd_raw"]
            else object_downsample["N"]
        )

        coma_pickle = tree.coma_pickle(sc, cat, asset, hyperparams_key, mainprompt)
        coma_json = tree.coma_json(sc, cat, asset, hyperparams_key, mainprompt)
        out_dir = tree.affordance_dir(sc, cat, asset, hyperparams_key, mainprompt)

        if skip_done and os.path.exists(coma_pickle):
            if not root:
                continue
            load = load_occupancy_state if occupancy else load_coma_state
            state = load(coma_pickle, device=device)
        else:
            def prepare_one(key):
                return prepare_affordance_extraction_inputs(
                    human_mesh_pth=tree.human_sample(key),
                    human_downsample_metadata=human_downsample,
                    object_downsample_metadata=object_downsample,
                    human_use_downsample_pcd_raw=hyperparams[
                        "human_use_downsample_pcd_raw"
                    ],
                    object_use_downsample_pcd_raw=hyperparams[
                        "object_use_downsample_pcd_raw"
                    ],
                    eps=hyperparams["eps"],
                    standardize_human_scale=hyperparams["standardize_human_scale"],
                    scaler_range=hyperparams["scaler_range"],
                    camera_pth=tree.camera(sc, cat, asset, key.view_id),
                    human_params_pth=tree.human_pred(key),
                )

            if occupancy:
                state = init_occupancy_state(
                    human_res=H,
                    obj_res=O,
                    spatial_res=hyperparams["spatial_res"],
                    scale_tolerance=scale_tolerance,
                    device=device,
                )
            else:
                state = init_coma_state(
                    human_res=H,
                    obj_res=O,
                    normal_res=hyperparams["normal_res"],
                    spatial_grid_size=hyperparams["spatial_grid_size"],
                    spatial_grid_thres=hyperparams["spatial_grid_thres"],
                    normal_gaussian_sigma=hyperparams["normal_gaussian_sigma"],
                    principle_vec=hyperparams["principle_vec"],
                    sub_principle_vec=hyperparams["sub_principle_vec"],
                    eps=hyperparams["eps"],
                    device=device,
                )
            t0 = time.perf_counter()
            if dist is None:
                state, n_samples = aggregate_samples_streaming(
                    state, keys, prepare_one, occupancy, batch_size=batch_size
                )
            else:
                state, n_samples = aggregate_shards(
                    state, keys, prepare_one, occupancy, dist, batch_size=batch_size
                )
            add_time("aggregate_s", t0)
            if not root:
                continue  # rank 0 owns the writes
            if n_samples == 0:
                if verbose:
                    print(f"[extract] {scam}: no surviving samples, skipping")
                continue

            os.makedirs(os.path.dirname(coma_pickle), exist_ok=True)
            t0 = time.perf_counter()
            if occupancy:
                save_occupancy_state(state, coma_pickle)
            else:
                save_coma_state(state, coma_pickle)
            add_time("export_s", t0)
            info = dict(hyperparams)
            info.update(
                H=H, O=O, num_samples=n_samples,
                supercategory=sc, category=cat, asset_id=asset, mainprompt=mainprompt,
            )
            with open(coma_json, "w") as wf:
                json.dump(info, wf, indent=1, default=str)
            if verbose:
                print(f"[extract] {scam}: aggregated {n_samples} samples "
                      f"(H={H}, O={O}) on {device} -> {coma_pickle}")

        if visualize_type != "none":
            t0 = time.perf_counter()
            saved.append(
                save_product(state, visualize_type, hyperparams, object_downsample, out_dir)
            )
            add_time("product_s", t0)
    return saved
