"""CLI: regress 3D humans from segmented inpaintings
(reference: ``src/generation/predict_human.py``).

Counterpart of ``coma_tpu/cli/predict_human.py``. Per image: the instance
pickle of ``segment_human`` de-duplicated (``pipelines/postprocess.py``),
0 or >= 2 people rejected with the reference's sentinels ("NO HUMANS" /
"MORE THAN 2 HUMANS", ``predict_human.py:206-213``), else SMPL-X regressed
by Hand4Whole from the PNG (read by ``utils/png.py``) and saved as verts,
faces, pelvis, SMPL-X parameters, projected joints, 3-D pixel joints and
``convert_data`` (``:221-242``), one pickle per image under the main
prompt.

``--regressor_params``: a Flax ``.npz`` params store or pickled tree, or
the published torch checkpoint (``snapshot_6.pth.tar``, its ``network``
layout read directly); without it the regressor is made from seed 0.
``--smplx_model_path``: the SMPL-X npz; without it a synthetic body of
SMPL-X's 10475 vertices. Runs on ``--device cuda`` (the default; it raises
without a card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle

import torch

from coma_tpu_torch.cli._common import (
    add_common_flags,
    lower_all,
    seed_everything,
    shard_worklist,
)
from coma_tpu_torch.core.sentinels import MORE_THAN_2_HUMANS, NO_HUMANS
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.pipelines.postprocess import bbox_xyxy_to_xywh, process_segmentation


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--inpaint_dir", type=str, default="results/generation/inpaintings")
    parser.add_argument("--human_seg_dir", type=str, default="results/generation/human_segs")
    parser.add_argument("--save_dir", type=str, default="results/generation/human_preds")
    parser.add_argument("--regressor_params", type=str,
                        help="Hand4Whole weights: a Flax .npz or pickle, or the published "
                             "snapshot_6.pth.tar")
    parser.add_argument("--smplx_model_path", type=str, help="SMPLX_NEUTRAL.npz")
    return parser


def load_regressor(args, device):
    from coma_tpu_torch.models.hand4whole import Hand4Whole, load_hand4whole_weights
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.smplx import SMPLXModel, random_model
    from coma_tpu_torch.pipelines.mocap import Hand4WholeRegressor

    model = Hand4Whole()
    store = args.regressor_params
    if store and not store.endswith(".npz") and os.path.exists(store + ".npz"):
        store = store + ".npz"
    if store and os.path.exists(store):
        load_hand4whole_weights(model, store)
    else:
        init_flax_default_(model, torch.Generator().manual_seed(0))
        if store:
            print("[predict_human] WARNING: regressor params missing; random init")
    if args.smplx_model_path and os.path.exists(args.smplx_model_path):
        smplx_model = SMPLXModel.from_npz(args.smplx_model_path, device=device)
    else:
        # SMPL-X's vertex count: the downsample indices and the star template
        # downstream assume it
        smplx_model = random_model(num_verts=10475, num_betas=10, num_expr=10, device=device)
        print("[predict_human] WARNING: SMPL-X weights missing; synthetic body model")
    return Hand4WholeRegressor(model.to(device), smplx_model)


def build_worklist(args) -> list:
    """(instance pickle, PNG, output pickle) triples that pass the filters."""
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)
    prompts = lower_all(args.prompts)
    work = []
    for p in sorted(_glob.glob(f"{args.human_seg_dir}/*/*/*/*/*/*/*.pickle")):
        sc_str, cat_str, asset, view, mask_id, prompt, fname = p.split("/")[-7:]
        if supercats and sc_str.replace(":", "/").lower() not in supercats:
            continue
        if cats and cat_str.replace(":", "/").lower() not in cats:
            continue
        if prompts and prompt.split(",")[0].lower() not in prompts:
            continue
        # predictions are grouped by the main prompt (reference path schema)
        mainprompt = prompt.split(",")[0]
        out = f"{args.save_dir}/{sc_str}/{cat_str}/{asset}/{view}/{mask_id}/{mainprompt}/{fname}"
        if args.skip_done and os.path.exists(out):
            continue
        img = (f"{args.inpaint_dir}/{sc_str}/{cat_str}/{asset}/{view}/{mask_id}/{prompt}/"
               f"{fname.replace('.pickle', '.png')}")
        work.append((p, img, out))
    return shard_worklist(work, args.parallel_idx, args.parallel_num)


def main(argv=None) -> dict:
    from coma_tpu_torch.utils.image_io import read_image

    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    device = resolve_device(args.device)
    work = build_worklist(args)

    regressor = load_regressor(args, device)
    n_ok = n_sentinel = 0
    for seg_pth, img_pth, out in work:
        with open(seg_pth, "rb") as fh:
            seg = pickle.load(fh)
        keep = process_segmentation(seg["pred_classes"], seg["pred_boxes"], seg["scores"])
        person_idx = [i for i in keep if seg["pred_classes"][i] == 0]

        os.makedirs(os.path.dirname(out), exist_ok=True)
        payload = NO_HUMANS
        if len(person_idx) >= 2:
            payload = MORE_THAN_2_HUMANS
        elif len(person_idx) == 1:
            image = read_image(img_pth, "RGB")
            bbox_xywh = bbox_xyxy_to_xywh(seg["pred_boxes"][person_idx[0]])
            outs = regressor.regress(image, [bbox_xywh])
            if outs:
                m = outs[0]
                payload = dict(
                    verts=m.pred_vertices_img, faces=m.faces, pelvis=m.pelvis_xyz,
                    smplx_data=m.smplx_data, joints_proj=m.joints_proj,
                    joints_img=m.joints_img,  # 3-D pixel joints: optimize_depth lifts them
                    convert_data=m.convert_data,
                )
        if isinstance(payload, str):
            n_sentinel += 1
        else:
            n_ok += 1
        with open(out, "wb") as fh:
            pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"[predict_human] {n_ok} humans regressed, {n_sentinel} sentinels")
    return dict(regressed=n_ok, sentinels=n_sentinel)


if __name__ == "__main__":
    main()
