"""CLI: segment humans in inpainted images (reference: ``src/generation/segment_human.py``).

Counterpart of ``coma_tpu/cli/segment_human.py``, the first step of stage
2: every inpainted PNG of the 7-level tree
(``<inpaint_dir>/<supercategory>/<category>/<asset>/<view>/<mask>/<prompt>/
<id>.png``) that passes the filters goes through a person segmenter, and
its instances are saved as a pickle of plain numpy: ``pred_masks`` bool (N,
H, W), ``pred_boxes`` float32 (N, 4), ``scores`` float32 (N,),
``pred_classes`` int64 (N,) and ``image_size`` (H, W), keeping the
instances scored at least ``--threshold``.

``--segmenter unet`` (the default) runs the U-Net at its training scale
(the committed ``coma_tpu/data/person_segmenter.npz``, read by path, or
``--segmenter_params``) and splits its mask into connected components of at
least 64 pixels, each scored by its mean probability. ``--segmenter
pointrend`` runs PointRend R50-FPN (``--segmenter_params``: a Flax ``.npz``,
a detectron2 ``.pkl`` or ``.pth``) per image and pastes its person masks.
PNGs are read with ``utils/png.py``. Runs on ``--device cuda`` (the
default; it raises without a card) or ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle

import numpy as np
import torch

from coma_tpu_torch.cli._common import (
    add_common_flags,
    lower_all,
    seed_everything,
    shard_worklist,
)
from coma_tpu_torch.config.segmentation import run_mode_supported
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.models.segmentation import SEGMENTER_CHECKPOINT
from coma_tpu_torch.utils.image_io import read_image


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--prompts", type=str, nargs="+")
    parser.add_argument("--inpaint_dir", type=str, default="results/generation/inpaintings")
    parser.add_argument("--save_dir", type=str, default="results/generation/human_segs")
    parser.add_argument("--segmenter", type=str, default="unet", choices=["unet", "pointrend"])
    parser.add_argument("--segmenter_params", type=str,
                        help="weights: .npz (Flax layout) or a pickle for unet; .npz, .pkl or "
                             ".pth for pointrend")
    parser.add_argument("--mode", type=str, default="coco", choices=["coco", "lvis", "odise"],
                        help="category vocabulary; only 'coco' is implemented (as in the "
                             "reference)")
    parser.add_argument("--threshold", type=float, default=0.8)
    parser.add_argument("--only_full_body_prompts", action="store_true", default=False)
    parser.add_argument("--batch_size", type=int, default=16)
    return parser


def build_worklist(args) -> list:
    """(PNG, output pickle) pairs of the tree that pass the filters."""
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)
    prompts = lower_all(args.prompts)
    work = []
    for p in sorted(_glob.glob(f"{args.inpaint_dir}/*/*/*/*/*/*/*.png")):
        sc_str, cat_str, asset, view, mask_id, prompt, fname = p.split("/")[-7:]
        if supercats and sc_str.replace(":", "/").lower() not in supercats:
            continue
        if cats and cat_str.replace(":", "/").lower() not in cats:
            continue
        if prompts and prompt.split(",")[0].lower() not in prompts:
            continue
        if args.only_full_body_prompts and "full body" not in prompt:
            continue
        out = (f"{args.save_dir}/{sc_str}/{cat_str}/{asset}/{view}/{mask_id}/{prompt}/"
               f"{fname.replace('.png', '.pickle')}")
        if args.skip_done and os.path.exists(out):
            continue
        work.append((p, out))
    return shard_worklist(work, args.parallel_idx, args.parallel_num)


def load_segmenter(params_path, device):
    """The U-Net from ``params_path`` (``.npz``, else a pickled Flax tree), the
    committed checkpoint when none is given, or seeded random weights (with a
    warning) when the file is missing."""
    from coma_tpu_torch.models.flax_params import load_flax_params
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.utils.checkpoint import load_params

    model = PersonSegmenter()
    if not params_path and SEGMENTER_CHECKPOINT.exists():
        params_path = str(SEGMENTER_CHECKPOINT)
    if params_path and os.path.exists(params_path):
        if params_path.endswith(".npz"):
            tree = load_params(params_path)
        else:
            with open(params_path, "rb") as fh:
                tree = pickle.load(fh)
        load_flax_params(model, tree)
    else:
        init_flax_default_(model, torch.Generator().manual_seed(0))
        if params_path:
            print(f"[segment_human] WARNING: {params_path} missing; random init")
    return model.to(device).eval()


def instance_payload(instances, hw, threshold: float) -> dict:
    """The pickle's dict, instances scored below ``threshold`` dropped."""
    payload = dict(
        pred_masks=(np.stack([x["mask"] for x in instances]) if instances
                    else np.zeros((0,) + hw, bool)),
        pred_boxes=(np.stack([x["bbox"] for x in instances]) if instances
                    else np.zeros((0, 4), np.float32)),
        scores=np.asarray([x["score"] for x in instances], np.float32),
        pred_classes=np.zeros(len(instances), np.int64),
    )
    keep = payload["scores"] >= threshold
    payload = {k: v[keep] for k, v in payload.items()}
    payload["image_size"] = hw
    return payload


def main(argv=None) -> None:
    from coma_tpu_torch.models.segmentation import connected_instances, person_probs_canonical

    args = build_parser().parse_args(argv)
    if not run_mode_supported(args.mode):
        raise NotImplementedError(
            f"segmentation mode {args.mode!r} (the reference raises for lvis/odise too)")
    seed_everything(args.seed)
    device = resolve_device(args.device)
    work = build_worklist(args)

    if args.segmenter == "pointrend":
        from coma_tpu_torch.models.pointrend import (
            PointRendConfig,
            PointRendModel,
            PointRendPersonSegmenter,
        )
        from coma_tpu_torch.models.segmenter_weights import load_pointrend_weights

        if not (args.segmenter_params and os.path.exists(args.segmenter_params)):
            raise SystemExit("--segmenter pointrend needs --segmenter_params (a Flax .npz, or "
                             "the published model_final_edd263.pkl)")
        model = load_pointrend_weights(PointRendModel(PointRendConfig()), args.segmenter_params)
        predictor = PointRendPersonSegmenter(model.to(device))
    else:
        unet = load_segmenter(args.segmenter_params, device)
        predictor = None

    for i in range(0, len(work), args.batch_size):
        chunk = work[i: i + args.batch_size]
        imgs = np.stack([read_image(p, "RGB").astype(np.float32) / 255.0 for p, _ in chunk])
        if predictor is not None:
            per_image = [predictor(im) for im in imgs]
        else:
            with torch.no_grad():
                x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(device)
                probs = person_probs_canonical(unet, x).cpu().numpy()
            per_image = []
            for prob in probs:
                instances = connected_instances((prob >= 0.5).astype(np.float32))
                for inst in instances:
                    inst["score"] = float(prob[inst["mask"]].mean())
                    inst["pred_class"] = 0
                per_image.append(instances)
        for (src, out), instances, img in zip(chunk, per_image, imgs):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "wb") as fh:
                pickle.dump(instance_payload(instances, img.shape[:2], args.threshold), fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
    print(f"[segment_human] wrote {len(work)} instance pickles")


if __name__ == "__main__":
    main()
