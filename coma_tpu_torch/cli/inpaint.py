"""CLI: adaptive-mask SD inpainting (reference: ``src/generation/inpaint.py``).

Counterpart of ``coma_tpu/cli/inpaint.py``: builds the cross-product work
list (renders x valid masks x prompts x viewpoint augmentations x
``--num_img_per_combination`` seeds), shards it, and runs the adaptive-mask
pipeline batched over images. Runs on ``--device cuda`` (the default; it
raises without a card) or ``--device cpu``.

Weights: ``--random_weights`` runs the full machinery with random weights
made from a seed (outputs are noise); prompts then become token ids without
a tokenizer. The diffusers-weights loader (``--weights_dir``), the SAM and
PointRend modes, the provoke crop, step videos and ``--mesh`` are not ported
yet: each raises ``SystemExit`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from coma_tpu_torch.cli._common import (
    add_common_flags,
    lower_all,
    seed_everything,
    shard_worklist,
)
from coma_tpu_torch.config.prompts import (
    ALLOWED_VIEWPOINT_AUGMENTATIONS,
    HF_MODEL_KEYS,
    NUM_IMG_PER_COMBINATION,
    SC2DIFFUSERCONFIG,
    SCV2DIFFUSERCONFIG,
)
from coma_tpu_torch.core.paths import unflatten
from coma_tpu_torch.device import resolve_device
from coma_tpu_torch.models.diffusion.pipeline import TorchNoise
from coma_tpu_torch.utils.png import read_png, to_gray, to_rgb, write_png

SEGMENTER_CHECKPOINT = (Path(__file__).resolve().parents[2]
                        / "coma_tpu" / "data" / "person_segmenter.npz")
SAM_MODES = ("ps", "ps_ae", "s_pdb_ae", "s_db_ae", "s_ab_ae")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    parser.add_argument("--parallel_num", type=int, default=1)
    parser.add_argument("--parallel_idx", type=int, default=0)
    parser.add_argument("--asset_render_dir", type=str, default="results/generation/renders")
    parser.add_argument("--asset_mask_dir", type=str, default="results/generation/asset_masks")
    parser.add_argument("--valid_mask_dir", type=str, default="results/generation/valid_masks")
    parser.add_argument("--prompt_dir", type=str, default="results/generation/prompts")
    parser.add_argument("--save_dir", type=str, default="results/generation/inpaintings")
    parser.add_argument("--ldm_model_key", type=str, default="realisticvision",
                        choices=list(HF_MODEL_KEYS.keys()))
    parser.add_argument("--adaptive_mask_model_type", type=str, default="p",
                        choices=["p", "baseline", *SAM_MODES])
    parser.add_argument("--weights_dir", type=str, help="converted SD params (not ported yet)")
    parser.add_argument("--sam_weights", type=str)
    parser.add_argument("--person_segmenter", type=str, default="unet",
                        choices=["unet", "pointrend"])
    parser.add_argument("--pointrend_weights", type=str)
    parser.add_argument("--pointrend_fast", action="store_true")
    parser.add_argument("--pointrend_scale_native", action="store_true")
    parser.add_argument("--random_weights", action="store_true")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model configs at 64x64 (hermetic smoke runs)")
    parser.add_argument("--provoke_decode_factor", type=int, default=1,
                        help="decode in-loop x-hat-0 at 1/f resolution (f=1 is "
                             "reference-exact)")
    parser.add_argument("--provoke_crop", type=str, default="0")
    parser.add_argument("--default_ddim_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--num_img_per_combination", type=int, default=NUM_IMG_PER_COMBINATION)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--save_step_video", action="store_true")
    parser.add_argument("--negative_prompt", type=str,
                        default="worst quality, normal quality, low quality, bad anatomy, artifacts, blurry")
    return parser


def check_ported(args) -> None:
    """``SystemExit`` for a mode or flag of ``coma_tpu``'s CLI the port lacks."""
    waits = []
    if args.weights_dir:
        waits.append("--weights_dir waits for ROADMAP Queue 1 item 13a (the diffusers "
                     "weights loader and the CLIP tokenizer)")
    if args.adaptive_mask_model_type in SAM_MODES or args.sam_weights:
        waits.append(f"--adaptive_mask_model_type {args.adaptive_mask_model_type} "
                     "(SAM) waits for ROADMAP Queue 1 item 12 (segmenters)")
    if (args.person_segmenter == "pointrend" or args.pointrend_weights
            or args.pointrend_fast or args.pointrend_scale_native):
        waits.append("--person_segmenter pointrend waits for ROADMAP Queue 1 item 12 "
                     "(segmenters)")
    if args.provoke_crop != "0":
        waits.append("--provoke_crop waits for ROADMAP Queue 1 item 13b (the crop path)")
    if args.save_step_video:
        waits.append("--save_step_video waits for ROADMAP Queue 1 item 13c (step videos)")
    if args.mesh is not None:
        waits.append("--mesh waits for ROADMAP Queue 1 item 13d (multi-GPU inpainting)")
    if waits:
        raise SystemExit("coma_tpu_torch.cli.inpaint: " + "; ".join(waits))
    if not args.random_weights:
        raise SystemExit("pass --random_weights (--weights_dir is not ported yet)")


def build_worklist(args):
    """(render, mask, prompt+aug, inpaint_id) cross product (reference
    ``inpaint.py:188-269``); returns a list of work dicts."""
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)
    work = []
    for vm_pth in sorted(_glob.glob(f"{args.valid_mask_dir}/*/*/*/*.pickle")):
        sc_str, cat_str, asset_id, view_ext = vm_pth.split("/")[-4:]
        supercategory, category = unflatten(sc_str), unflatten(cat_str)
        if supercats and supercategory.lower() not in supercats:
            continue
        if cats and category.lower() not in cats:
            continue
        view_id = view_ext.rsplit(".", 1)[0]
        with open(vm_pth, "rb") as fh:
            valid = pickle.load(fh)
        prompt_pth = f"{args.prompt_dir}/{sc_str}/{cat_str}/{asset_id}/prompts.pickle"
        if not os.path.exists(prompt_pth):
            continue
        with open(prompt_pth, "rb") as fh:
            prompts = pickle.load(fh)["prompts"]

        view_cfg = SCV2DIFFUSERCONFIG.get(supercategory, {}).get(category, {}).get(view_id, {})
        augs = view_cfg.get("view_text", ALLOWED_VIEWPOINT_AUGMENTATIONS)
        sc_cfg = SC2DIFFUSERCONFIG.get(supercategory, {}).get(category, {})
        strength = sc_cfg.get("strength", 1.0)

        render_pth = f"{args.asset_render_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}.png"
        for mask_id in valid["valid_mask_ids"]:
            mask_pth = f"{args.asset_mask_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}/{mask_id}.png"
            for prompt in prompts:
                for aug in augs:
                    full_prompt = prompt if aug == "original" else prompt + aug
                    for inpaint_id in range(args.num_img_per_combination):
                        out = (
                            f"{args.save_dir}/{sc_str}/{cat_str}/{asset_id}/{view_id}/"
                            f"{mask_id}/{full_prompt}/{inpaint_id:05d}.png"
                        )
                        if args.skip_done and os.path.exists(out):
                            continue
                        work.append(dict(
                            render=render_pth, mask=mask_pth, prompt=full_prompt,
                            inpaint_id=inpaint_id, out=out, strength=strength,
                        ))
    return work


def prompt_token_ids(texts) -> np.ndarray:
    """Token ids (N, 77) for a run without a tokenizer. ``coma_tpu`` seeds
    with ``abs(hash(t))``, which Python salts per process; the port seeds
    with ``zlib.crc32`` of the UTF-8 bytes, stable from run to run."""
    ids = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        ids[i] = np.random.default_rng(zlib.crc32(t.encode("utf-8"))).integers(0, 1000, size=77)
    return ids


def load_person_segmenter(random_weights: bool, device, generator: torch.Generator):
    """The in-loop segmenter (``coma_tpu/cli/inpaint.py:265-275``): the
    committed checkpoint, unless ``random_weights`` asks for a hermetic run."""
    from coma_tpu_torch.models.flax_params import load_flax_params
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.utils.checkpoint import load_params

    seg = PersonSegmenter(device=device)
    if not random_weights and SEGMENTER_CHECKPOINT.exists():
        return load_flax_params(seg, load_params(str(SEGMENTER_CHECKPOINT))).eval()
    return init_flax_default_(seg, generator).eval()


def build_pipeline(args, device: torch.device):
    from coma_tpu_torch.models.diffusion.clip_text import (
        CLIPTextConfig,
        CLIPTextEncoder,
        tiny_clip_config,
    )
    from coma_tpu_torch.models.diffusion.pipeline import (
        AdaptiveMaskConfig,
        AdaptiveMaskInpaintPipeline,
    )
    from coma_tpu_torch.models.diffusion.unet import (
        UNet2DCondition,
        UNetConfig,
        tiny_unet_config,
    )
    from coma_tpu_torch.models.diffusion.vae import (
        Decoder,
        Encoder,
        VAEConfig,
        tiny_vae_config,
    )
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import make_person_segment_fn

    res = 64 if args.tiny else 512
    ucfg = tiny_unet_config() if args.tiny else UNetConfig(dtype=torch.bfloat16)
    vcfg = tiny_vae_config() if args.tiny else VAEConfig(dtype=torch.bfloat16)
    ccfg = tiny_clip_config() if args.tiny else CLIPTextConfig()
    g = torch.Generator(device).manual_seed(0)
    unet = init_flax_default_(UNet2DCondition(ucfg, device=device), g).eval()
    enc = init_flax_default_(Encoder(vcfg, device=device), g).eval()
    dec = init_flax_default_(Decoder(vcfg, device=device), g).eval()
    clip = init_flax_default_(CLIPTextEncoder(ccfg, device=device), g).eval()
    seg = load_person_segmenter(args.random_weights, device, g)

    segment_fn = (make_person_segment_fn(seg) if args.adaptive_mask_model_type == "p"
                  else None)
    pipe = AdaptiveMaskInpaintPipeline(
        unet_fn=lambda lat, t, ctx: unet(lat.to(ucfg.dtype), t, ctx.to(ucfg.dtype)).float(),
        vae_encode_fn=lambda img: enc(img.to(vcfg.dtype)).float(),
        vae_decode_fn=lambda lat: dec(lat.to(vcfg.dtype)).float(),
        segment_fn=segment_fn,
        config=AdaptiveMaskConfig(
            num_inference_steps=args.default_ddim_steps,
            guidance_scale=args.guidance_scale,
            use_adaptive_mask=args.adaptive_mask_model_type != "baseline",
            provoke_decode_factor=args.provoke_decode_factor,
        ),
    )

    @torch.no_grad()
    def encode_prompts(texts):
        return clip(torch.from_numpy(prompt_token_ids(texts)).to(device))

    return pipe, encode_prompts, res


def _resize(images: np.ndarray, res: int) -> np.ndarray:
    """uint8 (N, H, W, C) -> float (N, res, res, C) in [0, 255]. PIL's default
    ``resize`` filter is bicubic with a = -0.5; PyTorch's bicubic uses
    a = -0.75, so a render not already at ``res`` differs slightly."""
    x = torch.from_numpy(images).permute(0, 3, 1, 2).float()
    if x.shape[-2:] != (res, res):
        x = F.interpolate(x, size=(res, res), mode="bicubic", align_corners=False,
                          antialias=True).round().clamp(0, 255)
    return x.permute(0, 2, 3, 1).numpy()


def load_batch(chunk, res: int):
    """Renders (B, 3, res, res) in [-1, 1] and masks (B, res, res) in {0, 1}."""
    imgs = np.stack([_resize(to_rgb(read_png(w["render"]))[None], res)[0] for w in chunk])
    masks = np.stack([_resize(to_gray(read_png(w["mask"]))[None, :, :, None], res)[0, :, :, 0]
                      for w in chunk])
    imgs = torch.from_numpy(np.float32(imgs / 127.5 - 1.0)).permute(0, 3, 1, 2)
    masks = torch.from_numpy(np.float32(masks > 127))
    return imgs, masks


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_ported(args)
    seed_everything(args.seed)
    device = resolve_device(args.device)

    work = shard_worklist(build_worklist(args), args.parallel_idx, args.parallel_num)
    if not work:
        print("[inpaint] nothing to do")
        return
    pipe, encode_prompts, res = build_pipeline(args, device)

    for i in range(0, len(work), args.batch_size):
        chunk = work[i : i + args.batch_size]
        imgs, masks = load_batch(chunk, res)
        ctx = encode_prompts([w["prompt"] for w in chunk])
        neg = encode_prompts([args.negative_prompt] * len(chunk))
        # the batch's seed: the global seed and the first item's inpaint_id
        gen = torch.Generator(device).manual_seed(args.seed * 1_000_003 + chunk[0]["inpaint_id"])
        out = pipe.generate(imgs.to(device), masks.to(device), ctx, neg, noise=TorchNoise(gen))
        out_np = (out.permute(0, 2, 3, 1).float().cpu().numpy() * 255).astype(np.uint8)
        for w, img in zip(chunk, out_np):
            os.makedirs(os.path.dirname(w["out"]), exist_ok=True)
            write_png(w["out"], img)
        print(f"[inpaint] {min(i + args.batch_size, len(work))}/{len(work)}")


if __name__ == "__main__":
    main()
