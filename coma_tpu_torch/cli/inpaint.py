"""CLI: adaptive-mask SD inpainting (reference: ``src/generation/inpaint.py``).

Counterpart of ``coma_tpu/cli/inpaint.py``: builds the cross-product work
list (renders x valid masks x prompts x viewpoint augmentations x
``--num_img_per_combination`` seeds), shards it, and runs the adaptive-mask
pipeline batched over images. Runs on ``--device cuda`` (the default; it
raises without a card) or ``--device cpu``.

Weights: ``--weights_dir`` reads a diffusers SD-inpainting directory
(``models/diffusion/weights.py`` names the files) and rebuilds the UNet,
VAE and CLIP around the configs it declares; prompts go through its CLIP
tokenizer. A directory that does not exist raises; there is no fallback to
random weights. ``--random_weights`` runs the full machinery with random
weights made from a seed (outputs are noise); prompts then become token ids
without a tokenizer. ``--provoke_crop {0,auto,<int>}`` runs the provoke
rounds on a latent window around the default mask (``auto`` picks a bucket
per batch, or the full frame).

The in-loop person mask comes from the U-Net segmenter or, with
``--person_segmenter pointrend``, from PointRend R50-FPN (``--pointrend_weights``
a Flax ``.npz``, a detectron2 ``.pkl`` or ``.pth``; ``--pointrend_fast``: bf16
and a stride-4 paste; ``--pointrend_scale_native``: the detector at 512 px).
The five SAM modes (``ps``, ``ps_ae``, ``s_pdb_ae``, ``s_db_ae``,
``s_ab_ae``) refine that mask's box with SAM ViT-B (``--sam_weights`` the
official ``.pth`` or a Flax ``.npz``); as in ``coma_tpu`` they share one
in-loop route. With ``--random_weights`` both segmenters take seeded random
weights; a weights path that does not exist raises. ``--save_step_video``
writes a ``.steps.gif`` beside each batch's first image.

``--mesh N`` runs on N ranks, one process each, launched with torchrun's
variables or ``COMA_COORDINATOR``/``COMA_NUM_PROCESSES``/``COMA_PROCESS_ID``
(``parallel/flagship.py``): whole batches go round-robin to the ranks, so
every image equals the one-process run's. ``--dist_backend nccl`` takes one
card per rank; ``gloo`` lets ranks share a card, or run on the CPU. Each
rank writes its own images; a launch of another size than ``--mesh`` asks
for raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob as _glob
import os
import pickle
import zlib

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
from coma_tpu_torch.models.diffusion.pipeline import (
    AdaptiveMaskInpaintPipeline,
    TorchNoise,
    choose_crop_latent,
)
from coma_tpu_torch.models.segmentation import SEGMENTER_CHECKPOINT
from coma_tpu_torch.parallel import distributed
from coma_tpu_torch.parallel.flagship import rank_batches, resolve_mesh
from coma_tpu_torch.utils.png import read_png, to_gray, to_rgb, write_png

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
    parser.add_argument("--weights_dir", type=str,
                        help="a diffusers SD-inpainting directory (unet/, vae/, text_encoder/, "
                             "tokenizer/)")
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
    parser.add_argument("--provoke_crop", type=str, default="0",
                        help="0 (full frame), auto, or a latent window side")
    parser.add_argument("--default_ddim_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=7.5)
    parser.add_argument("--num_img_per_combination", type=int, default=NUM_IMG_PER_COMBINATION)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--mesh", type=str, default=None,
                        help="'all' or N: the number of ranks this launch has")
    parser.add_argument("--dist_backend", choices=distributed.BACKENDS, default="nccl",
                        help="with --mesh: nccl (one card per rank) or gloo")
    parser.add_argument("--save_step_video", action="store_true")
    parser.add_argument("--negative_prompt", type=str,
                        default="worst quality, normal quality, low quality, bad anatomy, artifacts, blurry")
    return parser


def check_args(args) -> None:
    """``SystemExit`` for weights that are neither given nor asked to be
    random, or that do not exist, and for a bad ``--provoke_crop``."""
    if args.weights_dir and not os.path.isdir(args.weights_dir):
        raise SystemExit(f"--weights_dir {args.weights_dir} does not exist (there is no "
                         "fallback to random weights)")
    if not args.weights_dir and not args.random_weights:
        raise SystemExit("pass --weights_dir or --random_weights")
    for flag, path in (("--sam_weights", args.sam_weights),
                       ("--pointrend_weights", args.pointrend_weights)):
        if path and not os.path.isfile(path):
            raise SystemExit(f"{flag} {path} does not exist (there is no fallback to random "
                             "weights)")
    if args.adaptive_mask_model_type in SAM_MODES and not (args.sam_weights
                                                           or args.random_weights):
        raise SystemExit(f"'{args.adaptive_mask_model_type}' needs --sam_weights (or "
                         "--random_weights for a mechanical smoke run)")
    if args.person_segmenter == "pointrend" and not (args.pointrend_weights
                                                     or args.random_weights):
        raise SystemExit("--person_segmenter pointrend needs --pointrend_weights (or "
                         "--random_weights)")
    if args.provoke_crop != "auto" and not args.provoke_crop.isdigit():
        raise SystemExit(f"--provoke_crop takes 0, auto or a window side, not "
                         f"{args.provoke_crop!r}")


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


def pointrend_config(args):
    """The in-loop detector's config (``coma_tpu/cli/inpaint.py:232-244``): 20
    padded detections in the loop, which needs only the merged mask."""
    from coma_tpu_torch.models.pointrend import PointRendConfig

    if args.tiny:
        return PointRendConfig(max_detections=4, test_size=64, pre_nms_topk=64,
                               post_nms_topk=32, box_candidates=32)
    if args.pointrend_scale_native:
        return PointRendConfig(test_size=512, pre_nms_topk=256, post_nms_topk=128,
                               box_candidates=64, max_detections=8)
    return PointRendConfig(max_detections=20)


def build_person_fn(args, device, generator: torch.Generator):
    """``images (B, 3, H, W) -> (B, H, W)`` person masks: the U-Net segmenter,
    or PointRend with its weights (seed 2 with ``--random_weights``, drawn on
    the CPU so every device gets the same ones)."""
    from coma_tpu_torch.models.segmentation import make_person_segment_fn

    if args.person_segmenter != "pointrend":
        return make_person_segment_fn(load_person_segmenter(args.random_weights, device,
                                                            generator))
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.pointrend import PointRendModel, make_pointrend_segment_fn
    from coma_tpu_torch.models.segmenter_weights import load_pointrend_weights

    model = PointRendModel(pointrend_config(args))
    if args.pointrend_weights:
        load_pointrend_weights(model, args.pointrend_weights)
    else:
        init_flax_default_(model, torch.Generator().manual_seed(2))
    return make_pointrend_segment_fn(
        model.to(device).eval(), compute_dtype=torch.bfloat16 if args.pointrend_fast else None,
        paste_stride=4 if args.pointrend_fast else 1)


def build_sam(args, device):
    """SAM ViT-B (``tiny_sam_config`` with ``--tiny``) from ``--sam_weights``,
    or seeded random weights (seed 1, drawn on the CPU)."""
    from coma_tpu_torch.models.sam import SAM, SAMConfig, init_sam_random_, tiny_sam_config
    from coma_tpu_torch.models.segmenter_weights import load_sam_weights

    sam = SAM(tiny_sam_config() if args.tiny else SAMConfig())
    if args.sam_weights:
        load_sam_weights(sam, args.sam_weights)
    else:
        init_sam_random_(sam, torch.Generator().manual_seed(1))
    return sam.to(device).eval()


def build_pipeline(args, device: torch.device):
    """(pipeline, prompt encoder, resolution). With ``--weights_dir`` the UNet
    (bf16), the VAE and the CLIP text tower are rebuilt around the configs
    the directory declares (``coma_tpu/cli/inpaint.py:187-203``; the VAE's
    layout from ``vae/config.json`` where ``coma_tpu`` keeps its own), else
    made from seed 0."""
    from coma_tpu_torch.models.diffusion import weights
    from coma_tpu_torch.models.diffusion.clip_text import (
        CLIPTextConfig,
        CLIPTextEncoder,
        tiny_clip_config,
    )
    from coma_tpu_torch.models.diffusion.pipeline import AdaptiveMaskConfig
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
    from coma_tpu_torch.models.sam import make_sam_segment_fn

    res = 64 if args.tiny else 512
    ucfg = tiny_unet_config() if args.tiny else UNetConfig(dtype=torch.bfloat16)
    vcfg = tiny_vae_config() if args.tiny else VAEConfig(dtype=torch.bfloat16)
    ccfg = tiny_clip_config() if args.tiny else CLIPTextConfig()
    g = torch.Generator(device).manual_seed(0)
    tokenizer = None
    if args.weights_dir:
        params = weights.load_sd_params(
            args.weights_dir, vae_config=weights.infer_vae_config(args.weights_dir, vcfg))
        ucfg = dataclasses.replace(params["unet_config"], dtype=torch.bfloat16)
        vcfg, ccfg = params["vae_config"], params["clip_config"]
        unet = weights.load_state(UNet2DCondition(ucfg, device=device), params["unet"])
        enc = weights.load_state(Encoder(vcfg, device=device), params["vae_encoder"])
        dec = weights.load_state(Decoder(vcfg, device=device), params["vae_decoder"])
        clip = weights.load_state(CLIPTextEncoder(ccfg, device=device), params["clip"])
        tokenizer = params["tokenizer"]
        del params
    else:
        unet = init_flax_default_(UNet2DCondition(ucfg, device=device), g)
        enc = init_flax_default_(Encoder(vcfg, device=device), g)
        dec = init_flax_default_(Decoder(vcfg, device=device), g)
        clip = init_flax_default_(CLIPTextEncoder(ccfg, device=device), g)
    for m in (unet, enc, dec, clip):
        m.eval()
    mode = args.adaptive_mask_model_type
    segment_fn = None
    if mode != "baseline":
        segment_fn = build_person_fn(args, device, g)
    if mode in SAM_MODES:
        # person mask -> its box prompts SAM, in the loop (coma_tpu/cli/inpaint.py:276-314)
        segment_fn = make_sam_segment_fn(build_sam(args, device), segment_fn)
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
        ids = prompt_token_ids(texts) if tokenizer is None else tokenizer(texts)
        return clip(torch.from_numpy(np.asarray(ids, np.int64)).to(device))

    return pipe, encode_prompts, res


def provoke_crop_for(args, masks: np.ndarray, vae_scale: int) -> int:
    """The batch's crop (``coma_tpu/cli/inpaint.py:427-450``): ``auto`` picks
    the smallest fitting bucket, or 0 when none fits or the window is near
    full-frame; an explicit side must cover every default-mask box plus the
    decoder's halo, else ``SystemExit``."""
    if args.provoke_crop == "auto":
        crop = choose_crop_latent(masks, vae_scale=vae_scale)
        if crop == 0:
            print("  provoke_crop auto: declined (bbox near-full-frame or no bucket fits); "
                  "using the full-frame path")
        return crop
    crop = int(args.provoke_crop)
    if crop:
        need = choose_crop_latent(masks, vae_scale=vae_scale, max_area_ratio=1.0)
        if need == 0 or need > crop:
            raise SystemExit(
                f"--provoke_crop {crop} is smaller than this batch's default-mask bbox + "
                f"decoder halo (needs {'full-frame' if need == 0 else f'>= {need}'}); "
                "use --provoke_crop auto")
    return crop


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
    check_args(args)
    n_ranks = resolve_mesh(args.mesh)
    seed_everything(args.seed)
    if n_ranks > 1:
        ctx = distributed.initialize(args.dist_backend, args.device)
    else:
        ctx = distributed.DistContext(0, 1, 0, None, resolve_device(args.device))
    try:
        run(args, ctx)
    finally:
        distributed.shutdown(ctx)


def run(args, ctx: distributed.DistContext) -> None:
    """This rank's batches of the work list, then a barrier."""
    device = ctx.device
    work = shard_worklist(build_worklist(args), args.parallel_idx, args.parallel_num)
    if not work:
        print("[inpaint] nothing to do")
        return
    pipe, encode_prompts, res = build_pipeline(args, device)

    for i in rank_batches(len(work), args.batch_size, ctx.rank, ctx.world_size):
        chunk = work[i : i + args.batch_size]
        imgs, masks = load_batch(chunk, res)
        ctx_emb = encode_prompts([w["prompt"] for w in chunk])
        neg = encode_prompts([args.negative_prompt] * len(chunk))
        crop = provoke_crop_for(args, masks.numpy(), pipe.config.vae_scale)
        run_pipe = pipe if not crop else AdaptiveMaskInpaintPipeline(
            pipe.unet_fn, pipe.vae_encode_fn, pipe.vae_decode_fn, pipe.segment_fn,
            dataclasses.replace(pipe.config, provoke_crop_latent=crop), pipe.vae_scaling)
        # the batch's seed: the global seed and the first item's inpaint_id
        gen = torch.Generator(device).manual_seed(args.seed * 1_000_003 + chunk[0]["inpaint_id"])
        out = run_pipe.generate(imgs.to(device), masks.to(device), ctx_emb, neg,
                                noise=TorchNoise(gen), return_intermediates=args.save_step_video)
        if args.save_step_video:
            from coma_tpu_torch.visualization.video import write_adaptive_mask_video

            out, inter = out
            gif = chunk[0]["out"].rsplit(".", 1)[0] + ".steps.gif"
            os.makedirs(os.path.dirname(gif), exist_ok=True)
            write_adaptive_mask_video(inter, run_pipe.vae_decode_fn, gif, sample=0,
                                      every=max(1, args.default_ddim_steps // 16))
        out_np = (out.permute(0, 2, 3, 1).float().cpu().numpy() * 255).astype(np.uint8)
        for w, img in zip(chunk, out_np):
            os.makedirs(os.path.dirname(w["out"]), exist_ok=True)
            write_png(w["out"], img)
        if ctx.is_root:
            print(f"[inpaint] {min(i + args.batch_size, len(work))}/{len(work)}")
    distributed.barrier(ctx)


if __name__ == "__main__":
    main()
