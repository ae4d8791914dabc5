"""CLI: HOI prompt generation (reference: ``src/generation/generate_prompts.py``;
counterpart of ``coma_tpu/cli/generate_prompts.py``).

Default: per-asset human-defined prompts (``config/prompts.py``). With
``--use_vlm`` and an OpenAI-compatible endpoint configured via env
(OPENAI_API_KEY / OPENAI_BASE_URL), queries a VLM with the rendered image at
temperature 0 / fixed seed, as the reference does with GPT-4o. No device
work.
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle

from coma_tpu_torch.cli._common import add_host_flags, lower_all, seed_everything
from coma_tpu_torch.config.prompts import HUMAN_DEFINED_PROMPTS, PROMPT_GENERATION_TEXT
from coma_tpu_torch.core.paths import unflatten


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_host_flags(parser)
    parser.add_argument("--asset_render_dir", type=str, default="results/generation/renders")
    parser.add_argument("--save_dir", type=str, default="results/generation/prompts")
    parser.add_argument("--use_vlm", action="store_true")
    parser.add_argument("--selected_view", type=int, default=0)
    parser.add_argument("--vlm_model", type=str, default="gpt-4o")
    return parser


def vlm_prompts(image_path: str, model: str, seed: int) -> list:
    """Query an OpenAI-compatible VLM (reference: ``generate_prompts.py:52-57``)."""
    import base64

    from openai import OpenAI  # optional dependency; gated by --use_vlm

    with open(image_path, "rb") as fh:
        b64 = base64.b64encode(fh.read()).decode("utf-8")
    client = OpenAI()
    response = client.chat.completions.create(
        model=model,
        messages=[{
            "role": "user",
            "content": [
                {"type": "text", "text": PROMPT_GENERATION_TEXT},
                {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}},
            ],
        }],
        temperature=0.0,
        seed=seed,
    )
    raw = response.choices[0].message.content
    return [p[p.find("1 person"):].rstrip(".") for p in raw.split("\n") if "1 person" in p]


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    seed_everything(args.seed)
    supercats, cats = lower_all(args.supercategories), lower_all(args.categories)

    for asset_dir in sorted(_glob.glob(f"{args.asset_render_dir}/*/*/*")):
        sc_str, cat_str, asset_id = asset_dir.split("/")[-3:]
        supercategory, category = unflatten(sc_str), unflatten(cat_str)
        if supercats and supercategory.lower() not in supercats:
            continue
        if cats and category.lower() not in cats:
            continue

        save_pth = f"{args.save_dir}/{sc_str}/{cat_str}/{asset_id}/prompts.pickle"
        if args.skip_done and os.path.exists(save_pth):
            continue

        if args.use_vlm:
            img = f"{asset_dir}/view:{args.selected_view:05d}.png"
            if not os.path.exists(img):
                img = f"{asset_dir}/view:00000.png"
            prompts = vlm_prompts(img, args.vlm_model, args.seed)
        else:
            prompts = HUMAN_DEFINED_PROMPTS.get(supercategory, {}).get(category, {}).get(asset_id)
            if prompts is None:
                print(f"[prompts] SKIP {supercategory}/{category}/{asset_id}: "
                      "no human-defined prompts registered (add them to "
                      "config/prompts.py or use --use_vlm)")
                continue

        os.makedirs(os.path.dirname(save_pth), exist_ok=True)
        with open(save_pth, "wb") as fh:
            pickle.dump(dict(prompts=prompts, use_vlm=args.use_vlm), fh)
        print(f"[prompts] {supercategory}/{category}/{asset_id}: {prompts}")


if __name__ == "__main__":
    main()
