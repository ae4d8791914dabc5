"""Orchestrator: the 2D HOI image generation stage (reference:
``scripts/generate_2d_hoi_images.sh:46-56`` — render_objects -> select_mask
-> generate_prompts -> inpaint; counterpart of
``coma_tpu/cli/generate_2d_hoi_images.py``). One mixed flag list; each stage
reads only its own flags, as each python stage of the reference's bash does.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--skip", type=str, nargs="*", default=[],
                        choices=["render", "select_mask", "prompts", "inpaint"])
    args, passthrough = parser.parse_known_args(argv)

    from coma_tpu_torch.cli import generate_prompts, inpaint, render_objects, select_mask
    from coma_tpu_torch.cli._common import filter_known_args

    stages = [
        ("render", render_objects),
        ("select_mask", select_mask),
        ("prompts", generate_prompts),
        ("inpaint", inpaint),
    ]
    for name, mod in stages:
        if name in args.skip:
            continue
        print(f"===== stage: {name} =====", flush=True)
        mod.main(filter_known_args(mod.build_parser(), passthrough))


if __name__ == "__main__":
    main()
