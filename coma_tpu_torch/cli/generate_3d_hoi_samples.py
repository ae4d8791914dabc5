"""Orchestrator: the 3D HOI lifting stage
(reference: ``scripts/generate_3d_hoi_samples.sh:46-58``).

segment_human -> predict_human -> initialize_depth -> optimize_depth ->
compute_metrics, each reading only its own flags from one mixed flag list
as the reference's bash stages do; ``--skip`` leaves stages out.
"""
from __future__ import annotations

import argparse
import time

STAGES = ("segment", "predict", "init", "optimize", "metrics")


def main(argv=None) -> dict:
    """Returns what each stage returned and each stage's wall clock in
    seconds."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--skip", type=str, nargs="*", default=[], choices=list(STAGES))
    args, passthrough = parser.parse_known_args(argv)

    from coma_tpu_torch.cli import (
        compute_metrics,
        initialize_depth,
        optimize_depth,
        predict_human,
        segment_human,
    )
    from coma_tpu_torch.cli._common import filter_known_args

    modules = dict(segment=segment_human, predict=predict_human, init=initialize_depth,
                   optimize=optimize_depth, metrics=compute_metrics)
    out = {"seconds": {}}
    for name in STAGES:
        if name in args.skip:
            continue
        print(f"===== stage: {name} =====")
        mod = modules[name]
        t0 = time.perf_counter()
        out[name] = mod.main(filter_known_args(mod.build_parser(), passthrough))
        out["seconds"][name] = time.perf_counter() - t0
        print(f"[generate_3d_hoi_samples] {name}: {out['seconds'][name]:.3f} s", flush=True)
    return out


if __name__ == "__main__":
    main()
