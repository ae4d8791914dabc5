"""Orchestrator: the ComA learning stage
(reference: ``scripts/learn_coma.sh:42-64`` — filter -> downsample_human ->
downsample_objects x resolutions -> extract_coma x hyperparams).

Each stage reads only its own flags from one mixed flag list, as the
reference's bash does; ``--device`` reaches the two stages with device work
(the SMPL-X star pose and the extraction). With ``--multihost`` the launch
variables of ``cli/extract_coma.py`` describe the ranks: rank 0 alone runs
the three host stages, every rank then runs each extraction in the one
process group made here.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    """Returns what each stage returned (the filter's statistics, the
    pickles and products written) and each stage's wall clock in seconds."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--hyperparams_keys", type=str, nargs="+",
                        default=["qual:backpack_human_contact",
                                 "qual:backpack_object_contact",
                                 "qual:backpack_occupancy",
                                 "qual:backpack_orientation"])
    parser.add_argument("--object_resolutions", type=int, nargs="+",
                        default=[2048, 1500, 180])
    parser.add_argument("--skip", type=str, nargs="*", default=[],
                        choices=["filter", "downsample_human", "downsample_objects", "extract"])
    args, passthrough = parser.parse_known_args(argv)

    from coma_tpu_torch.cli import downsample_human, downsample_objects, extract_coma
    from coma_tpu_torch.cli import filter as filter_cli
    from coma_tpu_torch.cli._common import filter_known_args
    from coma_tpu_torch.parallel import distributed

    # each stage reads only its own flags (like the reference's bash)
    known = lambda mod, extra=(): filter_known_args(
        mod.build_parser(), passthrough
    ) + list(extra)
    extract_args = extract_coma.build_parser().parse_known_args(
        ["--hyperparams_key", args.hyperparams_keys[0], *known(extract_coma)])[0]
    out = {"seconds": {}}

    def stage(name, fn, *stage_args):
        print(f"===== stage: {name} =====")
        t0 = time.perf_counter()
        out[name] = fn(*stage_args)
        out["seconds"][name] = time.perf_counter() - t0
        print(f"[learn_coma] {name}: {out['seconds'][name]:.3f} s", flush=True)

    ctx = None
    if extract_args.multihost:
        ctx = distributed.initialize(extract_args.dist_backend, extract_args.device)
    try:
        if ctx is None or ctx.is_root:
            if "filter" not in args.skip:
                stage("filter", filter_cli.main, known(filter_cli))
            if "downsample_human" not in args.skip:
                stage("downsample_human", downsample_human.main, known(downsample_human))
            if "downsample_objects" not in args.skip:
                stage("downsample_objects", lambda: [
                    path for res in args.object_resolutions
                    for path in downsample_objects.main(
                        known(downsample_objects, ["--number_of_points", str(res)]))
                ])
        if ctx is not None:
            distributed.barrier(ctx)   # the other ranks read what rank 0 wrote
        if "extract" not in args.skip:
            for key in args.hyperparams_keys:
                stage(f"extract ({key})", extract_coma.main,
                      known(extract_coma, ["--hyperparams_key", key]), ctx)
    finally:
        if ctx is not None:
            distributed.shutdown(ctx)
    return out


if __name__ == "__main__":
    main()
