"""CLI: the weights-readiness check of every published checkpoint.

Counterpart of ``coma_tpu/cli/convert_weights.py --all``. ``coma_tpu``
converts each torch checkpoint once into a Flax store; the port reads the
published files directly, so it converts nothing. For each entry of
``models/weights_readiness.MANIFEST`` found under ``--weights_root`` it
checks the publisher's md5 prefix, reads the file through the port's own
loader (status ``loaded``) and, unless ``--no-verify``, holds every array's
shape against the port's module. ``--report`` writes the per-entry JSON.

Exit code 0 when files are missing (the expected state of a fresh
checkout: the report says what to fetch), 1 when a present file fails its
checksum, its load or its shape check. Host-only: nothing runs on a
device.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--all", action="store_true",
                        help="check every manifest entry found under --weights_root")
    parser.add_argument("--weights_root", type=str, default="imports",
                        help="directory scanned for the manifest checkpoints")
    parser.add_argument("--report", type=str, default=None,
                        help="write the readiness report JSON here")
    parser.add_argument("--verify", action=argparse.BooleanOptionalAction, default=True,
                        help="hold every loaded array's shape against the port's module")
    for flag in ("--kind", "--src", "--out"):
        parser.add_argument(flag, type=str, default=None,
                            help="coma_tpu's one-file conversion; refused here")
    return parser


def check_entry(entry, item: dict, verify: bool) -> bool:
    """Load one present entry through the port's loader and verify it,
    filling ``item``; True when it failed."""
    from coma_tpu_torch.models.weights_readiness import read_published, verify_tree

    src = item["path"]
    if item.get("md5_prefix_ok") is False:
        print(f"[convert_weights] {entry.name:<22} CHECKSUM MISMATCH: "
              f"md5 {item['md5']} !~ {entry.md5_prefix}*")
        item["status"] = "checksum_mismatch"
        return True
    try:
        if entry.kind == "asset":
            from coma_tpu_torch.models.smplx import SMPLXModel

            item["num_verts"] = int(SMPLXModel.from_npz(src, device="cpu").num_verts)
            tree = None
        else:
            tree = read_published(entry.kind, src)
    except Exception as exc:  # noqa: BLE001 -- one entry's failure is reported, not fatal
        item["status"] = "load_failed"
        item["error"] = f"{type(exc).__name__}: {exc}"
        print(f"[convert_weights] {entry.name:<22} LOAD FAILED: {item['error']}")
        return True
    # SAM's ViT-B and ViT-H share a kind; the shapes are ViT-B's (as in coma_tpu)
    if tree is not None and verify and entry.kind != "sam":
        problems = verify_tree(entry.kind, tree, src_dir=src if entry.kind == "sd" else None)
        if problems:
            item["status"] = "shape_mismatch"
            item["problems"] = problems[:20]
            print(f"[convert_weights] {entry.name:<22} SHAPE MISMATCH ({len(problems)} "
                  f"problems; first: {problems[0]})")
            return True
    item["status"] = "loaded"
    if os.path.isfile(src) and "sha256" not in item:
        from coma_tpu_torch.models.weights_readiness import file_digests

        item.update(file_digests(src))
    what = f"{item['num_verts']} verts" if tree is None else f"{len(tree)} arrays"
    print(f"[convert_weights] {entry.name:<22} LOADED ({entry.kind}, {what})")
    return False


def run_all(args) -> int:
    """Scan, load what is present, verify, report; the exit code."""
    from coma_tpu_torch.models.weights_readiness import MANIFEST, readiness_report

    report = readiness_report(args.weights_root)
    failures = 0
    for entry in MANIFEST:
        item = report[entry.name]
        if item["path"] is None:
            print(f"[convert_weights] {entry.name:<22} MISSING (expected {entry.paths[0]})")
            continue
        failures += check_entry(entry, item, args.verify)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[convert_weights] report -> {args.report}")
    n_found = sum(1 for v in report.values() if v["path"])
    print(f"[convert_weights] {n_found}/{len(report)} checkpoints present, {failures} failures")
    return 1 if failures else 0


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.kind or args.src or args.out:
        raise SystemExit("[convert_weights] --kind/--src/--out convert a checkpoint to a Flax "
                         "store for coma_tpu; the port reads the published files directly. "
                         "Run --all --weights_root DIR to check them")
    if not args.all:
        raise SystemExit("[convert_weights] pass --all --weights_root DIR")
    raise SystemExit(run_all(args))


if __name__ == "__main__":
    main()
