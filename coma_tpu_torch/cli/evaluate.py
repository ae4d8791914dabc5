"""CLI: quantitative evaluation of a predicted ComA against ground truth.

Counterpart of ``coma_tpu/cli/evaluate.py``. The paper-table machinery
(reference: ``utils/evaluation.py`` + ``constants/coma/quant.py`` quant_keys
+ the BEHAVE GT prep in ``utils/behave.py:1062``; the reference's evaluation
scripts were never shipped — this CLI is the runnable version): SIM = Σ
min(p, q) and normalized MAE between the aggregated human/object contact
distributions of two ComA pickles. The ground-truth pickle is built by
``pipelines/extract.aggregate_samples_streaming`` over BEHAVE frames
prepared by ``pipelines/behave_eval.prepare_affordance_extraction_inputs_for_behave``.
"""
from __future__ import annotations

import argparse
import json

from coma_tpu_torch.cli._common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred_coma", required=True, help="predicted ComA pickle")
    parser.add_argument("--gt_coma", required=True, help="ground-truth ComA pickle")
    parser.add_argument("--significant_contact_ratio", type=float, default=0.0)
    parser.add_argument("--out_json", type=str)
    add_device_flag(parser)
    return parser


def main(argv=None) -> None:
    from coma_tpu_torch.affordance.io import load_coma_state
    from coma_tpu_torch.device import resolve_device
    from coma_tpu_torch.pipelines.behave_eval import evaluate_against_gt

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    pred = load_coma_state(args.pred_coma, device=device)
    gt = load_coma_state(args.gt_coma, device=device)
    metrics = evaluate_against_gt(
        pred, gt, significant_contact_ratio=args.significant_contact_ratio
    )
    text = json.dumps(metrics, indent=1)
    print(text)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
