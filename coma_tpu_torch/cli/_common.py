"""Shared CLI plumbing: seeding, filter-list normalization, work-list
sharding, common flags."""
from __future__ import annotations

import argparse
import random
from typing import List, Optional

import numpy as np
import torch

from coma_tpu_torch.config.metadata import DEFAULT_SEED


def seed_everything(seed: int = DEFAULT_SEED) -> None:
    """Reference parity: ``utils/reproducibility.py:seed_everything:11``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def lower_all(values: Optional[List[str]]) -> Optional[List[str]]:
    return [v.lower() for v in values] if values is not None else None


def shard_worklist(items: list, parallel_idx: int, parallel_num: int) -> list:
    """The reference's static index sharding (``inpaint.py:271-278``):
    ``sub_length = len(X)//n + 1; X[i*sub_length:(i+1)*sub_length]``."""
    if parallel_num <= 1:
        return items
    sub = len(items) // parallel_num + 1
    return items[parallel_idx * sub : (parallel_idx + 1) * sub]


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--supercategories", type=str, nargs="+")
    parser.add_argument("--categories", type=str, nargs="+")
    parser.add_argument("--skip_done", action="store_true")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_device_flag(parser)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the accumulators live and the kernels run; cuda raises "
             "when no card is present",
    )
