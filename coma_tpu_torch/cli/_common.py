"""Shared CLI plumbing: seeding, filter-list normalization, work-list
sharding, common flags, and the orchestrators' per-stage flag filter."""
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


def add_host_flags(parser: argparse.ArgumentParser) -> None:
    """The common flags of a stage that does no device work."""
    parser.add_argument("--supercategories", type=str, nargs="+")
    parser.add_argument("--categories", type=str, nargs="+")
    parser.add_argument("--skip_done", action="store_true")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    add_host_flags(parser)
    add_device_flag(parser)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the accumulators live and the kernels run; cuda raises "
             "when no card is present",
    )


def filter_known_args(parser, argv):
    """Keep only the options (with their values) that ``parser`` defines.

    The orchestrators (``cli/learn_coma.py``) accept one mixed flag list for
    all their stages — like the reference's bash scripts, where each python
    stage only reads its own flags. Each stage main re-parses, so unknown
    flags must be dropped here.
    """
    by_option = {}
    for action in parser._actions:
        for opt in action.option_strings:
            by_option[opt] = action

    def value_count(action):
        if action.nargs == 0:
            return 0
        if action.nargs in (None, "?"):
            return 1
        if isinstance(action.nargs, int):
            return action.nargs
        return -1  # '*' / '+': greedy until the next option

    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        opt = tok.split("=", 1)[0]
        action = by_option.get(opt)
        keep = action is not None
        if keep:
            out.append(tok)
        if "=" in tok or (action is not None and value_count(action) == 0):
            i += 1
            continue
        # consume this option's value tokens (greedy for */+ and unknowns)
        n = value_count(action) if action is not None else -1
        j = i + 1
        taken = 0
        while j < len(argv) and not argv[j].startswith("--") and (n < 0 or taken < n):
            if keep:
                out.append(argv[j])
            j += 1
            taken += 1
        i = j
    return out
