"""Read the ``/``-keyed ``.npz`` parameter store, with numpy alone.

Counterpart of ``load_params`` in ``coma_tpu/utils/checkpoint.py:59``: the
file maps ``/``-joined pytree paths to arrays; a bfloat16 leaf is stored as
its uint16 bits under the key suffix ``::bf16``. numpy has no bfloat16, so
such a leaf comes back as float32, widened exactly (the 16 bits become the
high half of the float32).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_BF16_SUFFIX = "::bf16"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_params(path: str) -> Dict:
    """The nested dict of numpy arrays written by ``coma_tpu``'s ``save_params``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith(_BF16_SUFFIX):
                key = key[: -len(_BF16_SUFFIX)]
                arr = bf16_bits_to_float32(arr)
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree
