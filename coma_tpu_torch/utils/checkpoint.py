"""Read and write the ``/``-keyed ``.npz`` parameter store.

Counterpart of ``save_params``/``load_params`` in
``coma_tpu/utils/checkpoint.py:44,59``: the file maps ``/``-joined pytree
paths to arrays; a bfloat16 leaf is stored as its uint16 bits under the key
suffix ``::bf16``. numpy has no bfloat16, so such a leaf comes back as
float32, widened exactly (the 16 bits become the high half of the float32),
and is written from a ``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_BF16_SUFFIX = "::bf16"


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def save_params(tree: Dict, path: str) -> None:
    """Write a nested dict of numpy arrays and tensors in ``coma_tpu``'s
    layout; ``path`` gets ``.npz`` appended unless it ends so. A
    ``torch.bfloat16`` leaf is stored as its bits under ``::bf16`` (make it
    with ``tensor.to(torch.bfloat16)``, which rounds to nearest even, as
    ``jnp.asarray(x, jnp.bfloat16)`` does)."""
    flat = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, name)
            elif isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
                flat[name + _BF16_SUFFIX] = value.detach().cpu().view(torch.int16).numpy().view(
                    np.uint16)
            else:
                flat[name] = np.asarray(value)

    walk(tree, "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


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
