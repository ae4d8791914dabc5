"""Carry ``coma_tpu``'s Flax parameters into the port's modules.

A Flax params tree (nested dicts of numpy arrays, with or without the
top-level ``"params"``) of the UNet, the VAE encoder or decoder, the CLIP
text tower or the person segmenter becomes the ``state_dict`` of the port's
module of the same name: submodule paths are the same, ``kernel`` becomes
``weight`` — a Conv's (kh, kw, I, O) transposed to (O, I, kh, kw), a
Dense's (I, O) to (O, I) — and a norm's ``scale`` and an embedding's
``embedding`` become ``weight``; a batch norm's ``batch_stats`` ``mean`` and
``var`` become ``running_mean`` and ``running_var``. A Flax ``ConvTranspose``
kernel (kh, kw, I, O), stride 2 and 'SAME' padding, becomes the weight (I,
O, kh, kw) of the ``nn.ConvTranspose2d`` at its path, flipped in both
spatial axes. A key that is missing on either side, or a shape that does
not fit, raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def flax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    params = variables["params"] if "params" in variables else variables
    out = {}
    # a batch norm's running statistics (Flax's ``batch_stats`` collection)
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        *mods, name = path
        name = {"mean": "running_mean", "var": "running_var"}[name]
        out[".".join(mods + [name])] = np.ascontiguousarray(np.asarray(leaf))
    for path, leaf in _flatten(params):
        *mods, name = path
        arr = np.asarray(leaf)
        if name == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[".".join(mods + [name])] = np.ascontiguousarray(arr)
    return out


def load_flax_params(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax params tree into ``module`` in place; returns ``module``."""
    given = flax_to_state_dict(variables)
    for name, sub in module.named_modules():
        key = f"{name}.weight"
        if isinstance(sub, nn.ConvTranspose2d) and key in given:
            given[key] = np.ascontiguousarray(given[key].transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
    return load_state_strict(module, given)


@torch.no_grad()
def load_state_strict(module: nn.Module, given: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy numpy arrays keyed by ``module``'s state-dict names into it; a
    missing or unused key, or a shape that does not fit, raises."""
    target = module.state_dict()
    missing = sorted(set(target) - set(given))
    unused = sorted(set(given) - set(target))
    if missing or unused:
        raise KeyError(f"{type(module).__name__}: missing {missing[:8]} "
                       f"({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for key, arr in given.items():
        dst = target[key]
        if tuple(dst.shape) != arr.shape:
            raise ValueError(f"{key}: shape {arr.shape}, module has {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module
