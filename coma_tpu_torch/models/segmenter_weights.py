"""Load the segmenters' weights: PointRend R50-FPN and SAM.

Each loader takes ``coma_tpu``'s Flax-layout ``.npz`` (what its
``convert_weights --kind pointrend`` writes and its ``--pointrend_weights``,
``segment_human --segmenter_params`` and ``--sam_weights *.npz`` read)
through ``models/flax_params.py``, or the published torch checkpoint by its
own key layout, with no converter in between:

- PointRend: a detectron2 ``GeneralizedRCNN`` state dict (the layout that
  ``coma_tpu/models/torch_weights_pointrend.py:1-24`` lists; a ``.pth``
  read with ``torch.load(weights_only=True)``), or the raw ``.pkl``'s
  ``{"model": {name: numpy}}`` (``model_final_edd263.pkl``).
- SAM: the official ``sam_vit_b_01ec64.pth`` state dict
  (``coma_tpu/models/torch_weights_sam.py``'s layout). The tensors the
  box-prompt path never reads (the mask-prompt downscaler and
  ``not_a_point_embed``) are set aside, as ``coma_tpu`` does.

Every other key must land on a parameter of the port's module, every
parameter must be given, and every shape must fit, or the loader raises.
"""
from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from coma_tpu_torch.models.flax_params import load_flax_params, load_state_strict
from coma_tpu_torch.utils.checkpoint import load_params

_POINTREND_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^backbone\.bottom_up\.stem\.conv1\.weight$", "bottom_up.stem_conv1.conv.weight"),
    (r"^backbone\.bottom_up\.stem\.conv1\.norm\.", "bottom_up.stem_conv1.norm."),
    (r"^backbone\.bottom_up\.(res\d)\.(\d+)\.(conv\d|shortcut)\.weight$",
     r"bottom_up.\1_\2.\3.conv.weight"),
    (r"^backbone\.bottom_up\.(res\d)\.(\d+)\.(conv\d|shortcut)\.norm\.",
     r"bottom_up.\1_\2.\3.norm."),
    (r"^backbone\.(fpn_(?:lateral|output)\d)\.", r"fpn.\1."),
    (r"^proposal_generator\.rpn_head\.", "rpn_head."),
    (r"^roi_heads\.box_(?:head|predictor)\.", "box."),
    (r"^roi_heads\.mask_head\.(coarse_head|point_head)\.", r"\1."),
)

_SAM_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^image_encoder\.patch_embed\.proj\.", "image_encoder.patch_embed."),
    (r"^image_encoder\.blocks\.(\d+)\.mlp\.lin(\d)\.", r"image_encoder.block_\1.mlp_lin\2."),
    (r"^image_encoder\.blocks\.(\d+)\.", r"image_encoder.block_\1."),
    (r"^image_encoder\.neck\.0\.", "image_encoder.neck_conv1."),
    (r"^image_encoder\.neck\.1\.", "image_encoder.neck_ln1."),
    (r"^image_encoder\.neck\.2\.", "image_encoder.neck_conv2."),
    (r"^image_encoder\.neck\.3\.", "image_encoder.neck_ln2."),
    (r"^prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix$",
     "prompt_encoder.pe_gaussian"),
    (r"^prompt_encoder\.no_mask_embed\.weight$", "prompt_encoder.no_mask_embed"),
    (r"^mask_decoder\.(iou_token|mask_tokens)\.weight$", r"mask_decoder.\1"),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.mlp\.lin(\d)\.",
     r"mask_decoder.layer_\1.mlp_lin\2."),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.cross_attn_token_to_image\.",
     r"mask_decoder.layer_\1.cross_attn_t2i."),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.cross_attn_image_to_token\.",
     r"mask_decoder.layer_\1.cross_attn_i2t."),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.", r"mask_decoder.layer_\1."),
    (r"^mask_decoder\.transformer\.final_attn_token_to_image\.", "mask_decoder.final_attn."),
    (r"^mask_decoder\.transformer\.norm_final_attn\.", "mask_decoder.norm_final."),
    (r"^mask_decoder\.output_upscaling\.0\.", "mask_decoder.upscale1."),
    (r"^mask_decoder\.output_upscaling\.1\.", "mask_decoder.upscale_ln."),
    (r"^mask_decoder\.output_upscaling\.3\.", "mask_decoder.upscale2."),
    (r"^mask_decoder\.output_hypernetworks_mlps\.(\d+)\.layers\.(\d)\.",
     r"mask_decoder.hyper_\1.lin\2."),
    (r"^mask_decoder\.iou_prediction_head\.layers\.(\d)\.", r"mask_decoder.iou_head.lin\1."),
)
# tensors of the official checkpoint that the box-prompt path never reads
_SAM_SET_ASIDE = (r"^prompt_encoder\.mask_downscaling\.", r"^prompt_encoder\.not_a_point_embed\.")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _rename(key: str, rules) -> str:
    for pattern, repl in rules:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    return key          # unmatched: reported as unused by load_state_strict


def pointrend_state_dict(d2: Mapping) -> Dict[str, np.ndarray]:
    """A detectron2 PointRend state dict (or ``{"model": ...}``) -> the port's
    parameter names; the point head's Conv1d (O, I, 1) weights become (O, I)."""
    if "model" in d2 and not any(k.startswith("backbone") for k in d2):
        d2 = d2["model"]
    out = {}
    for key, value in d2.items():
        arr = _np(value)
        name = _rename(key, _POINTREND_RULES)
        if name.startswith("point_head.") and name.endswith(".weight") and arr.ndim == 3:
            arr = arr[:, :, 0]
        out[name] = arr
    return out


def sam_state_dict(official: Mapping) -> Dict[str, np.ndarray]:
    """The official SAM state dict -> the port's parameter names; the four
    point embeddings (1, d) are stacked into one (4, d) table."""
    out, points = {}, {}
    for key, value in official.items():
        if any(re.match(p, key) for p in _SAM_SET_ASIDE):
            continue
        m = re.match(r"^prompt_encoder\.point_embeddings\.(\d+)\.weight$", key)
        if m:
            points[int(m.group(1))] = _np(value)[0]
            continue
        arr = _np(value)
        name = _rename(key, _SAM_RULES)
        if name == "prompt_encoder.no_mask_embed":
            arr = arr[0]
        out[name] = arr
    if points:
        out["prompt_encoder.point_embed"] = np.stack([points[i] for i in sorted(points)])
    return out


def read_checkpoint(path: str):
    """A ``.npz`` params store -> ("flax", tree); a detectron2 ``.pkl`` (a
    pickle by that format's design: load only checkpoints you trust) ->
    ("torch", its numpy dict); anything else through ``torch.load`` with
    ``weights_only=True`` -> ("torch", state dict)."""
    if path.endswith(".npz"):
        return "flax", load_params(path)
    if path.endswith(".pkl"):
        with open(path, "rb") as fh:
            data = pickle.load(fh, encoding="latin1")
        return "torch", data
    return "torch", torch.load(path, map_location="cpu", weights_only=True)


def load_pointrend_weights(model: nn.Module, path: str) -> nn.Module:
    kind, data = read_checkpoint(path)
    if kind == "flax":
        return load_flax_params(model, data)
    return load_state_strict(model, pointrend_state_dict(data))


def load_sam_weights(model: nn.Module, path: str) -> nn.Module:
    kind, data = read_checkpoint(path)
    if kind == "flax":
        return load_flax_params(model, data)
    return load_state_strict(model, sam_state_dict(data))
