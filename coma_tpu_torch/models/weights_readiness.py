"""Weights readiness: the checkpoints the pipeline reads, and their checks.

Counterpart of ``coma_tpu/models/weights_readiness.py``, with no JAX. The
port reads each published checkpoint directly (no conversion step), so a
file is ready when the port's own loader maps it onto the names its module
reads, with every shape the module has:

- ``MANIFEST`` (a copy of ``coma_tpu``'s): every checkpoint the reference
  installation needs, the file names looked for, the publisher's md5
  prefix where it names its files by it.
- :func:`expected_shapes`: the module's state-dict shapes, from the port's
  modules built on the ``meta`` device (no memory, no weights).
- :func:`read_published`: a file through the port's loader for its kind.
- :func:`verify_tree` and :func:`readiness_report`, which
  ``python -m coma_tpu_torch.cli.convert_weights --all`` drives.
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WeightsEntry:
    name: str
    kind: str                      # the loader's kind, or "sd" / "asset"
    paths: Tuple[str, ...]         # candidate paths relative to the root
    md5_prefix: Optional[str] = None   # publisher filename checksum prefix
    state_dict_key: Optional[str] = None
    prefix: str = ""
    required: bool = True          # optional entries don't fail readiness
    notes: str = ""


MANIFEST: Tuple[WeightsEntry, ...] = (
    WeightsEntry(
        name="pointrend_r50_fpn_3x",
        kind="pointrend",
        paths=("imports/pointrend/weights/model_final_edd263.pkl",
               "pointrend/model_final_edd263.pkl",
               "model_final_edd263.pkl"),
        md5_prefix="edd263",       # d2 names checkpoints by md5[:6]
        notes="In-loop person segmenter (ref constants/segmentation.py:5). "
              "detectron2 PointRend R50-FPN 3x COCO.",
    ),
    WeightsEntry(
        name="hand4whole",
        kind="hand4whole",
        paths=("imports/hand4whole/snapshot_6.pth.tar",
               "hand4whole/snapshot_6.pth.tar",
               "snapshot_6.pth.tar"),
        state_dict_key="network",
        notes="3D human regressor (ref INSTALL.md:73-82), H36M+MPII+MSCOCO.",
    ),
    WeightsEntry(
        name="sam_vit_b",
        kind="sam",
        paths=("imports/segment-anything/sam_vit_b_01ec64.pth",
               "sam/sam_vit_b_01ec64.pth",
               "sam_vit_b_01ec64.pth"),
        md5_prefix="01ec64",
        notes="Box-prompted object segmenter. The reference registers vit_h "
              "for every key (utils/adaptive_mask_inpainting.py:1240-1242); "
              "our default SAMConfig is ViT-B — the converter handles both "
              "(depth inferred from the checkpoint).",
    ),
    WeightsEntry(
        name="sam_vit_h",
        kind="sam",
        paths=("imports/segment-anything/sam_vit_h_4b8939.pth",
               "sam/sam_vit_h_4b8939.pth",
               "sam_vit_h_4b8939.pth"),
        md5_prefix="4b8939",
        required=False,
        notes="The reference's registered SAM checkpoint "
              "(utils/adaptive_mask_inpainting.py:1240). Use "
              "models.sam.sam_vit_h_config() at load time.",
    ),
    WeightsEntry(
        name="sd2_inpaint",
        kind="sd",
        paths=("stable-diffusion-2-inpainting",
               "stabilityai/stable-diffusion-2-inpainting",
               "sd2-inpainting"),
        notes="Diffusers checkpoint dir — the reference's default inpainting "
              "model (constants/generation/inpaint_ldm.py:4-15). Configs "
              "are inferred from the dir's config.json files "
              "(infer_sd_configs), incl. SD-2.x per-block heads and the "
              "OpenCLIP gelu text encoder.",
    ),
    WeightsEntry(
        name="coap_smplx_neutral",
        kind="coap",
        paths=("imports/coap/coap_smplx_neutral.ckpt",
               "coap/coap_smplx_neutral.ckpt",
               "coap_smplx_neutral.ckpt"),
        state_dict_key="state_dict",
        notes="Neural occupancy for collision loss "
              "(imports/coap/__init__.py:12-14 pulls "
              "coap_{model_type}_{gender}.ckpt from GitHub).",
    ),
    WeightsEntry(
        name="vposer",
        kind="vposer",
        paths=("imports/vposer/snapshots/TR00_E096.pt",
               "vposer/TR00_E096.pt",
               "TR00_E096.pt"),
        state_dict_key=None,
        required=False,
        notes="Body-pose prior for the application optimizer "
              "(ref INSTALL.md:135-147, src/application/optimize.py:231).",
    ),
    WeightsEntry(
        name="smplx_neutral",
        kind="asset",
        paths=("imports/hand4whole/common/human_model_files/smplx/SMPLX_NEUTRAL.npz",
               "human_model_files/smplx/SMPLX_NEUTRAL.npz",
               "smplx/SMPLX_NEUTRAL.npz",
               "SMPLX_NEUTRAL.npz"),
        notes="License-gated SMPL-X body model (ref INSTALL.md:84-110); "
              "loaded directly by models.smplx.SMPLXModel.from_npz — "
              "no conversion step.",
    ),
)


def find_checkpoint(root: str, entry: WeightsEntry) -> Optional[str]:
    """First existing candidate path for ``entry`` under ``root`` (also
    tries a recursive basename glob as a last resort)."""
    for rel in entry.paths:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            return p
    base = os.path.basename(entry.paths[0])
    hits = sorted(_glob.glob(os.path.join(root, "**", base), recursive=True))
    return hits[0] if hits else None


def file_digests(path: str, chunk: int = 1 << 20) -> Dict[str, object]:
    """sha256 + md5 + size of a file (md5 checks the publisher's filename
    prefix; sha256 is recorded for the local lockfile)."""
    sha, md5 = hashlib.sha256(), hashlib.md5()
    n = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            sha.update(buf)
            md5.update(buf)
            n += len(buf)
    return {"sha256": sha.hexdigest(), "md5": md5.hexdigest(), "bytes": n}


# ------------------------------------------------------------------ shapes --

SD_PARTS = ("unet", "vae_encoder", "vae_decoder", "clip")


def _modules(kind: str, src_dir: Optional[str], num_parts: Optional[int]
             ) -> List[Tuple[str, torch.nn.Module]]:
    """The modules a kind's loader fills, each with the prefix its names
    take in :func:`read_published` ("" for none)."""
    if kind == "hand4whole":
        from coma_tpu_torch.models.hand4whole import Hand4Whole

        return [("", Hand4Whole())]
    if kind == "sam":
        from coma_tpu_torch.models.sam import SAM, SAMConfig

        return [("", SAM(SAMConfig()))]
    if kind == "pointrend":
        from coma_tpu_torch.models.pointrend import PointRendConfig, PointRendModel

        return [("", PointRendModel(PointRendConfig()))]
    if kind == "coap":
        from coma_tpu_torch.models.coap import COAPConfig, COAPOccupancy

        return [("", COAPOccupancy(COAPConfig() if num_parts is None
                                   else COAPConfig(num_parts=num_parts)))]
    if kind == "vposer":     # the halves' own names carry their dec_/enc_ prefix
        from coma_tpu_torch.models.vposer import VPoserConfig, VPoserDecoder, VPoserEncoder

        return [("", VPoserDecoder(VPoserConfig())), ("", VPoserEncoder(VPoserConfig()))]
    if kind == "sd":
        from coma_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextEncoder
        from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
        from coma_tpu_torch.models.diffusion.vae import Decoder, Encoder, VAEConfig
        from coma_tpu_torch.models.diffusion.weights import infer_sd_configs, infer_vae_config

        if src_dir:
            ucfg, ccfg = infer_sd_configs(src_dir)
            vcfg = infer_vae_config(src_dir)
        else:
            ucfg, vcfg, ccfg = UNetConfig(), VAEConfig(), CLIPTextConfig()
        return list(zip(SD_PARTS, (UNet2DCondition(ucfg), Encoder(vcfg), Decoder(vcfg),
                                   CLIPTextEncoder(ccfg))))
    raise ValueError(f"no shape oracle for kind {kind!r}")


def expected_shapes(kind: str, src_dir: Optional[str] = None,
                    num_parts: Optional[int] = None) -> Dict[str, Tuple[int, ...]]:
    """The shapes the port's loader for ``kind`` must fill, by the names
    :func:`read_published` gives: the state dicts of the port's modules,
    built on the ``meta`` device. ``src_dir`` matters for ``kind='sd'``
    only (the configs are read from the diffusers directory), ``num_parts``
    for ``kind='coap'`` only (a checkpoint declares its body's part count,
    which its loader reads; ``COAPConfig``'s 20 by default)."""
    with torch.device("meta"):
        modules = _modules(kind, src_dir, num_parts)
    return {f"{prefix}/{key}" if prefix else key: tuple(value.shape)
            for prefix, module in modules for key, value in module.state_dict().items()}


def read_published(kind: str, path: str) -> Dict[str, np.ndarray]:
    """A checkpoint in its published layout through the port's own loader
    for ``kind``: the arrays by the names the port's module reads (what
    ``load_state_strict`` then copies in). Torch files are read with
    ``torch.load(weights_only=True)``."""
    load = lambda: torch.load(path, map_location="cpu", weights_only=True)
    if kind == "pointrend":
        from coma_tpu_torch.models.segmenter_weights import pointrend_state_dict, read_checkpoint

        return pointrend_state_dict(read_checkpoint(path)[1])
    if kind == "sam":
        from coma_tpu_torch.models.segmenter_weights import sam_state_dict

        return sam_state_dict(load())
    if kind == "hand4whole":
        from coma_tpu_torch.models.hand4whole import hand4whole_state_dict

        return hand4whole_state_dict(load())
    if kind == "coap":
        from coma_tpu_torch.models.coap import coap_state_dict

        return coap_state_dict(load())[0]
    if kind == "vposer":
        from coma_tpu_torch.models.vposer import vposer_state_dict

        return vposer_state_dict(load())
    if kind == "sd":
        from coma_tpu_torch.models.diffusion.weights import load_sd_params

        params = load_sd_params(path, dtype=torch.float32)
        return {f"{part}/{k}": v for part in SD_PARTS for k, v in params[part].items()}
    raise ValueError(f"unknown kind {kind!r}")


def verify_tree(kind: str, tree: Mapping[str, np.ndarray], src_dir: Optional[str] = None
                ) -> list:
    """Compare arrays by name (:func:`read_published`) against
    :func:`expected_shapes` (for COAP at the part count the tree declares).
    Returns a list of problem strings (empty == every name present with its
    shape, and no other)."""
    num_parts = None
    if kind == "coap" and "query_encoder.lin0.weight" in tree:
        from coma_tpu_torch.models.coap import coap_parts

        num_parts = coap_parts(tree)
    want = expected_shapes(kind, src_dir, num_parts)
    got = {k: tuple(np.shape(v)) for k, v in tree.items()}
    problems = []
    for k in sorted(set(want) - set(got)):
        problems.append(f"missing leaf {k} (expected {want[k]})")
    for k in sorted(set(got) - set(want)):
        problems.append(f"unexpected leaf {k} {got[k]}")
    for k in sorted(set(got) & set(want)):
        if tuple(got[k]) != tuple(want[k]):
            problems.append(f"shape mismatch {k}: got {got[k]}, "
                            f"expected {want[k]}")
    return problems


def readiness_report(root: str) -> Dict[str, Dict]:
    """Scan ``root`` for every manifest entry. A filesystem scan and the
    md5-prefix check, nothing loaded (that is ``cli/convert_weights --all``)."""
    report = {}
    for entry in MANIFEST:
        src = find_checkpoint(root, entry)
        item: Dict[str, object] = {
            "kind": entry.kind,
            "required": entry.required,
            "status": "found" if src else "missing",
            "path": src,
            "expected": entry.paths[0],
        }
        if src and os.path.isfile(src) and entry.md5_prefix:
            digests = file_digests(src)
            item.update(digests)
            item["md5_prefix_ok"] = str(digests["md5"]).startswith(
                entry.md5_prefix)
        report[entry.name] = item
    return report
