"""Diffusers checkpoints -> the port's SD modules, and safetensors in numpy.

Counterpart of ``coma_tpu/models/diffusion/weights.py``. A diffusers
SD-inpainting directory (the artifacts the reference pulls,
``constants/generation/inpaint_ldm.py``) holds::

    unet/config.json            unet/diffusion_pytorch_model.safetensors
    vae/config.json             vae/diffusion_pytorch_model.safetensors
    text_encoder/config.json    text_encoder/model.safetensors
    tokenizer/vocab.json        tokenizer/merges.txt (or merges.txt.gz)

The safetensors files are read and written with numpy alone (the card
machine has no ``safetensors`` package): an 8-byte little-endian header
length, a JSON header naming each tensor's ``dtype`` (``F32``, ``F16`` or
``BF16`` here), ``shape`` and ``data_offsets``, an optional
``__metadata__``, then the raw bytes. BF16 is widened to float32 by a
16-bit shift.

The port's modules keep PyTorch layouts (Conv (O, I, kh, kw), Dense
(O, I)), so a diffusers weight crosses as it is; only the names change —
``coma_tpu``'s Flax module paths on one side, diffusers' on the other, with
the up-block index reversed. One table per model (:func:`unet_key_map`,
:func:`vae_key_map`, :func:`clip_key_map`) serves both directions. A
missing or unused key raises. A transformer's ``proj_in``/``proj_out``
stored as a 2-D Linear weight (SD-2.x, ``use_linear_projection``) is taken
as the 1x1 convolution it is; ``coma_tpu`` cannot read that layout.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from coma_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextEncoder
from coma_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer
from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from coma_tpu_torch.models.diffusion.vae import Decoder, Encoder, VAEConfig

UNET_FILE = os.path.join("unet", "diffusion_pytorch_model.safetensors")
VAE_FILE = os.path.join("vae", "diffusion_pytorch_model.safetensors")
CLIP_FILE = os.path.join("text_encoder", "model.safetensors")
# buffers some transformers versions save beside the text encoder's weights
CLIP_BUFFERS = ("text_model.embeddings.position_ids",)

# ------------------------------------------------------------ safetensors ----

_NUMPY_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}
_INT_DTYPES = {"I64": np.dtype("<i8"), "I32": np.dtype("<i4")}   # read only (buffers)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """name -> array. F32, F16, I64 and I32 keep their dtype; BF16 becomes
    float32 (exact: a bfloat16 is the upper half of a float32)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = info["dtype"]
        np_dtype = _NUMPY_DTYPES.get(dtype, _INT_DTYPES.get(dtype))
        if np_dtype is None:
            raise ValueError(f"{path}: {name} has dtype {dtype}; read are "
                             f"{sorted(_NUMPY_DTYPES) + sorted(_INT_DTYPES)}")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np_dtype, count=(end - start) // np_dtype.itemsize,
                            offset=start)
        if dtype == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(info["shape"])
    return out


def _to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns, rounded to nearest even."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + (((u >> 16) & 1) + 0x7FFF)) >> 16).astype("<u2")


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray], dtype: str = "F32",
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write float arrays as one safetensors file, every tensor in ``dtype``
    (``F32``, ``F16`` or ``BF16``), offsets in name order."""
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"dtype {dtype}; written are {sorted(_NUMPY_DTYPES)}")
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        if a.dtype.kind != "f":
            raise TypeError(f"{name}: {a.dtype} is not a float array")
        raw = (_to_bf16_bits(a) if dtype == "BF16" else
               np.ascontiguousarray(a, dtype=_NUMPY_DTYPES[dtype])).tobytes()
        header[name] = dict(dtype=dtype, shape=list(a.shape),
                            data_offsets=[offset, offset + len(raw)])
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = dict(metadata)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for raw in blobs:
            fh.write(raw)


# ------------------------------------------------------------- key tables ----

def _module_keys(module_cls, config) -> Dict[str, Tuple[int, ...]]:
    """The state-dict keys and shapes of ``module_cls(config)``, built on the
    meta device (no memory)."""
    return {k: tuple(v.shape) for k, v in module_cls(config, device="meta").state_dict().items()}


_TRANSFORMER_RENAMES = (
    ("block0.", "transformer_blocks.0."),
    ("attn1.to_out.", "attn1.to_out.0."),
    ("attn2.to_out.", "attn2.to_out.0."),
    ("ff.proj_in.", "ff.net.0.proj."),
    ("ff.proj_out.", "ff.net.2."),
)


def _unet_name(key: str, n_blocks: int) -> str:
    top, _, rest = key.partition(".")
    for pattern, repl in (
        (r"time_embed_0$", "time_embedding.linear_1"),
        (r"time_embed_2$", "time_embedding.linear_2"),
        (r"mid_res_(\d)$", r"mid_block.resnets.\1"),
        (r"mid_attn$", "mid_block.attentions.0"),
        (r"down_(\d+)_res_(\d+)$", r"down_blocks.\1.resnets.\2"),
        (r"down_(\d+)_attn_(\d+)$", r"down_blocks.\1.attentions.\2"),
        (r"down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0"),
    ):
        top = re.sub(pattern, repl, top)
    m = re.match(r"up_(\d+)_(res|attn|upsample)(?:_(\d+))?$", top)
    if m:   # coma_tpu's up_i is diffusers' up_blocks[n - 1 - i]
        k = n_blocks - 1 - int(m.group(1))
        kind = {"res": "resnets", "attn": "attentions", "upsample": "upsamplers"}[m.group(2)]
        top = f"up_blocks.{k}.{kind}.{m.group(3) or 0}"
    rest = "." + rest
    for a, b in _TRANSFORMER_RENAMES:
        rest = rest.replace("." + a, "." + b)
    return top + rest


def unet_key_map(config: UNetConfig) -> Dict[str, str]:
    """Port UNet key -> diffusers ``UNet2DConditionModel`` key."""
    n = len(config.block_out_channels)
    return {k: _unet_name(k, n) for k in _module_keys(UNet2DCondition, config)}


def _vae_name(key: str, side: str, n_blocks: int) -> str:
    top, _, leaf = key.rpartition(".")
    if top in ("quant_conv", "post_quant_conv"):
        return key
    top = re.sub(r"^down_(\d+)_res_(\d+)", r"down_blocks.\1.resnets.\2", top)
    top = re.sub(r"^down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv", top)
    top = re.sub(r"^up_(\d+)_res_(\d+)",
                 lambda m: f"up_blocks.{n_blocks - 1 - int(m.group(1))}.resnets.{m.group(2)}", top)
    top = re.sub(r"^up_(\d+)_upsample$",
                 lambda m: f"up_blocks.{n_blocks - 1 - int(m.group(1))}.upsamplers.0.conv", top)
    top = re.sub(r"^mid_res_(\d)", r"mid_block.resnets.\1", top)
    top = re.sub(r"^mid_attn", "mid_block.attentions.0", top)
    top = re.sub(r"attentions\.0\.to_out$", "attentions.0.to_out.0", top)
    return f"{side}.{top}.{leaf}"


def vae_key_map(config: VAEConfig) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(port Encoder key -> diffusers ``AutoencoderKL`` key, same for the
    Decoder)."""
    n = len(config.block_out_channels)
    return tuple({k: _vae_name(k, side, n) for k in _module_keys(cls, config)}
                 for cls, side in ((Encoder, "encoder"), (Decoder, "decoder")))


def clip_key_map(config: CLIPTextConfig) -> Dict[str, str]:
    """Port CLIP text key -> transformers ``CLIPTextModel`` key."""
    out = {}
    for k in _module_keys(CLIPTextEncoder, config):
        d = re.sub(r"^layer_(\d+)\.", r"encoder.layers.\1.", k)
        d = re.sub(r"\.fc(\d)\.", r".mlp.fc\1.", d)
        d = d.replace("token_embedding.", "embeddings.token_embedding.")
        if d == "position_embedding":
            d = "embeddings.position_embedding.weight"
        out[k] = f"text_model.{d}"
    return out


def _is_transformer_projection(port_key: str) -> bool:
    """A spatial transformer's ``proj_in``/``proj_out`` weight (not its
    feed-forward's, ``...ff.proj_in.weight``)."""
    return re.search(r"attn(_\d+)?\.proj_(in|out)\.weight$", port_key) is not None


def convert(sd: Mapping[str, np.ndarray], key_map: Mapping[str, str],
            shapes: Mapping[str, Tuple[int, ...]], what: str,
            ignore: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """A diffusers state dict -> the port's (float32). Missing, unused or
    misshapen keys raise; a 2-D ``proj_in``/``proj_out`` becomes (C, C, 1, 1)."""
    missing = sorted(d for d in key_map.values() if d not in sd)
    unused = sorted(set(sd) - set(key_map.values()) - set(ignore))
    if missing or unused:
        raise KeyError(f"{what}: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    out = {}
    for port_key, d in key_map.items():
        value = np.asarray(sd[d])
        if _is_transformer_projection(port_key) and value.ndim == 2:   # SD-2.x's Linear
            value = value[:, :, None, None]
        if value.shape != shapes[port_key]:
            raise ValueError(f"{what} {d}: shape {value.shape}, the module's {port_key} "
                             f"has {shapes[port_key]}")
        out[port_key] = np.asarray(value, dtype=np.float32)
    return out


def convert_unet(sd: Mapping[str, np.ndarray], config: UNetConfig = UNetConfig()):
    return convert(sd, unet_key_map(config), _module_keys(UNet2DCondition, config), "unet")


def convert_vae(sd: Mapping[str, np.ndarray], config: VAEConfig = VAEConfig()):
    """Returns (encoder state dict, decoder state dict)."""
    enc_map, dec_map = vae_key_map(config)
    return (convert(sd, enc_map, _module_keys(Encoder, config), "vae",
                    ignore=tuple(dec_map.values())),
            convert(sd, dec_map, _module_keys(Decoder, config), "vae",
                    ignore=tuple(enc_map.values())))


def convert_clip_text(sd: Mapping[str, np.ndarray], config: CLIPTextConfig = CLIPTextConfig()):
    key_map = clip_key_map(config)
    if not any(k.startswith("text_model.") for k in sd):   # a bare CLIPTextTransformer
        key_map = {k: v[len("text_model."):] for k, v in key_map.items()}
    return convert(sd, key_map, _module_keys(CLIPTextEncoder, config), "text_encoder",
                   ignore=CLIP_BUFFERS + tuple(b[len("text_model."):] for b in CLIP_BUFFERS))


def export_state_dict(state: Mapping[str, torch.Tensor], key_map: Mapping[str, str],
                      linear_projection: bool = False) -> Dict[str, np.ndarray]:
    """The port's state dict -> diffusers names (numpy, the state's dtype);
    ``linear_projection`` stores transformer ``proj_in``/``proj_out`` as 2-D
    Linear weights, as SD-2.x checkpoints do."""
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy()
        if linear_projection and _is_transformer_projection(k):
            a = a[:, :, 0, 0]
        out[key_map[k]] = a
    return out


# ------------------------------------------------------------------ configs ----

def _read_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def infer_sd_configs(weights_dir: str) -> Tuple[UNetConfig, CLIPTextConfig]:
    """The UNet and CLIP configs a diffusers directory declares
    (``unet/config.json``, ``text_encoder/config.json``), as ``coma_tpu``
    reads them: SD-2.x's per-block ``attention_head_dim`` list becomes
    ``heads_per_block``; an absent file gives the SD-1.x defaults."""
    ucfg, ccfg = UNetConfig(), CLIPTextConfig()
    u = _read_json(os.path.join(weights_dir, "unet", "config.json"))
    if u is not None:
        head_dim = u.get("attention_head_dim", 8)
        heads_per_block = None
        if isinstance(head_dim, (list, tuple)):   # SD-2.x: per-block counts
            heads_per_block, head_dim = tuple(head_dim), 8
        ucfg = UNetConfig(
            in_channels=u.get("in_channels", 9),
            out_channels=u.get("out_channels", 4),
            block_out_channels=tuple(u.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=u.get("layers_per_block", 2),
            cross_attention_dim=u.get("cross_attention_dim", 768),
            attention_head_dim=head_dim,
            heads_per_block=heads_per_block,
            norm_num_groups=u.get("norm_num_groups", 32),
            cross_attn_blocks=tuple(
                t.startswith("CrossAttn")
                for t in u.get("down_block_types",
                               ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",))),
        )
    c = _read_json(os.path.join(weights_dir, "text_encoder", "config.json"))
    if c is not None:
        ccfg = CLIPTextConfig(
            vocab_size=c.get("vocab_size", 49408),
            hidden_size=c.get("hidden_size", 768),
            num_layers=c.get("num_hidden_layers", 12),
            num_heads=c.get("num_attention_heads", 12),
            max_positions=c.get("max_position_embeddings", 77),
            hidden_act=c.get("hidden_act", "quick_gelu"),
        )
    return ucfg, ccfg


def infer_vae_config(weights_dir: str, default: VAEConfig = VAEConfig()) -> VAEConfig:
    """The VAE layout ``vae/config.json`` declares, else ``default``.
    ``coma_tpu`` always converts the VAE at the SD-1.x layout; every published
    SD VAE has it."""
    v = _read_json(os.path.join(weights_dir, "vae", "config.json"))
    if v is None:
        return default
    return dataclasses.replace(
        default,
        in_channels=v.get("in_channels", default.in_channels),
        latent_channels=v.get("latent_channels", default.latent_channels),
        block_out_channels=tuple(v.get("block_out_channels", default.block_out_channels)),
        layers_per_block=v.get("layers_per_block", default.layers_per_block),
        norm_num_groups=v.get("norm_num_groups", default.norm_num_groups),
        scaling_factor=v.get("scaling_factor", default.scaling_factor),
    )


# ------------------------------------------------------------------ loading ----

def load_sd_params(weights_dir: str, dtype: torch.dtype = torch.bfloat16,
                   vae_config: Optional[VAEConfig] = None) -> Dict:
    """A diffusers directory -> the port's state dicts (float32 numpy), the
    tokenizer and the configs. The UNet's values are rounded through
    ``dtype``, as ``coma_tpu`` stores them; the VAE and CLIP stay float32.
    A directory that does not exist raises."""
    if not os.path.isdir(weights_dir):
        raise FileNotFoundError(f"weights directory {weights_dir!r} does not exist")
    ucfg, ccfg = infer_sd_configs(weights_dir)
    vcfg = vae_config or infer_vae_config(weights_dir)
    unet = convert_unet(read_safetensors(os.path.join(weights_dir, UNET_FILE)), ucfg)
    if dtype != torch.float32:
        unet = {k: torch.from_numpy(v).to(dtype).float().numpy() for k, v in unet.items()}
    enc, dec = convert_vae(read_safetensors(os.path.join(weights_dir, VAE_FILE)), vcfg)
    clip = convert_clip_text(read_safetensors(os.path.join(weights_dir, CLIP_FILE)), ccfg)
    tok_dir = os.path.join(weights_dir, "tokenizer")
    merges = os.path.join(tok_dir, "merges.txt")
    if not os.path.exists(merges) and os.path.exists(merges + ".gz"):
        merges += ".gz"
    return dict(unet=unet, vae_encoder=enc, vae_decoder=dec, clip=clip,
                tokenizer=CLIPTokenizer(os.path.join(tok_dir, "vocab.json"), merges),
                unet_config=ucfg, clip_config=ccfg, vae_config=vcfg)


@torch.no_grad()
def load_state(module: torch.nn.Module, state: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy a converted state dict into ``module`` (strict); returns it."""
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return module
