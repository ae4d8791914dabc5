"""Safetensors in numpy, the CLIP tokenizer, ``infer_sd_configs`` and
``load_sd_params``, the port against ``safetensors`` and ``coma_tpu``.

A tiny diffusers directory is written with the port's writer from the
diffusers-layout torch mirrors of ``tests/torch_sd_mirror.py`` (their
default initialisation, every parameter then moved by seeded noise) and
``coma_tpu``'s CLIP text tower renamed to ``CLIPTextModel`` keys;
``coma_tpu.load_sd_params`` and the
port's read the same directory, and the loaded UNet, VAE and CLIP agree at
``tests/test_torch_sd_models.py``'s tolerances (atol 2e-4; CLIP 1e-5),
float32. The tokenizer runs on the miniature vocabulary of
``tests/test_weights.py:173-195``.
"""
import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models.diffusion import clip_text as j_clip
from coma_tpu.models.diffusion import tokenizer as j_tok
from coma_tpu.models.diffusion import unet as j_unet
from coma_tpu.models.diffusion import vae as j_vae
from coma_tpu.models.diffusion import weights as j_weights
from coma_tpu_torch.models.diffusion import clip_text as t_clip
from coma_tpu_torch.models.diffusion import tokenizer as t_tok
from coma_tpu_torch.models.diffusion import unet as t_unet
from coma_tpu_torch.models.diffusion import vae as t_vae
from coma_tpu_torch.models.diffusion import weights as W
from tests.torch_sd_mirror import AutoencoderKLMirror, UNetMirror

ATOL, CLIP_ATOL = 2e-4, 1e-5
SD2_UNET = dict(block_out_channels=[32, 64, 64, 64], layers_per_block=1, cross_attention_dim=48,
                attention_head_dim=[1, 2, 2, 4], norm_num_groups=8, use_linear_projection=True)
SD1_UNET = dict(block_out_channels=[32, 64, 64, 64], layers_per_block=1, cross_attention_dim=32,
                attention_head_dim=2, norm_num_groups=8)
VAE = dict(block_out_channels=[16, 16, 32, 32], layers_per_block=2, norm_num_groups=8)
CLIP = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77, hidden_act="gelu")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the test workers share the host's cores, and
    oversubscribed intra-op threads slow every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- safetensors ----

def sample_arrays(rng):
    return {"a.weight": np.float32(rng.normal(size=(3, 5)) * 100),
            "b": np.float32(rng.normal(size=(7,))),
            "c.d": np.float32(rng.normal(size=(2, 3, 1, 1)) * 1e-3)}


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_reader_is_bit_equal_to_safetensors(tmp_path, dtype):
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import load_file as torch_load, save_file as torch_save

    arrays = sample_arrays(np.random.default_rng(0))
    path = str(tmp_path / "x.safetensors")
    if dtype == "BF16":    # numpy has no bfloat16: written and read as torch tensors
        torch_save({k: torch.from_numpy(v).bfloat16() for k, v in arrays.items()}, path,
                   metadata={"format": "pt"})
        want = {k: v.float().numpy() for k, v in torch_load(path).items()}
    else:
        np_save({k: v.astype({"F32": np.float32, "F16": np.float16}[dtype])
                 for k, v in arrays.items()}, path, metadata={"format": "np"})
        from safetensors.numpy import load_file

        want = load_file(path)
    got = W.read_safetensors(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8))


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_writer_reads_back_through_safetensors(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import load_file

    arrays = sample_arrays(np.random.default_rng(1))
    path = str(tmp_path / "y.safetensors")
    W.write_safetensors(path, arrays, dtype=dtype, metadata={"format": "pt"})
    got = load_file(path)
    tdtype = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]
    for k, v in arrays.items():
        want = torch.from_numpy(v).to(tdtype)    # round to nearest even, as the writer
        assert got[k].dtype == tdtype and torch.equal(got[k], want), k
    with safe_open(path, framework="pt") as fh:
        assert fh.metadata() == {"format": "pt"}
    with pytest.raises(TypeError, match="float"):
        W.write_safetensors(path, {"i": np.arange(3)})


# ---------------------------------------------------------------- tokenizer ----

def write_vocab(d, gz=False, all_bytes=False):
    """The miniature CLIP-style vocab of ``tests/test_weights.py:173-195``;
    with ``all_bytes`` every byte symbol too, so any text tokenizes."""
    os.makedirs(d, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for tok in ["a</w>", "person</w>", "p", "er", "s", "on", "pers", "on</w>"]:
        vocab.setdefault(tok, len(vocab))
    chars = (t_tok.bytes_to_unicode().values() if all_bytes
             else "abcdefghijklmnopqrstuvwxyz")
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    for tok in ["pe", "per", "pers", "person</w>"]:
        vocab.setdefault(tok, len(vocab))
    merges = "#version\n" + "\n".join(["p e", "pe r", "o n", "on </w>", "per s", "pers on</w>"])
    with open(os.path.join(d, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    mp = os.path.join(d, "merges.txt" + (".gz" if gz else ""))
    with (gzip.open(mp, "wt") if gz else open(mp, "w")) as fh:
        fh.write(merges)
    return os.path.join(d, "vocab.json"), mp


@pytest.mark.parametrize("gz", [False, True])
def test_tokenizer_ids_match_coma_tpu(tmp_path, gz):
    vp, mp = write_vocab(str(tmp_path), gz)
    texts = ["a person", "A  Person   persons", "pepper persons", "", "x" * 200,
             " a\tperson\n"]
    want = j_tok.CLIPTokenizer(vp, mp)(texts)
    got = t_tok.CLIPTokenizer(vp, mp)(texts)
    assert got.shape == (6, 77) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0 and got[0, 1] == 2 and got[0, -1] == 1   # BOS, "a</w>", EOS padding


# ------------------------------------------------------------------ configs ----

def write_configs(root, unet=None, vae=None, clip=None):
    for sub, cfg in (("unet", unet), ("vae", vae), ("text_encoder", clip)):
        if cfg is not None:
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            with open(os.path.join(root, sub, "config.json"), "w") as fh:
                json.dump(cfg, fh)


SD2_INPAINT_UNET = dict(  # stabilityai/stable-diffusion-2-inpainting unet/config.json
    in_channels=9, out_channels=4, block_out_channels=[320, 640, 1280, 1280],
    layers_per_block=2, cross_attention_dim=1024, attention_head_dim=[5, 10, 20, 20],
    norm_num_groups=32, use_linear_projection=True,
    down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
SD2_INPAINT_CLIP = dict(vocab_size=49408, hidden_size=1024, num_hidden_layers=23,
                        num_attention_heads=16, max_position_embeddings=77, hidden_act="gelu")
SD1_INPAINT_UNET = dict(in_channels=9, out_channels=4, block_out_channels=[320, 640, 1280, 1280],
                        layers_per_block=2, cross_attention_dim=768, attention_head_dim=8,
                        norm_num_groups=32)
SD1_CLIP = dict(vocab_size=49408, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                max_position_embeddings=77, hidden_act="quick_gelu")


@pytest.mark.parametrize("which", ["sd2", "sd1", "absent"])
def test_infer_sd_configs_matches_coma_tpu(tmp_path, which):
    if which == "sd2":
        write_configs(str(tmp_path), SD2_INPAINT_UNET, None, SD2_INPAINT_CLIP)
    elif which == "sd1":
        write_configs(str(tmp_path), SD1_INPAINT_UNET, None, SD1_CLIP)
    want = j_weights.infer_sd_configs(str(tmp_path))
    got = W.infer_sd_configs(str(tmp_path))
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        gd.pop("dtype"), wd.pop("dtype")
        assert gd == wd
    if which == "sd2":
        assert got[0] == t_unet.sd2_inpaint_unet_config(torch.float32)
        assert got[1] == t_clip.sd2_clip_text_config()


# ------------------------------------------------------------------ loading ----

def perturb_(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return module


def clip_state(clip_cfg, seed):
    """``coma_tpu``'s CLIP text tower at ``clip_cfg`` initialised from a key
    (every leaf then moved by seeded noise), renamed to transformers'
    ``CLIPTextModel`` keys by ``tests/test_weights.py``'s helpers."""
    from tests.test_weights import clip_rename, flax_to_torch_sd

    cfg = j_clip.CLIPTextConfig(
        vocab_size=clip_cfg["vocab_size"], hidden_size=clip_cfg["hidden_size"],
        num_layers=clip_cfg["num_hidden_layers"], num_heads=clip_cfg["num_attention_heads"],
        max_positions=clip_cfg["max_position_embeddings"], hidden_act=clip_cfg["hidden_act"])
    params = jax.jit(j_clip.CLIPTextEncoder(cfg).init)(jax.random.PRNGKey(seed),
                                                       jnp.zeros((1, 77), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.float32(a + rng.normal(size=a.shape) * 0.05), params)
    return flax_to_torch_sd(params["params"], renames=clip_rename)


def mirror_state(unet_cfg, vae_cfg, clip_cfg, seed=0):
    """diffusers-named numpy state dicts of seeded mirrors."""
    torch.manual_seed(seed)
    unet = perturb_(UNetMirror(
        block_out_channels=tuple(unet_cfg["block_out_channels"]),
        layers_per_block=unet_cfg["layers_per_block"],
        cross_attention_dim=unet_cfg["cross_attention_dim"],
        heads=unet_cfg["attention_head_dim"], groups=unet_cfg["norm_num_groups"]), seed)
    vae = perturb_(AutoencoderKLMirror(chs=tuple(vae_cfg["block_out_channels"]),
                                       layers_per_block=vae_cfg["layers_per_block"],
                                       groups=vae_cfg["norm_num_groups"]), seed + 1)
    as_np = lambda m: {k: v.detach().numpy() for k, v in m.state_dict().items()}
    return as_np(unet), as_np(vae), clip_state(clip_cfg, seed + 2)


def write_sd_dir(root, unet_cfg=SD1_UNET, vae_cfg=VAE, clip_cfg=CLIP, linear_projection=False,
                 dtype="F32", seed=0, all_bytes=False):
    unet, vae, clip = mirror_state(unet_cfg, vae_cfg, clip_cfg, seed)
    if linear_projection:   # SD-2.x stores proj_in/proj_out as Linear weights
        unet = {k: (v[:, :, 0, 0] if k.endswith((".proj_in.weight", ".proj_out.weight"))
                    and "ff." not in k else v) for k, v in unet.items()}
    write_configs(root, dict(unet_cfg, in_channels=9, out_channels=4,
                             down_block_types=["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]),
                  dict(vae_cfg, in_channels=3, latent_channels=4), clip_cfg)
    W.write_safetensors(os.path.join(root, W.UNET_FILE), unet, dtype)
    W.write_safetensors(os.path.join(root, W.VAE_FILE), vae, dtype)
    W.write_safetensors(os.path.join(root, W.CLIP_FILE), clip, dtype)
    write_vocab(os.path.join(root, "tokenizer"), all_bytes=all_bytes)
    return root


def port_models(params):
    ucfg = params["unet_config"]
    unet = W.load_state(t_unet.UNet2DCondition(ucfg), params["unet"]).eval()
    enc = W.load_state(t_vae.Encoder(params["vae_config"]), params["vae_encoder"]).eval()
    dec = W.load_state(t_vae.Decoder(params["vae_config"]), params["vae_decoder"]).eval()
    clip = W.load_state(t_clip.CLIPTextEncoder(params["clip_config"]), params["clip"]).eval()
    return unet, enc, dec, clip


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def forward_inputs(cross_dim, seed=0):
    rng = np.random.default_rng(seed)
    return dict(sample=np.float32(rng.normal(size=(2, 16, 16, 9))), t=np.float32([11.0, 801.0]),
                ctx=np.float32(rng.normal(size=(2, 7, cross_dim))),
                img=np.float32(rng.uniform(-1, 1, size=(2, 32, 32, 3))),
                z=np.float32(rng.normal(size=(2, 4, 4, 4))),
                ids=rng.integers(0, 128, size=(2, 77)).astype(np.int32))


def port_outputs(models, x):
    unet, enc, dec, clip = models
    with torch.no_grad():
        return dict(
            unet=unet(nchw(x["sample"]), torch.from_numpy(x["t"]),
                      torch.from_numpy(x["ctx"])).permute(0, 2, 3, 1).numpy(),
            enc=enc(nchw(x["img"])).permute(0, 2, 3, 1).numpy(),
            dec=dec(nchw(x["z"])).permute(0, 2, 3, 1).numpy(),
            clip=clip(torch.from_numpy(x["ids"].astype(np.int64))).numpy())


@pytest.fixture(scope="module")
def sd1_dir(tmp_path_factory):
    return write_sd_dir(str(tmp_path_factory.mktemp("sd1")))


def test_load_sd_params_forward_passes_match_coma_tpu(sd1_dir):
    params = W.load_sd_params(sd1_dir, dtype=torch.float32)
    jp = j_weights.load_sd_params(sd1_dir, dtype=jnp.float32)
    ucfg, ccfg = j_weights.infer_sd_configs(sd1_dir)
    vcfg = j_vae.VAEConfig(block_out_channels=tuple(VAE["block_out_channels"]),
                           layers_per_block=VAE["layers_per_block"],
                           norm_num_groups=VAE["norm_num_groups"])
    x = forward_inputs(SD1_UNET["cross_attention_dim"])
    want = dict(
        unet=jax.jit(j_unet.UNet2DCondition(ucfg).apply)(jp["unet"], x["sample"], x["t"],
                                                           x["ctx"]),
        enc=jax.jit(j_vae.Encoder(vcfg).apply)(jp["vae_encoder"], x["img"]),
        dec=jax.jit(j_vae.Decoder(vcfg).apply)(jp["vae_decoder"], x["z"]),
        clip=jax.jit(j_clip.CLIPTextEncoder(ccfg).apply)(jp["clip"], x["ids"]))
    got = port_outputs(port_models(params), x)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=CLIP_ATOL if k == "clip" else ATOL, err_msg=k)
    assert params["vae_config"] == dataclasses.replace(
        t_vae.VAEConfig(), block_out_channels=(16, 16, 32, 32), norm_num_groups=8)
    texts = ["a person", "persons"]
    np.testing.assert_array_equal(params["tokenizer"](texts), jp["tokenizer"](texts))


def test_linear_projections_load_to_the_same_outputs(tmp_path):
    """SD-2.x's 2-D ``proj_in``/``proj_out`` load in the port as the 1x1
    convolutions they are; ``coma_tpu``'s converter transposes them as 4-D
    kernels and raises."""
    conv = write_sd_dir(str(tmp_path / "conv"), unet_cfg=SD2_UNET)
    linear = write_sd_dir(str(tmp_path / "linear"), unet_cfg=SD2_UNET, linear_projection=True)
    with open(os.path.join(linear, "unet", "config.json")) as fh:
        assert json.load(fh)["use_linear_projection"] is True
    x = forward_inputs(SD2_UNET["cross_attention_dim"], seed=1)
    outs = [port_outputs(port_models(W.load_sd_params(d, dtype=torch.float32)), x)
            for d in (conv, linear)]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
    params = W.load_sd_params(linear, dtype=torch.float32)
    assert params["unet_config"].heads_per_block == (1, 2, 2, 4)
    assert params["unet"]["down_0_attn_0.proj_in.weight"].shape == (32, 32, 1, 1)
    with pytest.raises(ValueError, match="axes"):
        j_weights.load_sd_params(linear, dtype=jnp.float32)


def test_loader_refuses_missing_unused_and_misshapen_keys(sd1_dir, tmp_path):
    sd = W.read_safetensors(os.path.join(sd1_dir, W.UNET_FILE))
    ucfg, _ = W.infer_sd_configs(sd1_dir)
    assert W.convert_unet(sd, ucfg).keys() == t_unet.UNet2DCondition(ucfg).state_dict().keys()
    with pytest.raises(KeyError, match="missing"):
        W.convert_unet({k: v for k, v in sd.items() if not k.startswith("conv_out")}, ucfg)
    with pytest.raises(KeyError, match="unused"):
        W.convert_unet(dict(sd, stray=np.zeros(2, np.float32)), ucfg)
    with pytest.raises(ValueError, match="shape"):
        W.convert_unet(dict(sd, **{"conv_in.bias": np.zeros(3, np.float32)}), ucfg)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        W.load_sd_params(str(tmp_path / "nowhere"))


def test_export_round_trips_through_the_key_maps(sd1_dir):
    """The port's state dict, exported to diffusers names (F16 halves the
    write), reads back to the same modules."""
    params = W.load_sd_params(sd1_dir, dtype=torch.float32)
    unet, enc, dec, clip = port_models(params)
    ucfg, vcfg, ccfg = params["unet_config"], params["vae_config"], params["clip_config"]
    enc_map, dec_map = W.vae_key_map(vcfg)
    exported = dict(unet=W.export_state_dict(unet.state_dict(), W.unet_key_map(ucfg)),
                    vae={**W.export_state_dict(enc.state_dict(), enc_map),
                         **W.export_state_dict(dec.state_dict(), dec_map)},
                    clip=W.export_state_dict(clip.state_dict(), W.clip_key_map(ccfg)))
    originals = dict(unet=W.UNET_FILE, vae=W.VAE_FILE, clip=W.CLIP_FILE)
    for k, path in originals.items():
        sd = W.read_safetensors(os.path.join(sd1_dir, path))
        assert exported[k].keys() == sd.keys(), k
        for name, v in sd.items():
            np.testing.assert_array_equal(exported[k][name], v, err_msg=name)


def test_cli_weights_dir_against_coma_tpu(tmp_path, monkeypatch):
    """``cli/inpaint --weights_dir --tiny`` on one tiny diffusers directory:
    both CLIs' pipelines built from it agree (the prompt encoder at CLIP's
    1e-5; the bf16 UNet within 3e-2 of its output's largest magnitude, as
    ``tests/test_torch_sd_models.py`` holds bf16; the VAE at 2e-4), then the
    port's CLI runs end to end. ``coma_tpu`` converts the VAE at the SD-1.x
    layout whatever the directory declares, so its converter is given the
    tiny layout here; the port reads ``vae/config.json``."""
    import functools

    from coma_tpu.cli import inpaint as j_cli
    from coma_tpu_torch.cli import inpaint as t_cli
    from coma_tpu_torch.utils.png import read_png
    from tests.test_torch_inpaint import make_tree

    d = write_sd_dir(str(tmp_path / "sd"), vae_cfg=dict(VAE, layers_per_block=1),
                     clip_cfg=dict(CLIP, vocab_size=1000), dtype="F16", all_bytes=True)
    monkeypatch.setattr(j_weights, "convert_vae", functools.partial(
        j_weights.convert_vae, config=j_vae.tiny_vae_config()))
    argv = ["--tiny", "--weights_dir", d]
    j_pipe, j_params, j_encode, j_res = j_cli.build_pipeline(j_cli.build_parser().parse_args(argv))
    t_pipe, t_encode, t_res = t_cli.build_pipeline(
        t_cli.build_parser().parse_args(argv + ["--device", "cpu"]), torch.device("cpu"))
    assert j_res == t_res == 64

    texts = ["1 person wears the backpack", "worst quality, normal quality, low quality"]
    ctx_j = np.asarray(j_encode(texts))
    ctx_t = t_encode(texts)
    np.testing.assert_allclose(ctx_t.numpy(), ctx_j, rtol=0, atol=CLIP_ATOL)

    rng = np.random.default_rng(3)
    lat = np.float32(rng.normal(size=(2, 8, 8, 9)))
    t_in = np.float32([981.0, 981.0])
    want = np.asarray(jax.jit(j_pipe.unet_fn)(j_params, lat, t_in, ctx_j))
    with torch.no_grad():
        got = t_pipe.unet_fn(nchw(lat), torch.from_numpy(t_in), ctx_t).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-2 * np.abs(want).max())
    img = np.float32(rng.uniform(-1, 1, size=(2, 64, 64, 3)))
    z = np.float32(rng.normal(size=(2, 8, 8, 4)))
    with torch.no_grad():
        np.testing.assert_allclose(t_pipe.vae_encode_fn(nchw(img)).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jax.jit(j_pipe.vae_encode_fn)(j_params, img)),
                                   atol=ATOL)
        np.testing.assert_allclose(t_pipe.vae_decode_fn(nchw(z)).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jax.jit(j_pipe.vae_decode_fn)(j_params, z)),
                                   atol=ATOL)

    make_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    t_cli.main(["--device", "cpu", "--tiny", "--weights_dir", d, "--num_img_per_combination",
                "2", "--batch_size", "4"])
    outs = sorted((tmp_path / "results" / "generation" / "inpaintings").rglob("*.png"))
    assert len(outs) == 4 and all(read_png(str(p)).shape == (64, 64, 3) for p in outs)
