"""The port's UNet, VAE and CLIP text tower against ``coma_tpu``'s Flax models.

Each Flax model is initialised with a JAX key; its params cross into the
port's module through ``coma_tpu_torch.models.flax_params``, and both run
on the same numpy inputs (NHWC for Flax, NCHW for the port). Tolerances:
UNet, VAE encode and VAE decode atol 2e-4 (``tests/test_sd_parity.py``'s),
CLIP atol 1e-5, all in float32; one bf16 UNet forward against Flax in bf16
within 3e-2 of the output's largest magnitude (bf16 keeps 8 bits; the two
frameworks round at the same points but accumulate in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models.diffusion import clip_text as j_clip
from coma_tpu.models.diffusion import unet as j_unet
from coma_tpu.models.diffusion import vae as j_vae
from coma_tpu_torch.models.diffusion import clip_text as t_clip
from coma_tpu_torch.models.diffusion import unet as t_unet
from coma_tpu_torch.models.diffusion import vae as t_vae
from coma_tpu_torch.models.flax_params import flax_to_state_dict, load_flax_params

ATOL = 2e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unet_params():
    cfg = j_unet.tiny_unet_config()
    params = jax.jit(j_unet.UNet2DCondition(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 9)), jnp.zeros((1,)),
        jnp.zeros((1, 7, cfg.cross_attention_dim)))
    return np_tree(params)


@pytest.fixture(scope="module")
def vae_params():
    cfg = j_vae.tiny_vae_config()
    k = jax.random.PRNGKey(1)
    enc = jax.jit(j_vae.Encoder(cfg).init)(k, jnp.zeros((1, 32, 32, 3)))
    dec = jax.jit(j_vae.Decoder(cfg).init)(k, jnp.zeros((1, 4, 4, 4)))
    return np_tree(enc), np_tree(dec)


def unet_inputs(rng):
    sample = np.float32(rng.normal(size=(2, 16, 16, 9)))
    t = np.float32([11.0, 801.0])
    ctx = np.float32(rng.normal(size=(2, 7, 32)))
    return sample, t, ctx


def test_unet_forward_matches_flax(unet_params, rng):
    sample, t, ctx = unet_inputs(rng)
    want = np.asarray(jax.jit(j_unet.UNet2DCondition(j_unet.tiny_unet_config()).apply)(
        unet_params, sample, t, ctx))
    model = load_flax_params(t_unet.UNet2DCondition(t_unet.tiny_unet_config()), unet_params)
    with torch.no_grad():
        got = model(nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 4, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=0)


def test_unet_bf16_forward_matches_flax_bf16(unet_params, rng):
    """Params stay fp32; Dense/Conv compute in bf16, the norms in fp32."""
    sample, t, ctx = unet_inputs(rng)
    jcfg = j_unet.tiny_unet_config(jnp.bfloat16)
    want = np.asarray(jax.jit(j_unet.UNet2DCondition(jcfg).apply)(
        unet_params, jnp.asarray(sample, jnp.bfloat16), t, jnp.asarray(ctx, jnp.bfloat16)
    ).astype(jnp.float32))
    model = load_flax_params(
        t_unet.UNet2DCondition(t_unet.tiny_unet_config(torch.bfloat16)), unet_params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = model(nchw(sample).bfloat16(), torch.from_numpy(t),
                    torch.from_numpy(ctx).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), want, atol=3e-2 * np.abs(want).max(), rtol=0)


def test_unet_timestep_embedding_matches():
    """The angles reach 999 rad, so one ulp of ``exp`` in either framework
    moves cos/sin by up to 999 * 6e-8 = 6e-5: atol 1e-4."""
    t = np.float32([0.0, 47.0, 999.0])
    want = np.asarray(j_unet.timestep_embedding(jnp.asarray(t), 320))
    got = t_unet.timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unet_configs_match():
    for j_cfg, t_cfg in ((j_unet.UNetConfig(), t_unet.UNetConfig()),
                         (j_unet.sd2_inpaint_unet_config(), t_unet.sd2_inpaint_unet_config()),
                         (j_unet.tiny_unet_config(), t_unet.tiny_unet_config())):
        for f in ("block_out_channels", "layers_per_block", "cross_attention_dim",
                  "norm_num_groups", "cross_attn_blocks", "in_channels"):
            assert getattr(t_cfg, f) == getattr(j_cfg, f)
        assert [t_cfg.heads_for(b) for b in (0, 1, 2, 3, None)] == \
               [j_cfg.heads_for(b) for b in (0, 1, 2, 3, None)]


def test_vae_encode_and_decode_match_flax(vae_params, rng):
    enc_p, dec_p = vae_params
    jcfg, tcfg = j_vae.tiny_vae_config(), t_vae.tiny_vae_config()
    x = np.float32(rng.uniform(-1, 1, size=(2, 32, 32, 3)))
    z = np.float32(rng.normal(size=(2, 4, 4, 4)))
    want_m = np.asarray(j_vae.Encoder(jcfg).apply(enc_p, x))
    want_x = np.asarray(j_vae.Decoder(jcfg).apply(dec_p, z))
    enc = load_flax_params(t_vae.Encoder(tcfg), enc_p)
    dec = load_flax_params(t_vae.Decoder(tcfg), dec_p)
    with torch.no_grad():
        got_m, got_x = enc(nchw(x)), dec(nchw(z))
    assert got_m.shape == (2, 8, 4, 4) and got_x.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(nhwc(got_m), want_m, atol=ATOL, rtol=0)
    np.testing.assert_allclose(nhwc(got_x), want_x, atol=ATOL, rtol=0)


def test_sample_latents_matches(rng):
    moments = np.float32(rng.normal(size=(2, 4, 4, 8)) * 3)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_vae.sample_latents(jnp.asarray(moments), key, 0.18215))
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
    got = t_vae.sample_latents(nchw(moments), nchw(eps), 0.18215)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-7)


def test_clip_matches_flax(rng):
    jcfg, tcfg = j_clip.tiny_clip_config(), t_clip.tiny_clip_config()
    ids = rng.integers(0, 1000, size=(3, 77)).astype(np.int32)
    model = j_clip.CLIPTextEncoder(jcfg)
    params = np_tree(jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32)))
    want = np.asarray(jax.jit(model.apply)(params, ids))
    port = load_flax_params(t_clip.CLIPTextEncoder(tcfg), params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_clip_gelu_variant_matches(rng):
    """The SD-2 text tower's exact-erf gelu, at a tiny width."""
    import dataclasses

    jcfg = dataclasses.replace(j_clip.tiny_clip_config(), hidden_act="gelu")
    tcfg = dataclasses.replace(t_clip.tiny_clip_config(), hidden_act="gelu")
    ids = rng.integers(0, 1000, size=(2, 9)).astype(np.int32)
    model = j_clip.CLIPTextEncoder(jcfg)
    params = np_tree(model.init(jax.random.PRNGKey(4), ids))
    want = np.asarray(model.apply(params, ids))
    port = load_flax_params(t_clip.CLIPTextEncoder(tcfg), params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_converter_layouts_and_errors(vae_params):
    enc_p, _ = vae_params
    sd = flax_to_state_dict(enc_p)
    kern = enc_p["params"]["conv_in"]["kernel"]                      # (kh, kw, I, O)
    np.testing.assert_array_equal(sd["conv_in.weight"], kern.transpose(3, 2, 0, 1))
    dense = enc_p["params"]["mid_attn"]["to_q"]["kernel"]            # (I, O)
    np.testing.assert_array_equal(sd["mid_attn.to_q.weight"], dense.T)
    np.testing.assert_array_equal(sd["mid_attn.group_norm.weight"],
                                  enc_p["params"]["mid_attn"]["group_norm"]["scale"])
    cfg = t_vae.tiny_vae_config()
    missing = {"params": {k: v for k, v in enc_p["params"].items() if k != "quant_conv"}}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(t_vae.Encoder(cfg), missing)
    extra = {"params": dict(enc_p["params"], stray={"kernel": np.zeros((2, 2))})}
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(t_vae.Encoder(cfg), extra)
    wrong = {"params": dict(enc_p["params"], quant_conv={
        "kernel": np.zeros((1, 1, 8, 4), np.float32), "bias": np.zeros(4, np.float32)})}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(t_vae.Encoder(cfg), wrong)
