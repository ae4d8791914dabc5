"""The adaptive-mask inpainting loop and its CLI, the port against ``coma_tpu``.

The whole ``generate`` loop runs at 64², B = 2, 50 steps, mode ``p``, on
tiny models whose Flax params cross into the port. The port's noise source
replays JAX's key tree (``split(rng, 3)`` for the initial latents and the
default-mask encode, then ``split(rng)`` on every step), so both loops see
the same random numbers. The segment function is a fixed function of the
decoded image — 16x16 block means of the grey level against 0.5 — and the
test asserts that every block mean the loop produced stands clear of 0.5,
so float differences cannot flip a block. The mask latents agree exactly at
every step, the 21 provoke steps included, and the final images within
atol 1e-3.

The CLI runs on the CPU with ``--random_weights --tiny`` on a small seeded
tree; its work list equals ``coma_tpu``'s on the same tree.
"""
import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coma_tpu.cli import inpaint as j_cli
from coma_tpu.models.diffusion import pipeline as j_pipe
from coma_tpu.models.diffusion import unet as j_unet
from coma_tpu.models.diffusion import vae as j_vae
from coma_tpu_torch.cli import inpaint as t_cli
from coma_tpu_torch.cli._common import shard_worklist
from coma_tpu_torch.models.diffusion import pipeline as t_pipe
from coma_tpu_torch.models.diffusion import unet as t_unet
from coma_tpu_torch.models.diffusion import vae as t_vae
from coma_tpu_torch.models.flax_params import load_flax_params
from coma_tpu_torch.utils.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, B, BLOCK, THRESHOLD = 64, 2, 16, 0.5


class JaxKeyNoise:
    """The port's noise source, drawing what ``coma_tpu``'s loop draws from
    ``key``: NHWC normals from JAX, handed over as NCHW tensors."""

    def __init__(self, key, n_steps):
        rng, self.r_lat, self.r_mask = jax.random.split(key, 3)
        self.step_keys = []
        for _ in range(n_steps):
            rng, r_adapt = jax.random.split(rng)
            self.step_keys.append(r_adapt)

    @staticmethod
    def _draw(key, shape):
        b, c, h, w = shape
        x = np.asarray(jax.random.normal(key, (b, h, w, c), jnp.float32))
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))

    def latents(self, shape):
        return self._draw(self.r_lat, shape)

    def mask_encode(self, shape):
        return self._draw(self.r_mask, shape)

    def adapt(self, step, shape):
        return self._draw(self.step_keys[step], shape)


def j_block_person(images):  # (B, H, W, 3) -> (B, H, W)
    b, hh, ww, _ = images.shape
    m = images.mean(-1).reshape(b, hh // BLOCK, BLOCK, ww // BLOCK, BLOCK).mean((2, 4))
    m = (m > THRESHOLD).astype(jnp.float32)
    return jnp.repeat(jnp.repeat(m, BLOCK, axis=1), BLOCK, axis=2)


def t_block_person(images, seen):  # (B, 3, H, W) -> (B, H, W)
    m = F.avg_pool2d(images.mean(1, keepdim=True), BLOCK)[:, 0]
    seen.append(m)
    return F.interpolate((m > THRESHOLD).float()[:, None], scale_factor=BLOCK)[:, 0]


@pytest.fixture(scope="module")
def tiny_models():
    h, k = H // 8, jax.random.PRNGKey(0)
    ucfg, vcfg = j_unet.tiny_unet_config(), j_vae.tiny_vae_config()
    unet, enc, dec = j_unet.UNet2DCondition(ucfg), j_vae.Encoder(vcfg), j_vae.Decoder(vcfg)
    up = jax.jit(unet.init)(k, jnp.zeros((1, h, h, 9)), jnp.zeros((1,)),
                            jnp.zeros((1, 7, ucfg.cross_attention_dim)))
    ep = jax.jit(enc.init)(k, jnp.zeros((1, H, H, 3)))
    dp = jax.jit(dec.init)(k, jnp.zeros((1, h, h, 4)))
    jax_fns = (lambda lat, t, ctx: unet.apply(up, lat, t, ctx),
               lambda img: enc.apply(ep, img), lambda lat: dec.apply(dp, lat))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    port = (load_flax_params(t_unet.UNet2DCondition(t_unet.tiny_unet_config()), np_tree(up)),
            load_flax_params(t_vae.Encoder(t_vae.tiny_vae_config()), np_tree(ep)),
            load_flax_params(t_vae.Decoder(t_vae.tiny_vae_config()), np_tree(dp)))
    return jax_fns, port


def test_generate_loop_matches_coma_tpu(tiny_models):
    (j_unet_fn, j_enc_fn, j_dec_fn), (unet, enc, dec) = tiny_models
    rng = np.random.default_rng(0)
    init_image = np.float32(rng.uniform(-1, 1, size=(B, H, H, 3)))
    mask = np.zeros((B, H, H), np.float32)
    mask[:, 8:56, 12:52] = 1.0
    ctx = np.float32(rng.normal(size=(B, 7, 32)))
    neg = np.float32(rng.normal(size=(B, 7, 32)) * 0.1)
    key = jax.random.PRNGKey(1)

    jpipe = j_pipe.AdaptiveMaskInpaintPipeline(j_unet_fn, j_enc_fn, j_dec_fn, j_block_person)
    j_gen = jax.jit(functools.partial(jpipe.generate_p, return_intermediates=True))
    want, inter = j_gen(None, key, init_image, mask, ctx, neg)
    want, want_masks = np.asarray(want), np.asarray(inter["mask_lat"])[..., 0]  # (S, B, h, w)

    unet_masks, block_means = [], []

    def unet_fn(lat, t, c):
        unet_masks.append(lat[:B, 4].clone())          # the mask channel, per step
        return unet(lat, t, c)

    tpipe = t_pipe.AdaptiveMaskInpaintPipeline(
        unet_fn, enc, dec, lambda img: t_block_person(img, block_means))
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tpipe.generate(to_t(init_image.transpose(0, 3, 1, 2)), to_t(mask), to_t(ctx),
                         to_t(neg), noise=JaxKeyNoise(key, 50))

    provoke = np.flatnonzero(tpipe.config.provoke_flags())
    assert len(provoke) == 21 and len(block_means) == 21 and len(unet_masks) == 50
    margin = float(torch.cat([m.flatten() for m in block_means]).sub(THRESHOLD).abs().min())
    assert margin > 1e-4, f"a block mean came within {margin:.2e} of the threshold"
    default_lat = unet_masks[0].numpy()
    adapted = 0
    for i in range(49):   # the mask after step i enters the UNet at step i + 1
        np.testing.assert_array_equal(unet_masks[i + 1].numpy(), want_masks[i], err_msg=f"step {i}")
        adapted += i in provoke and not np.array_equal(want_masks[i], default_lat)
    assert adapted >= 5, "the loop never moved the mask away from the default"
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (B, H, H, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_baseline_mode_at_partial_strength_matches(tiny_models):
    """Mode 'baseline' (no segmenter) at strength 0.5: 25 steps from the
    noised image latents, which ``coma_tpu`` samples with the initial-noise
    key — the port's noise source hands the same draw to both uses."""
    (j_unet_fn, j_enc_fn, j_dec_fn), (unet, enc, dec) = tiny_models
    rng = np.random.default_rng(4)
    init_image = np.float32(rng.uniform(-1, 1, size=(B, H, H, 3)))
    mask = np.zeros((B, H, H), np.float32)
    mask[:, 16:48, 16:48] = 1.0
    ctx = np.float32(rng.normal(size=(B, 7, 32)))
    key = jax.random.PRNGKey(2)
    jpipe = j_pipe.AdaptiveMaskInpaintPipeline(
        j_unet_fn, j_enc_fn, j_dec_fn, None, j_pipe.AdaptiveMaskConfig(strength=0.5))
    want = np.asarray(jax.jit(jpipe.generate)(key, init_image, mask, ctx, ctx * 0))
    tpipe = t_pipe.AdaptiveMaskInpaintPipeline(
        unet, enc, dec, None, t_pipe.AdaptiveMaskConfig(strength=0.5))
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tpipe.generate(to_t(init_image.transpose(0, 3, 1, 2)), to_t(mask), to_t(ctx),
                         to_t(ctx * 0), noise=JaxKeyNoise(key, 50))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3, rtol=0)


def test_provoke_decode_factor_step_matches(tiny_models):
    """One provoke round at f = 2: x̂0 average-pooled, the mask math at half
    resolution, the adapted mask upsampled (nearest) and re-encoded."""
    (j_unet_fn, j_enc_fn, j_dec_fn), (unet, enc, dec) = tiny_models
    rng = np.random.default_rng(3)
    init_image = np.float32(rng.uniform(-1, 1, size=(B, H, H, 3)))
    mask = np.zeros((B, H, H), np.float32)
    mask[:, 4:60, 8:40] = 1.0
    pred_x0 = np.float32(rng.normal(size=(B, H // 8, H // 8, 4)))
    r_adapt = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(r_adapt, (B, H // 8, H // 8, 4), jnp.float32))

    def j_person(images):  # half resolution: 32², so 8x8 blocks, against 0.6
        b, hh, ww, _ = images.shape
        m = images.mean(-1).reshape(b, hh // 8, 8, ww // 8, 8).mean((2, 4)) > 0.6
        return jnp.repeat(jnp.repeat(m.astype(jnp.float32), 8, 1), 8, 2)

    seen = []

    def t_person(images):
        m = F.avg_pool2d(images.mean(1, keepdim=True), 8)[:, 0]
        seen.append(m)
        return F.interpolate((m > 0.6).float()[:, None], scale_factor=8)[:, 0]

    cfg = dict(provoke_decode_factor=2)
    jpipe = j_pipe.AdaptiveMaskInpaintPipeline(
        j_unet_fn, j_enc_fn, j_dec_fn, j_person, j_pipe.AdaptiveMaskConfig(**cfg))
    tpipe = t_pipe.AdaptiveMaskInpaintPipeline(
        unet, enc, dec, t_person, t_pipe.AdaptiveMaskConfig(**cfg))

    # coma_tpu's adapt() is a closure of generate_p: run the same round by hand
    from coma_tpu.models.diffusion.vae import sample_latents

    f, Hs = 2, H // 2
    x0 = jax.lax.reduce_window(jnp.asarray(pred_x0), 0.0, jax.lax.add, (1, f, f, 1),
                               (1, f, f, 1), "VALID") / (f * f)
    image = jnp.clip(j_dec_fn(x0 / 0.18215) / 2 + 0.5, 0, 1)
    human = j_person(image)
    dmask = jax.image.resize(jnp.asarray(mask), (B, Hs, Hs), "nearest")
    grown = j_pipe.dilate_mask(human, jnp.asarray((2 + f - 1) // f))
    adapted = jax.image.resize(jnp.logical_and(grown > 0, dmask > 0).astype(jnp.float32),
                               (B, H, H), "nearest")
    too_small = jnp.sum(human, axis=(1, 2)) < Hs * Hs * 0.008
    j_mask = jnp.where(too_small[:, None, None], jnp.asarray(mask), adapted)
    j_mask = j_pipe.binarize_mask(j_mask)
    want_lat = np.asarray(j_pipe.downsample_mask(j_mask, 8))[..., 0]
    want_masked = np.asarray(sample_latents(
        j_enc_fn(jnp.asarray(init_image) * (j_mask[..., None] < 0.5)), r_adapt, 0.18215))

    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with torch.no_grad():
        got_lat, got_masked = tpipe.adapt(
            to_t(pred_x0.transpose(0, 3, 1, 2)), to_t(mask),
            to_t(init_image.transpose(0, 3, 1, 2)), 2, False, to_t(eps.transpose(0, 3, 1, 2)))
    margin = float(seen[0].sub(0.6).abs().min())
    assert margin > 1e-4, f"a block mean came within {margin:.2e} of the threshold"
    np.testing.assert_array_equal(got_lat[:, 0].numpy(), want_lat)
    assert 0 < want_lat.mean() < float(np.asarray(j_pipe.downsample_mask(
        jnp.asarray(mask), 8)).mean()), "the round should shrink the mask"
    np.testing.assert_allclose(got_masked.permute(0, 2, 3, 1).numpy(), want_masked,
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SC, CAT, ASSET, VIEW = "BEHAVE", "backpack", "behave_asset", "view:00000"


def make_tree(root, res=64, prompts=("1 person wears the backpack",)):
    """A render, one asset mask, its valid-mask pickle and the prompts."""
    rng = np.random.default_rng(0)
    g = os.path.join(root, "results", "generation")
    for d in ("renders", "asset_masks", "valid_masks", "prompts"):
        os.makedirs(os.path.join(g, d, SC, CAT, ASSET), exist_ok=True)
    write_png(f"{g}/renders/{SC}/{CAT}/{ASSET}/{VIEW}.png",
              rng.integers(0, 256, size=(res, res, 3), dtype=np.uint8))
    os.makedirs(f"{g}/asset_masks/{SC}/{CAT}/{ASSET}/{VIEW}", exist_ok=True)
    mask = np.zeros((res, res), np.uint8)
    mask[res // 8: 7 * res // 8, res // 4: 3 * res // 4] = 255
    write_png(f"{g}/asset_masks/{SC}/{CAT}/{ASSET}/{VIEW}/0.png", mask)
    with open(f"{g}/valid_masks/{SC}/{CAT}/{ASSET}/{VIEW}.pickle", "wb") as fh:
        pickle.dump({"valid_mask_ids": [0]}, fh)
    with open(f"{g}/prompts/{SC}/{CAT}/{ASSET}/prompts.pickle", "wb") as fh:
        pickle.dump({"prompts": list(prompts)}, fh)


def test_cli_writes_the_expected_images(tmp_path, monkeypatch):
    make_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    t_cli.main(["--device", "cpu", "--random_weights", "--tiny",
                "--num_img_per_combination", "2", "--batch_size", "4"])
    outs = sorted((tmp_path / "results" / "generation" / "inpaintings").rglob("*.png"))
    # 1 mask x 1 prompt x 2 view augmentations x 2 images
    assert len(outs) == 4
    for p in outs:
        img = read_png(str(p))
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert {p.parent.name for p in outs} == {"1 person wears the backpack",
                                             "1 person wears the backpack, full body"}


def test_worklist_matches_coma_tpu(tmp_path, monkeypatch):
    make_tree(tmp_path, prompts=("1 person wears the backpack", "1 person zips the backpack"))
    monkeypatch.chdir(tmp_path)
    argv = ["--num_img_per_combination", "3"]
    want = j_cli.build_worklist(j_cli.build_parser().parse_args(argv))
    got = t_cli.build_worklist(t_cli.build_parser().parse_args(argv))
    assert len(got) == 12 and got == want
    assert all(w["strength"] == 0.98 for w in got)   # read, unused (ROADMAP Queue 3)
    from coma_tpu.cli._common import shard_worklist as j_shard

    for n in (1, 3, 5):
        for i in range(n):
            assert shard_worklist(got, i, n) == j_shard(want, i, n)


@pytest.mark.parametrize("flags", [
    ["--weights_dir", "w"], ["--adaptive_mask_model_type", "ps"],
    ["--person_segmenter", "pointrend"], ["--provoke_crop", "auto"],
    ["--save_step_video"], ["--mesh", "all"], [],
])
def test_cli_refuses_what_is_not_ported(flags):
    argv = ["--device", "cpu", "--tiny"] + (flags or []) + (["--random_weights"] if flags else [])
    with pytest.raises(SystemExit, match="ROADMAP|random_weights"):
        t_cli.main(argv)


def test_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--random_weights", "--tiny"])


def test_prompt_ids_do_not_depend_on_the_process():
    texts = ["1 person wears the backpack", "worst quality"]
    code = ("from coma_tpu_torch.cli.inpaint import prompt_token_ids; "
            f"print(prompt_token_ids({texts!r}).tolist())")
    outs = {subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=seed)
                           ).stdout for seed in ("1", "2")}
    assert len(outs) == 1
    ids = t_cli.prompt_token_ids(texts)
    assert str(ids.tolist()) == outs.pop().strip()
    assert ids.shape == (2, 77) and ids.min() >= 0 and ids.max() < 1000
