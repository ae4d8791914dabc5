"""The adaptive-mask loop with the real segmenters in it, the port against ``coma_tpu``.

The 50-step loop of ``tests/test_torch_inpaint.py`` (64², B = 2, tiny UNet
and VAE whose Flax params cross into the port, JAX's key tree replayed)
runs in mode ``ps`` (the tiny SAM refining the block-mean mask's box) and
with ``--person_segmenter pointrend`` (the ``--tiny`` detector config on
the seeded detectron2-layout weights of ``tests/test_torch_pointrend.py``).
The per-step outputs of ``return_intermediates`` are compared: the mask
latents equal at every step, x̂0 and the images within atol 1e-3; the mask
must move away from the default at three provoke rounds or more.
"""
import functools

import jax
import numpy as np
import torch

from coma_tpu.models.diffusion import pipeline as j_pipe
from coma_tpu_torch.models.diffusion import pipeline as t_pipe
from tests.test_torch_inpaint import (  # noqa: F401  (tiny_models and few_torch_threads are fixtures)
    B,
    H,
    JaxKeyNoise,
    few_torch_threads,
    j_block_person,
    t_block_person,
    tiny_models,
)


def run_both_loops(tiny_models, j_segment, t_segment, key, seed, full_frame=False):
    """The 50-step loop at 64², B = 2, on both sides with one key tree and
    the given segment functions, the default mask a box or the full frame;
    returns (JAX images and per-step outputs, the port's)."""
    (j_unet_fn, j_enc_fn, j_dec_fn), (unet, enc, dec) = tiny_models
    rng = np.random.default_rng(seed)
    init_image = np.float32(rng.uniform(-1, 1, size=(B, H, H, 3)))
    mask = np.ones((B, H, H), np.float32)
    if not full_frame:
        mask[:] = 0.0
        mask[:, 6:58, 10:54] = 1.0
    ctx = np.float32(rng.normal(size=(B, 7, 32)))
    neg = np.float32(rng.normal(size=(B, 7, 32)) * 0.1)
    jpipe = j_pipe.AdaptiveMaskInpaintPipeline(j_unet_fn, j_enc_fn, j_dec_fn, j_segment)
    want, inter = jax.jit(functools.partial(jpipe.generate_p, return_intermediates=True))(
        None, key, init_image, mask, ctx, neg)
    tpipe = t_pipe.AdaptiveMaskInpaintPipeline(unet, enc, dec, t_segment)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got, t_inter = tpipe.generate(to_t(init_image.transpose(0, 3, 1, 2)), to_t(mask), to_t(ctx),
                                  to_t(neg), noise=JaxKeyNoise(key, 50), return_intermediates=True)
    return (np.asarray(want), jax.tree.map(np.asarray, inter)), (got, t_inter)


def check_loops(want, inter, got, t_inter):
    """Equal mask latents at every step; x̂0 and the images within 1e-3."""
    assert t_inter["mask_lat"].shape == (50, B, 1, H // 8, H // 8)
    assert t_inter["pred_x0"].shape == (50, B, 4, H // 8, H // 8)
    np.testing.assert_array_equal(t_inter["mask_lat"][:, :, 0].numpy(), inter["mask_lat"][..., 0])
    np.testing.assert_allclose(t_inter["pred_x0"].permute(0, 1, 3, 4, 2).numpy(),
                               inter["pred_x0"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3, rtol=0)
    default_lat = inter["mask_lat"][0, ..., 0]
    provoke = np.flatnonzero(t_pipe.AdaptiveMaskConfig().provoke_flags())
    return sum(not np.array_equal(inter["mask_lat"][i, ..., 0], default_lat) for i in provoke)


def test_sam_mode_loop_matches_coma_tpu(tiny_models):
    """Mode ``ps`` in the loop: the block-mean person mask's box prompts the
    tiny SAM at every provoke round; the per-step outputs of
    ``return_intermediates``. The SAM weights are the port's
    ``--random_weights`` draw (``init_sam_random_``, seed 2), written in the
    official key layout and read back by both loaders."""
    import re

    from coma_tpu.models import sam as j_sam
    from coma_tpu.models.torch_weights_sam import convert_sam
    from coma_tpu_torch.models import sam as t_sam
    from coma_tpu_torch.models import segmenter_weights as sw
    from tests.test_sam import _official_tiny_state_dict

    cfg = j_sam.tiny_sam_config()
    drawn = t_sam.init_sam_random_(t_sam.SAM(t_sam.tiny_sam_config()),
                                   torch.Generator().manual_seed(2)).state_dict()
    sd = {}
    for k in _official_tiny_state_dict(cfg, np.random.default_rng(0)):
        m = re.match(r"^prompt_encoder\.point_embeddings\.(\d+)\.weight$", k)
        if m:
            sd[k] = drawn["prompt_encoder.point_embed"][int(m.group(1))][None].clone()
            continue
        name = sw._rename(k, sw._SAM_RULES)
        sd[k] = drawn[name][None].clone() if name.endswith("no_mask_embed") else drawn[name]
    variables = convert_sam(sd, depth=cfg.depth)
    port_sam = sw.load_state_strict(t_sam.SAM(t_sam.tiny_sam_config()),
                                    sw.sam_state_dict(sd)).eval()
    j_fn = j_sam.make_sam_segment_fn(j_sam.SAM(cfg), lambda prm, x: j_block_person(x))
    t_fn = t_sam.make_sam_segment_fn(port_sam, lambda x: t_block_person(x, []))
    (want, inter), (got, t_inter) = run_both_loops(
        tiny_models, lambda x: j_fn({"sam": variables}, x), t_fn, jax.random.PRNGKey(7), 7)
    assert check_loops(want, inter, got, t_inter) >= 3


def test_pointrend_mode_loop_matches_coma_tpu(tiny_models):
    """``--person_segmenter pointrend`` in the loop at the ``--tiny``
    detector config, on the seeded detectron2-layout weights of
    ``tests/test_torch_pointrend.py``, a person at every proposal (score
    threshold 0.8 kept); the default mask is the full frame, so the ~10% of
    it the merged person masks leave out moves the mask."""
    from coma_tpu.models import pointrend as jpr
    from coma_tpu_torch.models import pointrend as tpr
    from coma_tpu_torch.models import segmenter_weights as sw
    from tests.test_torch_pointrend import TINY, weights

    sd, variables = weights.__wrapped__()
    port = sw.load_state_strict(tpr.PointRendModel(tpr.PointRendConfig(**TINY)),
                                sw.pointrend_state_dict(sd)).eval()
    j_fn = jpr.make_pointrend_segment_fn(jpr.PointRendModel(jpr.PointRendConfig(**TINY)))
    t_fn = tpr.make_pointrend_segment_fn(port)
    (want, inter), (got, t_inter) = run_both_loops(
        tiny_models, lambda x: j_fn({"pointrend": variables}, x), t_fn, jax.random.PRNGKey(8), 8,
        full_frame=True)
    assert check_loops(want, inter, got, t_inter) >= 3


def test_adaptive_modes_take_only_the_50_step_schedule():
    """Both packages' provoke schedule is defined for 50 steps alone: an
    adaptive loop at another step count raises in both, 'baseline' does not
    (ROADMAP Queue 3)."""
    import pytest

    for pipe in (j_pipe, t_pipe):
        with pytest.raises(AssertionError):
            pipe.AdaptiveMaskConfig(num_inference_steps=2).provoke_flags()
        assert not pipe.AdaptiveMaskConfig(num_inference_steps=2,
                                           use_adaptive_mask=False).provoke_flags().any()
