"""The DDIM schedule and step, and the loop's mask helpers, against ``coma_tpu``.

Schedule tables are equal; the tensor steps agree with ``ddim_step_traced``
and ``ddim_step`` at rtol 1e-6 on the same numpy inputs; dilation,
binarization, nearest downsampling and the dilate/provoke schedules are
equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models.diffusion import ddim as j_ddim
from coma_tpu.models.diffusion import pipeline as j_pipe
from coma_tpu_torch.models.diffusion import ddim as t_ddim
from coma_tpu_torch.models.diffusion import pipeline as t_pipe


@pytest.mark.parametrize("steps", [50, 20, 7])
def test_schedule_tables_equal(steps):
    j, t = j_ddim.make_ddim_schedule(steps), t_ddim.make_ddim_schedule(steps)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.alphas_cumprod, j.alphas_cumprod)
    np.testing.assert_array_equal(t.prev_timesteps, j.prev_timesteps)
    assert t.final_alpha_cumprod == j.final_alpha_cumprod
    np.testing.assert_array_equal(t.alpha_prod(t.prev_timesteps), j.alpha_prod(j.prev_timesteps))
    for strength in (1.0, 0.98, 0.5):
        (tt, ts), (jt, js) = (t_ddim.inpaint_timesteps(t, strength),
                              j_ddim.inpaint_timesteps(j, strength))
        np.testing.assert_array_equal(tt, jt)
        assert ts == js


@pytest.mark.parametrize("index", [0, 1, 24, 48, 49])
def test_steps_match(index, rng):
    sched_j, sched_t = j_ddim.make_ddim_schedule(50), t_ddim.make_ddim_schedule(50)
    x = np.float32(rng.normal(size=(2, 4, 8, 8)))
    eps = np.float32(rng.normal(size=(2, 4, 8, 8)))
    for j_step, t_step in ((j_ddim.ddim_step_traced, t_ddim.ddim_step_traced),
                           (j_ddim.ddim_step, t_ddim.ddim_step)):
        idx = jnp.asarray(index) if j_step is j_ddim.ddim_step_traced else index
        want = j_step(sched_j, idx, jnp.asarray(eps), jnp.asarray(x))
        got = t_step(sched_t, index, torch.from_numpy(eps), torch.from_numpy(x))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_add_noise_matches(rng):
    sched_j, sched_t = j_ddim.make_ddim_schedule(50), t_ddim.make_ddim_schedule(50)
    x0, noise = (np.float32(rng.normal(size=(1, 4, 8, 8))) for _ in range(2))
    want = j_ddim.add_noise(sched_j, jnp.asarray(x0), jnp.asarray(noise), 960)
    got = t_ddim.add_noise(sched_t, torch.from_numpy(x0), torch.from_numpy(noise), 960)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_schedules_equal():
    assert t_pipe.default_dilate_schedule(50) == j_pipe.default_dilate_schedule(50)
    assert t_pipe.default_dilate_schedule(30) == j_pipe.default_dilate_schedule(30)
    assert t_pipe.default_provoke_schedule(50) == j_pipe.default_provoke_schedule(50)
    for adaptive in (True, False):
        jc = j_pipe.AdaptiveMaskConfig(use_adaptive_mask=adaptive)
        tc = t_pipe.AdaptiveMaskConfig(use_adaptive_mask=adaptive)
        np.testing.assert_array_equal(tc.provoke_flags(), jc.provoke_flags())


@pytest.mark.parametrize("iterations", [0, 1, 3, 20])
def test_dilate_mask_equal(iterations, rng):
    m = np.float32(rng.uniform(size=(2, 40, 48)) > 0.97)
    m[0, 0, 0] = m[1, -1, -1] = 1.0           # seeds on the border
    want = np.asarray(j_pipe.dilate_mask(jnp.asarray(m), jnp.asarray(iterations)))
    got = t_pipe.dilate_mask(torch.from_numpy(m), iterations).numpy()
    np.testing.assert_array_equal(got, want)


def test_binarize_and_downsample_equal(rng):
    m = np.float32(rng.uniform(size=(2, 64, 64)))
    m[0, :3, :3] = 0.5
    want_b = np.asarray(j_pipe.binarize_mask(jnp.asarray(m)))
    got_b = t_pipe.binarize_mask(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got_b, want_b)
    want_d = np.asarray(j_pipe.downsample_mask(jnp.asarray(want_b), 8))      # (B, h, w, 1)
    got_d = t_pipe.downsample_mask(torch.from_numpy(got_b), 8).numpy()      # (B, 1, h, w)
    np.testing.assert_array_equal(got_d[:, 0], want_d[..., 0])
