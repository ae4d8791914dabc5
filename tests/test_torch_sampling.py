"""Bilinear point sampling and ROIAlign, the port against ``coma_tpu``.

The same seeded numpy inputs go through ``coma_tpu.ops.sampling`` (JAX on
the CPU) and ``coma_tpu_torch.ops.sampling``, points and boxes reaching
past the map's edges included. Tolerance rtol 1e-5 / atol 1e-5 (float32:
the two compute each corner weight in the same order; the bin means sum in
another).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.ops import sampling as j_s
from coma_tpu_torch.ops import sampling as t_s

TOL = dict(rtol=1e-5, atol=1e-5)
STRIDES = (4, 8, 16, 32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pyramid(rng, C=6, H=64, W=96):
    return [rng.normal(size=(H // s * 4, W // s * 4, C)).astype(np.float32)
            for s in STRIDES]


def boxes(rng, n, H=256, W=384):
    """Boxes of all sizes (levels 2..5), some reaching past the frame."""
    c = rng.uniform(-20, [W + 20, H + 20], size=(n, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), size=(n, 2)))
    return np.float32(np.concatenate([c - wh / 2, c + wh / 2], axis=1))


@pytest.mark.parametrize("shape", [(13, 17, 5), (1, 9, 3)])
def test_grid_sample_bilinear_matches(shape):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=shape).astype(np.float32)
    coords = rng.uniform(-0.15, 1.15, size=(7, 9, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [1, 1], [0.5 / shape[1], 0.5 / shape[0]], [1, 0]]
    want = np.asarray(j_s.grid_sample_bilinear(jnp.asarray(feat), jnp.asarray(coords)))
    got = t_s.grid_sample_bilinear(t(feat), t(coords)).numpy()
    assert got.shape == (7, 9, shape[2])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_s.point_sample(t(feat), t(coords[0])).numpy(), want[0], **TOL)


def test_grid_sample_batched_equals_each_image():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(3, 8, 10, 4)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, size=(3, 11, 2)).astype(np.float32)
    got = t_s.grid_sample_bilinear(t(feat), t(coords)).numpy()
    for b in range(3):
        want = np.asarray(j_s.grid_sample_bilinear(jnp.asarray(feat[b]), jnp.asarray(coords[b])))
        np.testing.assert_allclose(got[b], want, **TOL)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_roi_align_matches(scale):
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(24, 32, 5)).astype(np.float32)
    b = boxes(rng, 12, H=24 / scale, W=32 / scale)
    want = np.asarray(j_s.roi_align(jnp.asarray(feat), jnp.asarray(b), 7, scale))
    got = t_s.roi_align(t(feat), t(b), 7, scale).numpy()
    assert got.shape == (12, 7, 7, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_fpn_level_assignment_matches():
    rng = np.random.default_rng(3)
    b = boxes(rng, 200)
    b[:4] = [[0, 0, 0, 0], [5, 5, 4, 4], [0, 0, 224, 224], [0, 0, 900, 900]]  # empty, inverted,
    # canonical, level 5
    want = np.asarray(j_s._fpn_level_assignment(jnp.asarray(b), 4, 4, 224.0))
    got = t_s._fpn_level_assignment(t(b), 4, 4, 224.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("n,chunk", [(40, 1024), (300, 64)])
def test_multilevel_roi_align_matches(n, chunk):
    """Both ``coma_tpu`` paths (its chunked gather for n > 256) and the
    port's, chunked or not, against each other and the dense oracle."""
    rng = np.random.default_rng(4)
    feats = pyramid(rng)
    b = boxes(rng, n)
    jf = [jnp.asarray(f) for f in feats]
    want = np.asarray(j_s.multilevel_roi_align(jf, jnp.asarray(b), 7, STRIDES))
    got = t_s.multilevel_roi_align([t(f) for f in feats], t(b), 7, STRIDES, chunk=chunk).numpy()
    assert got.shape == (n, 7, 7, 6)
    np.testing.assert_allclose(got, want, **TOL)
    dense = t_s._multilevel_roi_align_dense([t(f) for f in feats], t(b), 7, STRIDES).numpy()
    np.testing.assert_allclose(dense, want, **TOL)
    np.testing.assert_allclose(
        dense, np.asarray(j_s._multilevel_roi_align_dense(jf, jnp.asarray(b), 7, STRIDES)), **TOL)


def test_multilevel_roi_align_batched_equals_each_image():
    rng = np.random.default_rng(5)
    per_image = [pyramid(rng) for _ in range(2)]
    feats = [np.stack([p[level] for p in per_image]) for level in range(4)]
    b = np.stack([boxes(rng, 30), boxes(rng, 30)])
    got = t_s.multilevel_roi_align([t(f) for f in feats], t(b), 14, STRIDES, chunk=16).numpy()
    for i in range(2):
        want = np.asarray(j_s.multilevel_roi_align([jnp.asarray(f) for f in per_image[i]],
                                                   jnp.asarray(b[i]), 14, STRIDES))
        np.testing.assert_allclose(got[i], want, **TOL)
