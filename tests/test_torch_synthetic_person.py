"""The port's segmenter training data (``models/synthetic_person.py``)
against ``coma_tpu``'s from the same seeds: ``person_batch``, the
procedural domain with and without corruption (the JPEG step through
``utils/jpeg.py``, which equals Pillow on these images), ``sd_corrupt`` and
the rendered domain over a given pool are bit-equal; the rendered pool
itself, through the port's textured rasterizer, within the renderer's
tolerance (1e-4 on 99.9% of values, 0.15 at most)."""
import numpy as np
import pytest

from coma_tpu.models import synthetic_person as J
from coma_tpu_torch.models import synthetic_person as T


def assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("size", [32, 64])
def test_person_batch_bit_equal(size):
    assert_batches_equal(T.person_batch(np.random.default_rng(size), 6, size),
                         J.person_batch(np.random.default_rng(size), 6, size))


@pytest.mark.parametrize("corrupt", [False, True])
def test_procedural_domain_bit_equal(corrupt):
    kw = dict(batch=8, size=48, background="procedural", corrupt=corrupt)
    assert_batches_equal(T.person_batch_domain(np.random.default_rng(3), device="cpu", **kw),
                         J.person_batch_domain(np.random.default_rng(3), **kw))


def test_sd_corrupt_bit_equal_over_seeds():
    img = J.person_batch(np.random.default_rng(0), 1, 64)[0][0]
    for seed in range(12):      # the seeds cover each corruption, the JPEG one included
        got = T.sd_corrupt(img, np.random.default_rng(seed))
        want = J.sd_corrupt(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_rendered_pool_within_render_tolerance():
    got = T.rendered_background_pool(7, n=3, size=32, device="cpu")
    want = J.rendered_background_pool(7, n=3, size=32)
    assert got.shape == want.shape == (3, 32, 32, 3) and got.dtype == np.float32
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 0.15
    holdout = T.rendered_background_pool(8, n=2, size=32, holdout=True, device="cpu")
    diff = np.abs(holdout - J.rendered_background_pool(8, n=2, size=32, holdout=True))
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 0.15


def test_rendered_domain_bit_equal_over_one_pool():
    pool = J.rendered_background_pool(9, n=3, size=32)
    kw = dict(batch=6, size=32, background="rendered", corrupt=True, bg_pool=pool)
    assert_batches_equal(T.person_batch_domain(np.random.default_rng(4), device="cpu", **kw),
                         J.person_batch_domain(np.random.default_rng(4), **kw))


def test_procedural_scene_equal():
    got = T._procedural_scene(np.random.default_rng(5), holdout=True)
    want = J._procedural_scene(np.random.default_rng(5), holdout=True)
    for field in ("vertices", "faces", "uvs", "face_uvs", "face_material", "textures"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
