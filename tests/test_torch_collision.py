"""``ops/collision.py``, the port against ``coma_tpu`` on the CPU.

The counts are integers and must be equal: self-collisions (pairs sharing a
vertex excluded), cross-mesh pairs at several tilings, the
``max_collisions`` cap, the collision curve over a displacement sweep, and
the local-minimum candidate filter on random and hand-made curves.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from coma_tpu.ops import collision as J
from coma_tpu_torch.ops import collision as T


def meshes(seed):
    rng = np.random.default_rng(seed)
    va = np.float32(rng.uniform(size=(150, 3)))
    fa = rng.integers(0, 150, size=(220, 3))
    vb = np.float32(rng.uniform(size=(90, 3)) + [0.4, 0.0, 0.0])
    fb = rng.integers(0, 90, size=(130, 3))
    return va, fa, vb, fb


@pytest.mark.parametrize("seed", [0, 1])
def test_self_and_cross_counts_equal(seed):
    va, fa, vb, fb = meshes(seed)
    want = J.count_self_collisions(va, fa, max_collisions=10 ** 6)
    assert want > 0
    assert T.count_self_collisions(va, fa, max_collisions=10 ** 6) == want
    assert T.count_self_collisions(va, fa, max_collisions=10 ** 6, block_a=37,
                                   block_b=51) == want
    want = J.count_cross_collisions(va, fa, vb, fb, max_collisions=10 ** 6)
    assert want > 0
    for blocks in ((128, 1024), (16, 40), (1, 7)):
        got = T.count_cross_collisions(va, fa, vb, fb, max_collisions=10 ** 6,
                                       block_a=blocks[0], block_b=blocks[1])
        assert got == want, blocks


def test_cap_and_separated_meshes():
    va, fa, vb, fb = meshes(2)
    n = J.count_cross_collisions(va, fa, vb, fb, max_collisions=10 ** 6)
    assert T.count_cross_collisions(va, fa, vb, fb, max_collisions=7) == 7 < n
    assert T.count_self_collisions(va, fa, max_collisions=3) == 3
    assert T.count_cross_collisions(va, fa, vb + 5.0, fb) == 0


def test_collision_curve_equal():
    va, fa, vb, fb = meshes(3)
    disps = np.float32(np.linspace(-1.2, 1.2, 9))
    direction = np.float32([1.0, 0.2, 0.0])
    want = np.asarray(J.collision_curve(jnp.asarray(va), jnp.asarray(fa), jnp.asarray(vb),
                                        jnp.asarray(fb), jnp.asarray(disps),
                                        jnp.asarray(direction)))
    got = T.collision_curve(va, fa, vb, fb, disps, direction)
    assert want.max() > 0 and want.min() == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel_size", [3, 5, 9])
def test_filter_candidate_indices_equal(kernel_size):
    rng = np.random.default_rng(kernel_size)
    curves = [rng.integers(0, 5, size=13) for _ in range(20)]
    curves += [np.array([0, 0, 3, 1, 0, 2, 4, 4, 0, 0, 1]), np.zeros(9), np.arange(9)[::-1]]
    for c in curves:
        np.testing.assert_array_equal(T.filter_candidate_indices(c, kernel_size),
                                      J.filter_candidate_indices(c, kernel_size))
