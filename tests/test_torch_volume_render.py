"""The port's occupancy volume render (``visualization/volume.py``) against
``coma_tpu``'s on the same fields, at 64² and 48 steps (production: 512²,
192 steps): within 1e-5 on every value, with and without the mesh pass;
``num_steps`` rounding up to the slab and the 10% ignore threshold
included. The trilinear sampler (clamped index, then out-of-grid taps
zeroed) within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.visualization import volume as J
from coma_tpu_torch.visualization import volume as T

RES, STEPS, ATOL = 64, 48, 1e-5


def blob_field(R=16, center=None, sigma=2.5):
    c = np.asarray(center if center is not None else [R / 2] * 3)
    ijk = np.mgrid[0:R, 0:R, 0:R].astype(np.float32) + 0.5
    d2 = sum((ijk[a] - c[a]) ** 2 for a in range(3))
    return np.exp(-d2 / (2 * sigma**2)).astype(np.float32)


def render_both(field, **kw):
    want = np.asarray(J.render_occupancy_volume(jnp.asarray(field), **kw))
    got = T.render_occupancy_volume(torch.as_tensor(field), **kw).numpy()
    return got, want


def test_trilinear_matches():
    rng = np.random.default_rng(0)
    field = rng.uniform(size=(5, 6, 7)).astype(np.float32)
    pts = rng.uniform(-2, 9, size=(500, 3)).astype(np.float32)   # many taps off the grid
    want = np.asarray(J._trilinear(jnp.asarray(field), jnp.asarray(pts)))
    got = T._trilinear(torch.as_tensor(field), torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    g = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
    out = T._trilinear(torch.as_tensor(g), torch.tensor([[1.5, 1.5, 1.5], [1.5, 1.5, 2.0],
                                                          [-5.0, 1.0, 1.0]])).numpy()
    np.testing.assert_allclose(out, [13.0, 13.5, 0.0], atol=1e-5)


def test_orbit_axes_match():
    for elev, azim in ((20.0, 35.0), (15.0, 45.0), (30.0, -60.0)):
        for a, b in zip(T._orbit_axes(elev, azim), J._orbit_axes(elev, azim)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["blob", "random", "off_center"])
def test_volume_render_matches(case):
    rng = np.random.default_rng(1)
    field = {"blob": blob_field(),
             "random": rng.uniform(size=(12, 14, 10)).astype(np.float32) ** 3,
             "off_center": blob_field(center=(4, 11, 7))}[case]
    got, want = render_both(field, resolution=RES, num_steps=STEPS)
    assert got.shape == (RES, RES, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got[1, 1] > 0.99).all() and got.min() < 0.9       # white corner, visible volume


def test_num_steps_rounds_up_to_the_slab():
    field = blob_field()
    got, want = render_both(field, resolution=32, num_steps=40)   # -> 48
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        got, T.render_occupancy_volume(torch.as_tensor(field), resolution=32,
                                       num_steps=48).numpy())


def test_ignore_threshold():
    """Values below 10% of the maximum are zeroed: a faint blob vanishes."""
    main = blob_field(center=(8, 8, 8))
    faint = 0.09 * blob_field(center=(3, 3, 3), sigma=1.5)
    got, want = render_both(main + faint, resolution=32, num_steps=32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    alone = T.render_occupancy_volume(torch.as_tensor(np.maximum(main, faint)),
                                      resolution=32, num_steps=32).numpy()
    kept = T.render_occupancy_volume(torch.as_tensor(main), resolution=32,
                                     num_steps=32).numpy()
    np.testing.assert_allclose(alone, kept, atol=ATOL)


def test_volume_render_with_mesh_matches(tmp_path):
    from coma_tpu_torch.visualization.contact_viz import uv_sphere

    verts, faces = uv_sphere(np.array([1.0, -2.0, 0.5]), 4.5, 8, 12)
    field = blob_field()
    want = J.save_occupancy_volume_render(None, field, mesh=(verts, faces), voxel_size=1.0,
                                          resolution=RES, num_steps=STEPS)
    got = T.save_occupancy_volume_render(str(tmp_path / "v.png"), field, mesh=(verts, faces),
                                         voxel_size=1.0, resolution=RES, num_steps=STEPS,
                                         device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    zbuf, _ = T.mesh_pass(verts, faces, field.shape, 1.0, RES, 20.0, 35.0, "cpu")
    assert torch.isfinite(zbuf).float().mean() > 0.05        # the mesh is in view
    from coma_tpu_torch.utils.png import read_png

    np.testing.assert_array_equal(read_png(str(tmp_path / "v.png")),
                                  (got * 255).astype(np.uint8))
