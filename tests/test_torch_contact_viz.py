"""The port's BEHAVE contact visualizer (``visualization/contact_viz.py``)
against ``coma_tpu``'s: part labels, UV spheres and contact spheres equal
(the object surface is sampled from the same numpy stream); the Kinect
projection within 1e-6; the rendered scene within the textured renderer's
tolerance (1e-4 on 99.9% of values, 0.15 at most)."""
import numpy as np
import pytest

from coma_tpu.visualization import contact_viz as J
from coma_tpu_torch.visualization import contact_viz as T
from tests.test_contact_viz import _touching_scene


def test_tables_equal():
    assert T.PART_NAMES == J.PART_NAMES
    np.testing.assert_array_equal(T.PART_COLORS, J.PART_COLORS)
    assert T.SMPL_OBJ_COLOR_LIST == J.SMPL_OBJ_COLOR_LIST


@pytest.mark.parametrize("joints", [55, 22])
def test_part_labels_equal(joints):
    w = np.random.default_rng(joints).uniform(size=(300, joints)).astype(np.float32)
    np.testing.assert_array_equal(T.part_labels_from_lbs(w), J.part_labels_from_lbs(w))


@pytest.mark.parametrize("n_lat, n_lon", [(10, 16), (4, 6)])
def test_uv_sphere_equal(n_lat, n_lon):
    c = np.array([0.3, -1.0, 2.0])
    for a, b in zip(T.uv_sphere(c, 0.07, n_lat, n_lon), J.uv_sphere(c, 0.07, n_lat, n_lon)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thres", [0.12, 0.3])
def test_contact_spheres_equal(thres):
    (hv, hf), (ov, of) = _touching_scene()
    labels = np.random.default_rng(5).integers(0, 14, len(hv)).astype(np.int32)
    got = T.get_contact_spheres(hv, labels, ov, of, thres=thres, n_samples=4000, seed=3)
    want = J.get_contact_spheres(hv, labels, ov, of, thres=thres, n_samples=4000, seed=3)
    assert sorted(got) == sorted(want) and len(got) > 1
    for part in want:
        np.testing.assert_array_equal(got[part][0], want[part][0])
        for a, b in zip(got[part][1], want[part][1]):
            np.testing.assert_array_equal(a, b)
    assert T.get_contact_spheres(hv, labels, ov + 10.0, of) == {}


def test_kinect_projection_matches():
    pts = np.random.default_rng(6).normal(size=(100, 3)) + [0, 0, 3.0]
    for size in ((512, 384), (2048, 1536), (128, 96)):
        got, want = T.KinectCamera(size).project(pts), J.KinectCamera(size).project(pts)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("viz_contact", [True, False])
def test_render_contact_scene_matches(viz_contact):
    (hv, hf), (ov, of) = _touching_scene()
    hv, ov = hv + [0, 0, 2.5], ov + [0, 0, 2.5]
    labels = np.random.default_rng(7).integers(0, 14, len(hv)).astype(np.int32)
    kw = dict(image_size=(128, 96), viz_contact=viz_contact, part_labels=labels, thres=0.12)
    want = J.render_contact_scene([(hv, hf), (ov, of)], **kw)
    got = T.render_contact_scene([(hv, hf), (ov, of)], device="cpu", **kw)
    assert got.shape == (96, 128, 3) and np.isfinite(got).all()
    assert got.min() >= 0 and got.max() <= 1
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 0.15
    covered = (np.abs(got - got[0, 0]).max(-1) > 1e-3).mean()
    assert 0.02 < covered < 0.95


def test_viz_contact_needs_two_meshes():
    (hv, hf), _ = _touching_scene()
    with pytest.raises(ValueError, match="viz_contact"):
        T.render_contact_scene([(hv + [0, 0, 2.5], hf)], viz_contact=True, device="cpu")
