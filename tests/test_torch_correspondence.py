"""The port's CPNet helpers (``geometry/correspondence.py``) against
``coma_tpu.geometry.correspondence`` on the same seeded clouds, within 1e-6
(kNN distances, laplacians, keypoint errors) and equal indices; the
geodesic tables, sums of up to a dozen kNN edges each within 1e-6 (the
float32 matrix products round differently), within 2e-6.
``knn_graph`` breaks equal distances toward the lower index, as
``jax.lax.top_k`` does: a lattice, where every point has several
neighbours at one distance, holds it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.geometry import correspondence as J
from coma_tpu_torch.geometry import correspondence as T


def cloud(seed, n=48):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_in, n_out", [(7, 30), (7, 4), (7, 7), (5, 11)])
def test_point_augment_equal(n_in, n_out):
    pc = np.arange(3.0 * n_in).reshape(n_in, 3)
    np.testing.assert_array_equal(T.point_augment(pc, n_out), J.point_augment(pc, n_out))


def test_normalize_point_cloud_matches():
    pc = cloud(0)
    pc[3] = 0.0
    np.testing.assert_allclose(T.normalize_point_cloud(torch.as_tensor(pc)).numpy(),
                               np.asarray(J.normalize_point_cloud(jnp.asarray(pc))), atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_knn_graph_matches(k):
    pc = cloud(1, 64)
    d_j, i_j = jax.device_get(J.knn_graph(jnp.asarray(pc), k))
    d_t, i_t = T.knn_graph(torch.as_tensor(pc), k)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=1e-6)


def test_knn_graph_ties_go_to_the_lower_index():
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pc = np.float32(g)                                     # a 4³ lattice: exact ties
    d_j, i_j = jax.device_get(J.knn_graph(jnp.asarray(pc), 6))
    d_t, i_t = T.knn_graph(torch.as_tensor(pc), 6)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    # the corner (0,0,0) has three neighbours at 1 and three at sqrt(2), in index order
    assert i_t[0].tolist() == [1, 4, 16, 5, 17, 20]
    for row_d, row_i in zip(d_t.numpy(), i_t.numpy()):
        for a in range(5):
            if row_d[a] == row_d[a + 1]:
                assert row_i[a] < row_i[a + 1]


@pytest.mark.parametrize("knn", [4, 6])
def test_pc_to_laplacian_matches(knn):
    pc = cloud(2)
    want = np.asarray(J.pc_to_laplacian(jnp.asarray(pc), knn))
    got = T.pc_to_laplacian(torch.as_tensor(pc), knn).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_normalized_laplacian_isolated_vertex_matches():
    adj = np.zeros((4, 4), np.float32)
    adj[0, 1] = adj[1, 0] = 1.0
    got = T.normalized_laplacian(torch.as_tensor(adj)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.normalized_laplacian(jnp.asarray(adj))))
    assert np.isfinite(got).all()


def test_geodesic_distances_match():
    pc = cloud(3, 40)
    np.testing.assert_allclose(T.geodesic_distances(pc, knn=5),
                               J.geodesic_distances(pc, knn=5), rtol=0, atol=2e-6)
    chain = np.stack([np.arange(10.0), np.zeros(10), np.zeros(10)], axis=1)
    np.testing.assert_allclose(T.geodesic_distances(chain, knn=2),
                               np.abs(np.arange(10.0)[:, None] - np.arange(10.0)), atol=1e-5)


@pytest.mark.parametrize("use_geo", [False, True])
def test_geo_error_matches(use_geo):
    rng = np.random.default_rng(4)
    D, P, F = 5, 40, 8
    pcds = rng.normal(size=(D, P, 3)).astype(np.float32)
    emb = rng.normal(size=(D, P, F)).astype(np.float32)
    kp = np.array([3, -1, 7, 12, 0])
    dm = None
    if use_geo:
        dm = rng.uniform(size=(D, P, P)).astype(np.float32)
        dm = (dm + dm.transpose(0, 2, 1)) / 2
    got, ok = T.geo_error_per_cp(pcds, emb, kp, dm, device="cpu")
    want, want_ok = J.geo_error_per_cp(pcds, emb, kp, dm)
    assert ok is want_ok is True
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert T.geo_error_per_cp(pcds, emb, np.array([-1, 5, -1, -1, -1]), device="cpu") \
        == (0.0, False)


def test_augmentations_bounded_and_seeded():
    pc = torch.as_tensor(cloud(5, 50))
    out = T.jitter_point_cloud(pc, torch.Generator().manual_seed(0), 0.5, 0.02)
    assert float((out - pc).abs().max()) <= 0.02 + 1e-6
    again = T.jitter_point_cloud(pc, torch.Generator().manual_seed(0), 0.5, 0.02)
    assert torch.equal(out, again)
    g = torch.Generator().manual_seed(1)
    rot = T.rotate_point_cloud(pc, g, degree=np.pi / 6)
    np.testing.assert_allclose(rot.norm(dim=1).numpy(), pc.norm(dim=1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(rot[:, 1].numpy(), pc[:, 1].numpy(), atol=1e-6)   # about +Y
    angle = torch.rand((), generator=torch.Generator().manual_seed(1)) * (np.pi / 6)
    c, s = float(torch.cos(angle)), float(torch.sin(angle))
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    np.testing.assert_allclose(rot.numpy(), pc.numpy() @ R, atol=1e-6)
