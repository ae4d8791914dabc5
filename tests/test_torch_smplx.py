"""Port parity of SMPL-X LBS: ``lbs``, ``smplx_forward`` (axis-angle and PCA
hands, ``transl``, ``return_rel_transforms``) and ``star_pose_vertices``
against ``coma_tpu.models.smplx`` on one seeded model fed to both packages,
at rtol 1e-5 / atol 1e-5; and ``from_npz`` on a seeded npz in the official
key layout.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models import smplx as J
from coma_tpu_torch.models import smplx as T

TOL = dict(rtol=1e-5, atol=1e-5)


def pair(num_verts=64, seed=0):
    """coma_tpu's random model, and the port's built from its arrays."""
    jm = J.random_model(num_verts=num_verts, seed=seed)
    arrays = {f: np.asarray(getattr(jm, f)) for f in T.TENSOR_FIELDS}
    return jm, T.SMPLXModel.from_arrays(arrays, jm.parents, jm.faces, device="cpu")


def inputs(rng, B, model, use_pca=False):
    n_hand = model.left_hand_components.shape[0] if use_pca else 45
    return dict(
        betas=rng.normal(size=(B, model.shapedirs.shape[-1])) * 0.5,
        expression=rng.normal(size=(B, model.expr_dirs.shape[-1])) * 0.5,
        global_orient=rng.normal(size=(B, 3)) * 0.3,
        body_pose=rng.normal(size=(B, 63)) * 0.3,
        jaw_pose=rng.normal(size=(B, 3)) * 0.1,
        left_hand_pose=rng.normal(size=(B, n_hand)) * 0.2,
        right_hand_pose=rng.normal(size=(B, n_hand)) * 0.2,
        transl=rng.normal(size=(B, 3)),
    )


def run_both(jm, tm, kwargs, **flags):
    j_out = J.smplx_forward(jm, **{k: jnp.asarray(v, jnp.float32) for k, v in kwargs.items()},
                            **flags)
    t_out = T.smplx_forward(tm, **{k: torch.as_tensor(np.float32(v)) for k, v in kwargs.items()},
                            **flags)
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    return t_out


def test_random_model_matches_coma_tpu():
    jm, tm = pair()
    ported = T.random_model(num_verts=64, seed=0, device="cpu")
    assert ported.parents == jm.parents and ported.faces == jm.faces
    for f in T.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(ported, f).numpy(), np.asarray(getattr(jm, f)))
    assert (tm.num_verts, tm.num_joints) == (64, 55)
    np.testing.assert_array_equal(tm.faces_array, jm.faces_array)


def test_lbs_matches():
    jm, tm = pair(seed=1)
    rng = np.random.default_rng(0)
    betas = rng.normal(size=(3, 6))
    pose = rng.normal(size=(3, 55 * 3)) * 0.4
    shapedirs = np.concatenate([np.asarray(jm.shapedirs), np.asarray(jm.expr_dirs)], -1)
    j_out = J.lbs(jnp.float32(betas), jnp.float32(pose), jm.v_template, jnp.asarray(shapedirs),
                  jm.posedirs, jm.J_regressor, jm.parents, jm.lbs_weights,
                  return_rel_transforms=True)
    t_out = T.lbs(torch.as_tensor(np.float32(betas)), torch.as_tensor(np.float32(pose)),
                  tm.v_template, torch.as_tensor(shapedirs, dtype=torch.float32), tm.posedirs,
                  tm.J_regressor, tm.parents, tm.lbs_weights, return_rel_transforms=True)
    for j, t in zip(j_out, t_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("use_pca", [False, True])
@pytest.mark.parametrize("rel", [False, True])
def test_smplx_forward_matches(use_pca, rel):
    jm, tm = pair(seed=2)
    kwargs = inputs(np.random.default_rng(3), 2, jm, use_pca)
    out = run_both(jm, tm, kwargs, use_pca=use_pca, return_rel_transforms=rel)
    assert out[0].shape == (2, 64, 3) and out[1].shape == (2, 55, 3)


def test_smplx_forward_defaults_and_no_transl():
    jm, tm = pair(seed=4)
    kwargs = inputs(np.random.default_rng(5), 3, jm)
    del kwargs["transl"], kwargs["jaw_pose"], kwargs["expression"]
    run_both(jm, tm, kwargs)
    run_both(jm, tm, {}, batch_size=2)     # every input zero


def test_star_pose_vertices_match():
    jm, tm = pair(seed=6)
    got = T.star_pose_vertices(tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(J.star_pose_vertices(jm)), **TOL)
    assert got.dtype == torch.float32 and got.shape == (64, 3)


def write_official_npz(path, V=40, seed=0, n_shape=20):
    """A seeded npz in the SMPL-X release's key layout (shapedirs (V, 3, S),
    posedirs (V, 3, 486), kintree_table (2, 55), hand means and components,
    faces as uint32)."""
    rng = np.random.default_rng(seed)
    parents = [-1] + [int(rng.integers(0, j)) for j in range(1, 55)]
    weights = rng.uniform(size=(V, 55))
    np.savez(
        path, v_template=rng.normal(size=(V, 3)), shapedirs=rng.normal(size=(V, 3, n_shape)) * 0.1,
        posedirs=rng.normal(size=(V, 3, 486)) * 0.01,
        J_regressor=rng.dirichlet(np.ones(V), size=55),
        weights=weights / weights.sum(-1, keepdims=True),
        kintree_table=np.stack([parents, np.arange(55)]).astype(np.int64),
        hands_meanl=rng.normal(size=45) * 0.1, hands_meanr=rng.normal(size=45) * 0.1,
        hands_componentsl=rng.normal(size=(12, 45)), hands_componentsr=rng.normal(size=(12, 45)),
        f=np.array([[i, i + 1, i + 2] for i in range(V - 2)], dtype=np.uint32),
    )


@pytest.mark.parametrize("n_shape,flat_hand_mean", [(20, False), (400, True)])
def test_from_npz_round_trip(tmp_path, n_shape, flat_hand_mean):
    path = str(tmp_path / "smplx.npz")
    write_official_npz(path, n_shape=n_shape)
    jm = J.SMPLXModel.from_npz(path, flat_hand_mean=flat_hand_mean)
    tm = T.SMPLXModel.from_npz(path, flat_hand_mean=flat_hand_mean, device="cpu")
    assert tm.parents == jm.parents and tm.parents[0] == -1
    np.testing.assert_array_equal(tm.faces_array, jm.faces_array)
    for f in T.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    back = T.SMPLXModel.from_arrays({f: getattr(tm, f).numpy() for f in T.TENSOR_FIELDS},
                                    tm.parents, tm.faces_array, device="cpu")
    assert dataclasses.asdict(back).keys() == dataclasses.asdict(tm).keys()
    for f in T.TENSOR_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tm, f))
    np.testing.assert_allclose(T.star_pose_vertices(tm).numpy(),
                               np.asarray(J.star_pose_vertices(jm)), **TOL)
