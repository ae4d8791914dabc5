"""COAP partition, occupancy backends and collision terms, the port against
``coma_tpu`` on the CPU.

Flax params from ``init`` (every leaf then moved by seeded noise, so no
bias is zero) cross into the port's modules through
``models/flax_params.py``; both run on the same numpy inputs. Tolerance:
rtol 1e-5, atol 1e-6, float32. The partition tables are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models import coap as J
from coma_tpu.models import coap_partition as JP
from coma_tpu.models import smplx as JS
from coma_tpu_torch.models import coap as T
from coma_tpu_torch.models import coap_partition as TP
from coma_tpu_torch.models.flax_params import load_flax_params

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(code_dim=8, hidden_dim=8, query_dims=(64, 64, 64), query_skip=(2,), query_out=8,
             decoder_dims=(16, 16, 16, 16), decoder_skip=(3,))
# SMPL-X's kinematic tree, 55 joints
SMPLX_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
                 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the test workers share the host's cores, and
    oversubscribed intra-op threads slow every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.float32(np.asarray(a) + rng.normal(size=a.shape) * 0.1),
                        tree)


@pytest.fixture(scope="module")
def body():
    """A random SMPL-X-shaped model posed by a seeded pose: its partition,
    vertices, joints, relative transforms and rest joints."""
    sm = JS.random_model(num_verts=96, num_betas=4, num_expr=2, seed=3)
    rng = np.random.default_rng(7)
    verts, joints, rel, rest = JS.smplx_forward(
        sm, betas=jnp.zeros((1, 4)), body_pose=jnp.asarray(rng.normal(size=(1, 63)) * 0.3,
                                                           jnp.float32),
        return_rel_transforms=True)
    part = JP.build_partition(np.asarray(sm.lbs_weights), tuple(sm.parents))
    return dict(model=sm, part=part, verts=np.asarray(verts[0]), joints=np.asarray(joints[0]),
                rel=np.asarray(rel[0]), rest=np.asarray(rest[0]))


@pytest.mark.parametrize("which", ["random", "smplx"])
def test_partition_tables_equal(which, body):
    rng = np.random.default_rng(0)
    if which == "random":
        weights, parents = np.asarray(body["model"].lbs_weights), tuple(body["model"].parents)
    else:
        weights, parents = rng.dirichlet(np.ones(55) * 0.2, size=300), SMPLX_PARENTS
    np.testing.assert_array_equal(TP.build_part_mapping(parents), JP.build_part_mapping(parents))
    got, want = TP.partition_vertices(weights, parents), JP.partition_vertices(weights, parents)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    got, want = TP.build_partition(weights, parents), JP.build_partition(weights, parents)
    for f in ("vertex_part", "part_joint", "part_vertex_ids", "part_vertex_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.num_parts, got.max_part_size) == (want.num_parts, want.max_part_size)


def test_bone_frames_local_points_and_gate_match(body):
    part, rng = body["part"], np.random.default_rng(1)
    want_f = JP.bone_local_frames(jnp.asarray(body["rel"]), jnp.asarray(body["rest"]),
                                  part.part_joint)
    got_f = TP.bone_local_frames(t(body["rel"]), t(body["rest"]), part.part_joint)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)

    q = np.float32(rng.normal(size=(40, 3)) * 0.8)
    want_q = JP.to_part_local(jnp.asarray(q), want_f)
    got_q = TP.to_part_local(t(q), got_f)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), **TOL)

    pts = np.asarray(want_q)[:, :12] * 1.5          # (K, 12, 3) "part clouds"
    valid = np.float32(rng.uniform(size=pts.shape[:2]) > 0.3)
    want = np.asarray(JP.part_bbox_gate(jnp.asarray(pts), jnp.asarray(valid), want_q))
    got = TP.part_bbox_gate(t(pts), t(valid), got_q).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_capsule_occupancy_collision_and_bbox_mask_match(body):
    rng = np.random.default_rng(2)
    joints, parents = body["joints"], tuple(body["model"].parents)
    pts = np.float32(joints[rng.integers(0, len(joints), 64)] + rng.normal(size=(64, 3)) * 0.08)
    pts[0] = joints[5]                                     # on a bone end: the safe norm
    radii = np.float32(rng.uniform(0.03, 0.12, len(parents)))
    for r in (None, radii):
        want = np.asarray(J.capsule_occupancy(jnp.asarray(pts), jnp.asarray(joints), parents,
                                              None if r is None else jnp.asarray(r)))
        got = T.capsule_occupancy(t(pts), t(joints), parents, None if r is None else t(r))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert want.max() > 0.5 > want.min()
    np.testing.assert_allclose(float(T.collision_loss(got)),
                               float(J.collision_loss(jnp.asarray(want))), **TOL)
    want_m = np.asarray(J.sample_scene_points_bbox(jnp.asarray(pts), jnp.asarray(body["verts"])))
    got_m = T.sample_scene_points_bbox(t(pts), t(body["verts"])).numpy()
    np.testing.assert_array_equal(got_m, want_m)

    # the gradient through the capsule field, on the bone axis included
    def jloss(x):
        return J.collision_loss(J.capsule_occupancy(x, jnp.asarray(joints), parents), 0.3)

    want_g = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(pts)))
    x = t(pts).requires_grad_(True)
    T.collision_loss(T.capsule_occupancy(x, t(joints), parents), 0.3).backward()
    assert np.isfinite(want_g).all()
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-4, atol=1e-5)


def test_resnet_pointnet_matches_and_is_permutation_invariant():
    rng = np.random.default_rng(3)
    pts = np.float32(rng.normal(size=(3, 20, 3)))
    net = J.ResnetPointnet(out_dim=16, hidden_dim=32)
    params = perturbed(jax.jit(net.init)(jax.random.PRNGKey(0), pts), 0)
    want = np.asarray(jax.jit(net.apply)(params, pts))
    port = load_flax_params(T.ResnetPointnet(16, 32), params)
    with torch.no_grad():
        got = port(t(pts)).numpy()
        got_perm = port(t(pts[:, ::-1])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_perm, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims,skip", [((16, 16, 16), (2,)), ((16, 16, 16, 16, 16, 16), (3,)),
                                       ((12, 20), ())])
def test_implicit_net_matches(dims, skip):
    rng = np.random.default_rng(4)
    x = np.float32(rng.normal(size=(2, 9, 7)) * 0.05)
    net = J.ImplicitNet(d_out=5, dims=dims, skip_in=skip)
    params = perturbed(jax.jit(net.init)(jax.random.PRNGKey(1), x), 1)
    want = np.asarray(jax.jit(net.apply)(params, x))
    port = load_flax_params(T.ImplicitNet(7, 5, dims, skip), params)
    with torch.no_grad():
        got = port(t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def coap_pair(K, seed=2, **cfg):
    jcfg = J.COAPConfig(num_parts=K, **cfg)
    jm = J.COAPOccupancy(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((K, 6, 3)),
                              jnp.zeros((K, 5, 3)), jnp.ones((K, 5)))
    params = perturbed(params, seed)
    tm = load_flax_params(T.COAPOccupancy(T.COAPConfig(num_parts=K, **cfg)), params)
    return jm, params, tm


@pytest.mark.parametrize("cfg", [SMALL, {}], ids=["small", "published"])
def test_coap_occupancy_matches(cfg):
    K, rng = 5, np.random.default_rng(5)
    jm, params, tm = coap_pair(K, **cfg)
    parts = np.float32(rng.normal(size=(K, 6, 3)) * 0.1)
    q = np.float32(rng.normal(size=(K, 11, 3)) * 0.1)
    inside = np.float32(rng.uniform(size=(K, 11)) > 0.4)
    want = np.asarray(jax.jit(jm.apply)(params, parts, q, inside))
    with torch.no_grad():
        got = tm(t(parts), t(q), t(inside)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == (11,) and want.max() > 0
    with pytest.raises(ValueError, match="parts"):
        tm(t(parts[:4]), t(q[:4]), t(inside[:4]))


def world_inputs(body, rng):
    q = np.float32(body["verts"][rng.integers(0, 96, 9)] + rng.normal(size=(9, 3)) * 0.05)
    return q, np.float32([0.3, -0.2, 1.1])


def test_coap_occupancy_world_matches(body):
    part, rng = body["part"], np.random.default_rng(6)
    jm, params, tm = coap_pair(part.num_parts, **SMALL)
    q, d = world_inputs(body, rng)
    world = jax.jit(lambda prm, *a: J.coap_occupancy_world(jm, prm, part, *a))
    want = np.asarray(world(params, body["rest"], body["rel"], d, body["verts"] + d, q + d))
    with torch.no_grad():
        got = T.coap_occupancy_world(tm, part, t(body["rest"]), t(body["rel"]), t(d),
                                     t(body["verts"] + d), t(q + d)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert want.max() > 0


@pytest.mark.parametrize("factory", ["capsule_aux", "coap_aux", "coap"])
def test_collision_factories_match(factory, body):
    part, rng = body["part"], np.random.default_rng(8)
    q, d = world_inputs(body, rng)
    verts = body["verts"] + d
    pts, valid = J.pad_scene_points(q, 12)
    got_pts, got_valid = T.pad_scene_points(q, 12)
    np.testing.assert_array_equal(got_pts, pts)
    np.testing.assert_array_equal(got_valid, valid)
    jj = lambda a: jnp.asarray(a)
    if factory == "capsule_aux":
        joints = body["joints"][:25]
        pts, valid = J.pad_scene_points(joints[::2] + d + rng.normal(size=(13, 3)) * 0.03, 16)
        aux = dict(joints=joints, base_centroid=body["verts"].mean(0), scene_points=pts,
                   scene_valid=valid)
        jfn, tfn = J.make_capsule_collision_aux_fn(), T.make_capsule_collision_aux_fn()
    else:
        jm, params, tm = coap_pair(part.num_parts, **SMALL)
        if factory == "coap_aux":
            aux = dict(rest_joints=body["rest"], rel_transforms=body["rel"],
                       translation=np.zeros(3, np.float32),
                       base_centroid=body["verts"].mean(0), scene_points=pts, scene_valid=valid)
            jfn = J.make_coap_collision_aux_fn(jm, params, part, level_set=0.2)
            tfn = T.make_coap_collision_aux_fn(tm, part, level_set=0.2)
        else:
            jfn = J.make_coap_collision_fn(jm, params, part, jj(body["rest"]), jj(body["rel"]),
                                           jj(body["verts"]), jj(pts), level_set=0.2)
            tfn = T.make_coap_collision_fn(tm, part, t(body["rest"]), t(body["rel"]),
                                           t(body["verts"]), t(pts), level_set=0.2)
    if factory == "coap":
        want, got = jfn(jj(verts)), tfn(t(verts))
    else:
        want = jfn(jj(verts), {k: jj(v) for k, v in aux.items()})
        got = tfn(t(verts), {k: t(v) for k, v in aux.items()})
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
