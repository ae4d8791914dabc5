"""Stage 2's lifting modules, the port against ``coma_tpu`` on the CPU.

Same seeded numpy inputs on both sides; tolerances:

- cameras (projection, DLT, pixels_to_world, convert_cam2real): rtol 1e-5,
  atol 1e-4 px / 1e-5 world units (float32 products summed in another
  order);
- the rasterizer at 64²: masks equal, through both routes (per-triangle
  patches and dense chunks); z-buffers finite at the same pixels and within
  1e-4 + 1e-5·|z| there (XLA fuses the barycentric arithmetic otherwise);
  the silhouette IoU equal;
- depth init: the same candidate index on geometry whose IoUs differ and
  on a tie, the IoUs equal;
- RANSAC: the same inlier indices, best candidate and count;
- ``optimize_depth_batch`` at B = 3: displacements within 1e-6 after one
  step (Adam's first step is ±lr) and 1e-4 after 200, with the capsule
  backend and with a seeded neural COAP (``torch.func.vmap`` against
  ``jax.vmap``), the final losses within 1e-3 relative (the loss moves
  with the displacement's last digits);
- ``points_inside_mesh`` equal, the intersection ratios equal (integer
  counts), the mesh volume within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.lifting import cameras as JC
from coma_tpu.lifting import depth_init as JD
from coma_tpu.lifting import depth_optimize as JO
from coma_tpu.lifting import metrics as JM
from coma_tpu.lifting import rasterizer as JR
from coma_tpu.lifting import triangulation as JT
from coma_tpu.models import coap as j_coap
from coma_tpu.models import coap_partition as j_part
from coma_tpu.models import smplx as j_smplx
from coma_tpu_torch.lifting import cameras as TC
from coma_tpu_torch.lifting import depth_init as TD
from coma_tpu_torch.lifting import depth_optimize as TO
from coma_tpu_torch.lifting import metrics as TM
from coma_tpu_torch.lifting import rasterizer as TR
from coma_tpu_torch.lifting import triangulation as TT
from coma_tpu_torch.models import coap as t_coap
from coma_tpu_torch.models import coap_partition as t_part
from coma_tpu_torch.models.flax_params import load_flax_params
from tests.test_geometry import CUBE_F, CUBE_V

RES = (64, 64)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def cameras(angle, dist=3.0, scale=2.0, resolution=RES):
    """(coma_tpu camera, port camera) orbiting the origin, looking inward."""
    z = np.array([np.cos(angle), np.sin(angle), 0.2])
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0, 0, 1.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.float32(np.stack([x, y, z], axis=1))
    tr = np.float32(z * dist + np.array([0, 0, 0.5]))
    return (JC.OrthoCamera(R=jnp.asarray(R), t=jnp.asarray(tr), scale=scale,
                           resolution=resolution),
            TC.OrthoCamera(R=t(R), t=t(tr), scale=scale, resolution=resolution))


def random_mesh(rng, n_verts=120, n_faces=200, spread=0.5):
    return (np.float32(rng.normal(size=(n_verts, 3)) * spread),
            rng.integers(0, n_verts, size=(n_faces, 3)))


# --------------------------------------------------------------- cameras ----

def test_cameras_match():
    rng = np.random.default_rng(0)
    (ja, ta), (jb, tb) = cameras(0.3), cameras(1.4, scale=2.5)
    pts = np.float32(rng.normal(size=(30, 3)) * 0.4)
    np.testing.assert_allclose(TC.project_points(ta, t(pts)).numpy(),
                               np.asarray(JC.project_points(ja, jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-4)
    for got, want in zip(TC.dlt_projection(tb), JC.dlt_projection(jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    pa = np.asarray(JC.project_points(ja, jnp.asarray(pts)))[:, :2]
    pb = np.asarray(JC.project_points(jb, jnp.asarray(pts)))[:, :2]
    got = TC.triangulate_pair(ta, tb, t(pa), t(pb)).numpy()
    np.testing.assert_allclose(got, np.asarray(JC.triangulate_pair(ja, jb, jnp.asarray(pa),
                                                                   jnp.asarray(pb))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pts, atol=1e-4)
    np.testing.assert_allclose(float(TC.reprojection_mse(ta, t(pts), t(pa) + 1.0)),
                               float(JC.reprojection_mse(ja, jnp.asarray(pts),
                                                         jnp.asarray(pa) + 1.0)), rtol=1e-4)
    px = np.float32(rng.uniform(0, 64, size=(10, 3)))
    np.testing.assert_allclose(TC.pixels_to_world(t(px), ta).numpy(),
                               np.asarray(JC.pixels_to_world(jnp.asarray(px), ja)),
                               rtol=1e-5, atol=1e-5)
    verts = np.float32(rng.normal(size=(2, 15, 3)) * 0.3)
    transl = np.float32(rng.normal(size=(2, 3)) * 0.1 + [0, 0, 8])
    args = ((5000.0, 5100.0), (40.0, 30.0), 9.0)
    np.testing.assert_allclose(
        TC.convert_cam2real(t(verts), t(transl), ta, *args).numpy(),
        np.asarray(JC.convert_cam2real(jnp.asarray(verts), jnp.asarray(transl), ja, *args)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ rasterizer ----

@pytest.mark.parametrize("window", [8, 0])
@pytest.mark.parametrize("seed,n_verts,spread", [(0, 120, 0.5), (1, 2000, 0.6)])
def test_rasterizer_matches(window, seed, n_verts, spread):
    """``window`` 0 sends every triangle through the dense chunks; the 2000-
    vertex mesh has pixel-sized triangles, which go through the patches."""
    rng = np.random.default_rng(seed)
    verts, faces = random_mesh(rng, n_verts, 3 * n_verts // 2, spread)
    if n_verts > 1000:   # small triangles: the third corner near the first
        faces = np.stack([faces[:, 0], faces[:, 1], faces[:, 0]], 1)
        verts = np.concatenate([verts, verts + np.float32(rng.normal(size=verts.shape) * 0.02)])
        faces[:, 2] += n_verts
    jc, tc = cameras(0.7)
    tri = np.asarray(JC.project_points(jc, jnp.asarray(verts)))[faces]
    want_mask = np.asarray(JR.rasterize_silhouette(jnp.asarray(tri[..., :2]), 64, 64))
    got_mask = TR.rasterize_silhouette(t(tri[..., :2]), 64, 64, window=window).numpy()
    assert want_mask.sum() > 50
    np.testing.assert_array_equal(got_mask, want_mask)
    want_z = np.asarray(JR.rasterize_depth(jnp.asarray(tri), 64, 64))
    got_z = TR.rasterize_depth(t(tri), 64, 64, window=window).numpy()
    np.testing.assert_array_equal(np.isfinite(got_z), np.isfinite(want_z))
    fin = np.isfinite(want_z)
    np.testing.assert_allclose(got_z[fin], want_z[fin], rtol=1e-5, atol=1e-4)

    occ_v, occ_f = np.float32(CUBE_V * 0.6 - 0.3), CUBE_F
    cand = verts[None] + np.float32([[[0.0, 0, 0]], [[0.3, 0.1, 0]], [[-0.5, 0, 0.2]]])
    want = np.asarray(JR.render_silhouettes_batch(
        jc, jnp.asarray(cand), jnp.asarray(faces), occluder_verts=jnp.asarray(occ_v),
        occluder_faces=jnp.asarray(occ_f)))
    got = TR.render_silhouettes_batch(tc, t(cand), torch.as_tensor(faces),
                                      occluder_verts=t(occ_v),
                                      occluder_faces=torch.as_tensor(occ_f)).numpy()
    np.testing.assert_array_equal(got, want)
    one = TR.render_silhouette(tc, t(cand[1]), torch.as_tensor(faces)).numpy()
    np.testing.assert_array_equal(one, np.asarray(JR.render_silhouette(
        jc, jnp.asarray(cand[1]), jnp.asarray(faces))))
    for a, b in ((got[0], got[1]), (got[1], got[2]), (got[0], got[0])):
        assert float(TR.silhouette_iou(t(a), t(b))) == float(JR.silhouette_iou(
            jnp.asarray(a), jnp.asarray(b)))


def test_rasterizer_flip_and_degenerate():
    """flip_y off, a zero-area triangle and a triangle off the image."""
    tri = np.float32([[[10, 10], [40, 12], [20, 50]], [[5, 5], [5, 5], [9, 9]],
                      [[70, 70], [90, 70], [80, 95]], [[30.5, 1], [31.5, 1], [31, 3.5]]])
    for flip in (True, False):
        want = np.asarray(JR.rasterize_silhouette(jnp.asarray(tri), 64, 64, flip_y=flip))
        got = TR.rasterize_silhouette(t(tri), 64, 64, flip_y=flip).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ depth init ----

def depth_scene(tie: bool):
    """A thin occluder slanted 45° across a cube's silhouette, so each
    candidate depth hides another share of it (seven distinct IoUs), or a
    cube occluder in front of the upper half, behind which every candidate
    gives the same IoU (a tie at the maximum)."""
    jc, tc = cameras(0.0, scale=4.0)
    direction = np.asarray(jc.front) / np.linalg.norm(np.asarray(jc.front))
    if tie:
        occ = np.float32(CUBE_V * 0.5 - 0.25 - 0.9 * direction[None] + [0.0, 0.0, 0.3])
    else:
        c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
        slab = (CUBE_V - 0.5) * np.array([0.05, 2.0, 0.6]) @ np.array(
            [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]).T
        occ = np.float32(slab - 0.5 * direction[None] + [0.0, 0.0, 0.3])
    true = np.float32(CUBE_V - 0.5)
    gt = np.asarray(JR.render_silhouette(jc, jnp.asarray(true), jnp.asarray(CUBE_F),
                                         occluder_verts=jnp.asarray(occ),
                                         occluder_faces=jnp.asarray(CUBE_F)))
    start = np.float32(true - 0.6 * direction[None])
    disp = np.float32(np.arange(-3, 4) * 0.3 + 0.6 if tie else np.arange(-3, 4) * 0.15 + 0.45)
    return jc, tc, np.float32(direction), occ, start, gt, disp


@pytest.mark.parametrize("tie", [False, True])
def test_depth_init_matches(tie):
    jc, tc, direction, occ, start, gt, disp = depth_scene(tie)
    want = JD.initialize_depth_for_sample(
        jc, jnp.asarray(start), jnp.asarray(CUBE_F), jnp.asarray(gt), jnp.asarray(disp),
        occluder_verts=jnp.asarray(occ), occluder_faces=jnp.asarray(CUBE_F),
        direction=jnp.asarray(direction))
    got = TD.initialize_depth_for_sample(
        tc, t(start), torch.as_tensor(CUBE_F), torch.as_tensor(gt), t(disp),
        occluder_verts=t(occ), occluder_faces=torch.as_tensor(CUBE_F), direction=t(direction))
    ious = np.asarray(want["ious"])
    assert (np.sum(ious == ious.max()) > 1) == tie
    assert tie or len(np.unique(ious)) == len(ious)
    np.testing.assert_array_equal(got["ious"].numpy(), ious)
    assert int(got["best_index"]) == int(want["best_index"])
    np.testing.assert_allclose(got["best_verts"].numpy(), np.asarray(want["best_verts"]),
                               atol=1e-6)
    # the helpers around it
    jv, tv = jnp.asarray(start), t(start)
    np.testing.assert_allclose(float(TD.compute_directional_size(tv, t(direction))),
                               float(JD.compute_directional_size(jv, jnp.asarray(direction))),
                               rtol=1e-6)
    for g, w in zip(TD.compute_nearest_point(t(occ), tv[0], t(direction)),
                    JD.compute_nearest_point(jnp.asarray(occ), jv[0], jnp.asarray(direction))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(TD.candidate_displacements(torch.tensor(0.4), 3, 0.25).numpy(),
                               np.asarray(JD.candidate_displacements(jnp.float32(0.4), 3, 0.25)),
                               atol=1e-7)


# ---------------------------------------------------------------- RANSAC ----

def test_ransac_matches():
    rng = np.random.default_rng(3)
    X = np.float32(rng.normal(size=(67, 3)) * 0.3)
    cams = [cameras(a) for a in np.linspace(0.2, 5.9, 9)]
    ref_j, ref_t = cams[0]
    j2d = [np.asarray(JC.project_points(c[0], jnp.asarray(X)))[:, :2] for c in cams]
    noise = [0, 0.5, 1.0, 30.0, 0.2, 80.0, 0.0, 2.0, 0.3]   # two far off, some noisy
    j2d = [np.float32(j + rng.normal(size=j.shape) * s) for j, s in zip(j2d, noise)]
    cand = np.stack(j2d[1:])
    kw = dict(maximum_candidates=6, ransac_threshold=20.0, triangulation_threshold=200.0)
    want = JT.mine_ransac_inliers(ref_j, jnp.asarray(j2d[0]), [c[0] for c in cams[1:]],
                                  jnp.asarray(cand), **kw)
    got = TT.mine_ransac_inliers(ref_t, t(j2d[0]), [c[1] for c in cams[1:]], t(cand), **kw)
    assert 1 < want.num_inliers < len(cams) - 1
    np.testing.assert_array_equal(got.inlier_indices, want.inlier_indices)
    assert (got.best_candidate, got.num_inliers) == (want.best_candidate, want.num_inliers)
    np.testing.assert_allclose(got.triangulations, want.triangulations, atol=1e-4)
    np.testing.assert_allclose(got.mses, want.mses, rtol=1e-4, atol=1e-3)
    assert TT.mine_ransac_inliers(ref_t, t(j2d[0]), [], t(cand[:0]), **kw) is None
    none = dict(kw, triangulation_threshold=1e-12)
    assert TT.mine_ransac_inliers(ref_t, t(j2d[0]), [c[1] for c in cams[1:]], t(cand),
                                  **none) is None


# ------------------------------------------------------ depth optimiser ----

def optimizer_inputs(rng, verts_world=None, joints_world=None):
    """B = 3 samples, each with its own inlier views (the third has two of
    four valid) and its own true displacement."""
    cams = [cameras(a)[0] for a in (0.5, 1.5, 2.5, 3.5)]
    scale, res = cams[0].scale, cams[0].resolution
    front = np.asarray(cams[0].R)[:, 2]
    B = 3
    X = (np.float32(rng.normal(size=(B, 25, 3)) * 0.2) if joints_world is None
         else joints_world)
    V = (np.float32(np.concatenate([X, rng.normal(size=(B, 15, 3)) * 0.2], 1))
         if verts_world is None else verts_world)
    d_true = np.float32([0.5, -0.3, 0.8])
    Rs, ts, j2ds, valids = [], [], [], []
    for b in range(B):
        inl = [dict(R=np.asarray(c.R), t=np.asarray(c.t),
                    joints_2d=np.asarray(JC.project_points(
                        c, jnp.asarray(X[b] + d_true[b] * front)))[:, :2])
               for c in (cams if b < 2 else cams[:2])]
        R, tt, j2d, valid = JO.pad_inliers(inl, 4, res)
        Rs.append(R), ts.append(tt), j2ds.append(j2d), valids.append(valid)
    return dict(joints_world=X, verts_world=np.float32(V),
                cam_front=np.float32(np.tile(front, (B, 1))), inlier_R=np.stack(Rs),
                inlier_t=np.stack(ts), inlier_joints_2d=np.stack(j2ds),
                inlier_valid=np.stack(valids), scale=scale, resolution=res)


def run_both(inputs, steps, j_fn=None, t_fn=None, aux=None, lr=0.01):
    arrays = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    rest = {k: v for k, v in inputs.items() if k not in arrays}
    want = JO.optimize_depth_batch(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **rest, collision_fn=j_fn,
        collision_aux=None if aux is None else {k: jnp.asarray(v) for k, v in aux.items()},
        num_epochs=steps, lr=lr)
    got = TO.optimize_depth_batch(
        **{k: t(v) for k, v in arrays.items()}, **rest, collision_fn=t_fn,
        collision_aux=None if aux is None else {k: t(v) for k, v in aux.items()},
        num_epochs=steps, lr=lr)
    return got, want


@pytest.mark.parametrize("steps,atol", [(1, 1e-6), (200, 1e-4)])
def test_optimize_depth_capsule_matches(steps, atol):
    rng = np.random.default_rng(4)
    inputs = optimizer_inputs(rng)
    V = inputs["verts_world"]
    # points inside each body, just behind it along the way to its true
    # depth: the collision term is live at the start and clears on the way
    behind = -0.1 * np.sign([0.5, -0.3, 0.8])[:, None, None] * inputs["cam_front"][:, None]
    scene = np.stack([j_coap.pad_scene_points(V[b, :6] + behind[b], 16)[0] for b in range(3)])
    valid = np.stack([j_coap.pad_scene_points(V[b, :6], 16)[1] for b in range(3)])
    aux = dict(joints=inputs["joints_world"], base_centroid=V.mean(axis=1),
               scene_points=np.float32(scene), scene_valid=valid)
    got, want = run_both(inputs, steps, j_coap.make_capsule_collision_aux_fn(),
                         torch.func.vmap(t_coap.make_capsule_collision_aux_fn()), aux)
    assert float(np.asarray(want.losses).min()) > 0
    np.testing.assert_allclose(got.displacement.numpy(), np.asarray(want.displacement),
                               atol=atol)
    np.testing.assert_allclose(got.verts.numpy(), np.asarray(want.verts), atol=atol)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-3,
                               atol=1e-5)
    if steps == 200:   # the joint evidence pulls every sample toward its true depth
        assert np.all(got.history[-1].numpy() < got.history[0].numpy())


def test_optimize_depth_without_collision_recovers_truth():
    inputs = optimizer_inputs(np.random.default_rng(5))
    got, want = run_both(inputs, 300, lr=0.05)
    np.testing.assert_allclose(got.displacement.numpy(), np.asarray(want.displacement),
                               atol=1e-4)
    np.testing.assert_allclose(got.displacement.numpy(), [0.5, -0.3, 0.8], atol=0.02)


@pytest.mark.parametrize("steps,atol", [(1, 1e-6), (200, 1e-4)])
def test_optimize_depth_neural_coap_matches(steps, atol):
    rng = np.random.default_rng(6)
    sm = j_smplx.random_model(num_verts=64, num_betas=4, num_expr=2)
    part = j_part.build_partition(np.asarray(sm.lbs_weights), tuple(np.asarray(sm.parents)))
    K = part.num_parts
    cfg = dict(code_dim=8, hidden_dim=8, query_dims=(32, 32), query_skip=(1,), query_out=8,
               decoder_dims=(16, 16), decoder_skip=())
    jm = j_coap.COAPOccupancy(j_coap.COAPConfig(num_parts=K, **cfg))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((K, part.max_part_size, 3)),
                                 jnp.zeros((K, 4, 3)), jnp.ones((K, 4)))
    variables = jax.tree_util.tree_map(
        lambda x: np.float32(np.asarray(x) + rng.normal(size=x.shape) * 0.3), variables)
    tm = load_flax_params(t_coap.COAPOccupancy(t_coap.COAPConfig(num_parts=K, **cfg)),
                          variables)
    tpart = t_part.build_partition(np.asarray(sm.lbs_weights), tuple(np.asarray(sm.parents)))
    verts, joints, rel_tf, rest_j = j_smplx.smplx_forward(
        sm, betas=jnp.asarray(rng.normal(size=(3, 4)) * 0.5, jnp.float32),
        return_rel_transforms=True)
    verts = np.float32(verts) * 0.3
    inputs = optimizer_inputs(rng, verts_world=verts, joints_world=verts[:, :25])
    scene = np.stack([j_coap.pad_scene_points(verts[b, ::4] + 0.01, 24)[0] for b in range(3)])
    valid = np.stack([j_coap.pad_scene_points(verts[b, ::4], 24)[1] for b in range(3)])
    aux = dict(rest_joints=np.float32(rest_j) * 0.3, rel_transforms=np.float32(rel_tf),
               translation=np.zeros((3, 3), np.float32), base_centroid=verts.mean(axis=1),
               scene_points=np.float32(scene), scene_valid=valid)
    j_fn = j_coap.make_coap_collision_aux_fn(jm, variables, part)
    t_fn = torch.func.vmap(t_coap.make_coap_collision_aux_fn(tm, tpart))
    start = np.asarray(jax.vmap(j_fn)(jnp.asarray(verts),
                                      {k: jnp.asarray(v) for k, v in aux.items()}))
    assert (start > 0).all(), start     # the collision term is live in every sample
    got, want = run_both(inputs, steps, j_fn, t_fn, aux)
    np.testing.assert_allclose(got.displacement.numpy(), np.asarray(want.displacement),
                               atol=atol)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-3,
                               atol=1e-5)


def test_pad_inliers_matches():
    rng = np.random.default_rng(7)
    inl = [dict(R=np.eye(3) * 2, t=rng.normal(size=3), joints_2d=rng.normal(size=(25, 2)))
           for _ in range(5)]
    for got, want in zip(TO.pad_inliers(inl, 3, RES), JO.pad_inliers(inl, 3, RES)):
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- metrics ----

def test_points_inside_and_ratios_match():
    rng = np.random.default_rng(8)
    a_v, a_f = np.float32(CUBE_V), CUBE_F
    pts = np.float32(rng.uniform(-0.5, 1.5, size=(3000, 3)))
    want = np.asarray(JM.points_inside_mesh(jnp.asarray(pts), jnp.asarray(a_v),
                                            jnp.asarray(a_f)))
    got = TM.points_inside_mesh(t(pts), t(a_v), torch.as_tensor(a_f)).numpy()
    np.testing.assert_array_equal(got, want)
    # a chunked count equals the one-pass count
    chunked = TM._crossings(t(pts), t(a_v), torch.as_tensor(a_f), chunk=5, point_chunk=777)
    np.testing.assert_array_equal(chunked.numpy(),
                                  TM._crossings(t(pts), t(a_v), torch.as_tensor(a_f)).numpy())
    for shift, res in (((0.6, 0.2, 0.1), 16), ((0.96, 0.0, 0.0), 24), ((2.0, 0, 0), 8)):
        b_v = np.float32(CUBE_V + shift)
        want = float(JM.intersection_volume_ratio(jnp.asarray(a_v), jnp.asarray(a_f),
                                                  jnp.asarray(b_v), jnp.asarray(a_f),
                                                  resolution=res))
        got = float(TM.intersection_volume_ratio(t(a_v), torch.as_tensor(a_f), t(b_v),
                                                 torch.as_tensor(a_f), resolution=res))
        assert got == want, (shift, got, want)
    # the adaptive estimate refines in the gray zone around 0.05: a 0.06
    # overlap reads 1/24 on the coarse grid and 3/48 on the fine one
    b_v = np.float32(CUBE_V + (0.94, 0.0, 0.0))
    args_j = [jnp.asarray(x) for x in (a_v, a_f, b_v, a_f)]
    args_t = [t(a_v), torch.as_tensor(a_f), t(b_v), torch.as_tensor(a_f)]
    want = JM.intersection_volume_ratio_adaptive(*args_j, resolution=24, fine_resolution=48)
    got, refined = TM.intersection_volume_ratio_adaptive(*args_t, resolution=24,
                                                         fine_resolution=48)
    assert refined and got == want
    coarse, refined = TM.intersection_volume_ratio_adaptive(*args_t, resolution=24,
                                                            fine_resolution=48, gray_zone=0.0)
    assert not refined and coarse != got
    np.testing.assert_allclose(float(TM.mesh_volume(t(a_v * 2), torch.as_tensor(a_f))),
                               float(JM.mesh_volume(jnp.asarray(a_v * 2), jnp.asarray(a_f))),
                               rtol=1e-6)


@pytest.mark.parametrize("window", [16, 0])
@pytest.mark.parametrize("kind,n", [("random", 24), ("fine", 48)])
def test_grid_crossings_equal_the_dense_count(window, kind, n):
    """The column-wise count of ``intersection_volume_ratio`` (each triangle
    against the grid columns of its box, or every column) against the
    dense count of every (point, triangle) pair on the grid's points."""
    rng = np.random.default_rng(n)
    if kind == "random":
        verts, faces = random_mesh(rng, 300, 500)
    else:   # 2,000 small triangles: a perturbed fan of thin slivers
        verts = np.float32(rng.normal(size=(1000, 3)) * 0.4)
        faces = np.stack([np.arange(998), np.arange(1, 999), np.arange(2, 1000)], 1)
        faces = np.concatenate([faces, faces[:, ::-1]])
    verts, faces = t(verts), torch.as_tensor(faces)
    lo, hi = verts.amin(0), verts.amax(0)
    g = torch.arange(n, dtype=torch.float32) + 0.5
    axes = [g / n * (hi[k] - lo[k]) + lo[k] for k in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    want = TM._crossings(pts + torch.tensor(TM.NUDGE), verts, faces)
    got = TM._grid_crossings(axes, verts, faces, window=window)
    assert want.sum() > 0
    assert torch.equal(got, want)
