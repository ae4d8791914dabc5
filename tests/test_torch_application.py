"""Keypoints, VPoser, the HOI-reconstruction fit and its CLI, the port against
``coma_tpu`` on the CPU.

One random body (``random_model(32)``), one VPoser decoder (``coma_tpu``'s
``init`` at ``PRNGKey(0)``: zero biases), one ComA and one object feed both
packages; Flax params cross through ``models/flax_params.py``. Modules are
held at rtol 1e-5 / atol 1e-6 (float32), gradients against ``jax.grad`` at
rtol 1e-4, and ``optimize_smpl`` after 1 and 10 steps at the JAX tests'
weights (1e3): vertices within atol 1e-4, each loss within rtol 1e-4.
"""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.affordance.canonicalize import canonicalize_pairwise as j_canon
from coma_tpu.affordance.contact import contact_update
from coma_tpu.affordance.io import coma_state_to_dict, save_coma_state
from coma_tpu.affordance.state import init_coma_state
from coma_tpu.geometry.transforms import normalize_vectors as j_normalize
from coma_tpu.models import coap as j_coap
from coma_tpu.models import keypoints as JK
from coma_tpu.models import smplx as JS
from coma_tpu.models import vposer as JV
from coma_tpu.pipelines import application as JA
from coma_tpu_torch.models import keypoints as TK
from coma_tpu_torch.models import smplx as TS
from coma_tpu_torch.models import vposer as TV
from coma_tpu_torch.models.flax_params import load_flax_params
from coma_tpu_torch.pipelines import application as TA
from tests.test_geometry import CUBE_F, CUBE_V

TOL = dict(rtol=1e-5, atol=1e-6)
# The decoder's three 512-wide products round differently in the two
# frameworks (≈ √512 · 2^-24 ≈ 1.3e-6 relative each, measured up to 3.0e-6 on
# its rotation matrices), and arccos in ``matrot_to_aa`` multiplies that by
# 1/sin θ: its outputs are held at atol 1e-5.
DECODER_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
WEIGHTS = dict(orientation_weight=1e3, contact_weight=1e3, collision_weight=1e2)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the test workers share the host's cores, and
    oversubscribed intra-op threads slow every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------- keypoints ----

@pytest.mark.parametrize("flags", [dict(), dict(use_hands=False),
                                   dict(use_face=True, use_face_contour=True)])
def test_keypoint_maps_gmof_and_landmarks_match(flags):
    np.testing.assert_array_equal(TK.smpl_to_openpose(**flags), JK.smpl_to_openpose(**flags))
    rng = np.random.default_rng(0)
    r = np.float32(rng.normal(size=(7, 2)) * 2)
    np.testing.assert_allclose(TK.gmof(t(r), 0.7).numpy(), np.asarray(JK.gmof(r, 0.7)), **TOL)
    for V in (40, 10475):
        verts = np.float32(rng.normal(size=(2, V, 3)))
        joints = np.float32(rng.normal(size=(2, 55, 3)))
        want = np.asarray(JK.append_vertex_landmarks(jnp.asarray(verts), jnp.asarray(joints)))
        got = TK.append_vertex_landmarks(t(verts), t(joints)).numpy()
        assert got.shape == (2, 76, 3)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ vposer ----

def poses_6d(rng, n=12):
    x = np.float32(rng.normal(size=(n, 6)))
    x[0] = 0.0                                  # both columns degenerate: the fallback
    x[1, [0, 2, 4]] = 0.0                       # the first column degenerate
    x[2] = [1, 0, 0, 1, 0, 0]                   # the identity
    return x


def test_rot6d_decode_and_matrot_to_aa_values_match():
    rng = np.random.default_rng(1)
    x = poses_6d(rng)
    want_R = np.asarray(JV.rot6d_decode(jnp.asarray(x)))
    got_R = TV.rot6d_decode(t(x))
    np.testing.assert_allclose(got_R.numpy(), want_R, **TOL)
    # generic rotations, the identity, near it, and a half turn
    from coma_tpu.geometry.transforms import rodrigues

    aa = np.float32(rng.normal(size=(6, 3)))
    aa[1] = unit(aa[1]) * 1e-4
    aa[2] = unit(aa[2]) * 0.01
    aa[3] = unit(aa[3]) * (np.pi - 1e-3)
    R = np.concatenate([np.asarray(rodrigues(jnp.asarray(aa))), want_R])
    want = np.asarray(JV.matrot_to_aa(jnp.asarray(R)))
    for requires_grad in (False, True):
        got = TV.matrot_to_aa(t(R).requires_grad_(requires_grad)).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


def jax_aa_sum(x):
    return jnp.sum(JV.matrot_to_aa(JV.rot6d_decode(x)))


def port_aa_grad(x):
    x = t(x).requires_grad_(True)
    torch.sum(TV.matrot_to_aa(TV.rot6d_decode(x))).backward()
    return x.grad.numpy()


def test_rot6d_to_aa_gradient_matches_jax_at_generic_poses():
    x = np.float32(np.random.default_rng(2).normal(size=(16, 6)))
    want = np.asarray(jax.jit(jax.grad(jax_aa_sum))(jnp.asarray(x)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(port_aa_grad(x), want, rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("perturbation", [0.0, 1e-4])
def test_matrot_to_aa_gradient_is_finite_at_the_identity(perturbation):
    """``coma_tpu``'s gradient is NaN where the clipped cosine is 1 (its
    arccos' is infinite); the port's Taylor branch keeps it finite there,
    equal to the log map's derivative at the identity, (1/2) d(skew part)."""
    rng = np.random.default_rng(3)
    x = np.float32(np.tile([1, 0, 0, 1, 0, 0], (4, 1)) + rng.normal(size=(4, 6)) * perturbation)
    want = np.asarray(jax.grad(jax_aa_sum)(jnp.asarray(x)))
    assert np.isnan(want).any()
    got = port_aa_grad(x)
    assert np.isfinite(got).all()
    if perturbation == 0.0:
        # x = (a, b, c, d, e, f): columns (a, c, e), (b, d, f); at the identity
        # dR's skew part is 2 (df, -de, dc), so d sum(aa) = dc - de + df
        np.testing.assert_allclose(got[0], [0.0, 0.0, 1.0, 0.0, -1.0, 1.0], atol=1e-6)


def vposer_params(seed=0, biased=False):
    """``coma_tpu``'s decoder params; with ``biased`` every leaf moved by
    seeded noise, so the decoder's output leaves the identity."""
    dec = np_tree(JV.VPoserDecoder().init(jax.random.PRNGKey(seed), jnp.zeros((1, 32))))
    if biased:
        rng = np.random.default_rng(seed)
        dec = jax.tree.map(lambda a: np.float32(a + rng.normal(size=a.shape) * 0.05), dec)
    return dec


def test_vposer_decoder_matches():
    params = vposer_params(biased=True)
    z = np.float32(np.random.default_rng(4).normal(size=(3, 32)))
    port = load_flax_params(TV.VPoserDecoder(), params)
    for output_type in ("aa", "matrot"):
        want = np.asarray(jax.jit(JV.VPoserDecoder().apply, static_argnames="output_type")(
            params, z, output_type=output_type))
        with torch.no_grad():
            got = port(t(z), output_type=output_type).numpy()
        np.testing.assert_allclose(got, want, **DECODER_TOL)


def test_vposer_encoder_and_priors_match():
    rng = np.random.default_rng(5)
    enc = JV.VPoserEncoder()
    variables = np_tree(enc.init(jax.random.PRNGKey(1), jnp.zeros((2, 63))))
    variables = jax.tree.map(lambda a: np.float32(a + rng.uniform(0.1, 0.5, size=a.shape)),
                             variables)
    pose = np.float32(rng.normal(size=(2, 63)) * 0.5)
    want = [np.asarray(a) for a in enc.apply(variables, pose)]
    port = load_flax_params(TV.VPoserEncoder(), variables)
    with torch.no_grad():
        got = [a.numpy() for a in port(t(pose))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(TV.smplify_angle_prior(t(pose)).numpy(),
                               np.asarray(JV.smplify_angle_prior(jnp.asarray(pose))), **TOL)
    np.testing.assert_allclose(float(TV.l2_prior(t(pose))), float(JV.l2_prior(pose)), **TOL)


def torch_snapshot(dec_params, enc_variables=None):
    """A VPoser ``state_dict`` by the reference's keys from Flax params."""
    sd = {}
    for name in ("dec_fc1", "dec_fc2", "dec_out"):
        p = dec_params["params"][name]
        sd[f"bodyprior_{name}.weight"] = torch.from_numpy(np.array(p["kernel"]).T.copy())
        sd[f"bodyprior_{name}.bias"] = torch.from_numpy(np.array(p["bias"]))
    if enc_variables is not None:
        params, stats = enc_variables["params"], enc_variables["batch_stats"]
        for name, p in params.items():
            key = f"bodyprior_{name}"
            if "kernel" in p:
                sd[f"{key}.weight"] = torch.from_numpy(np.array(p["kernel"]).T.copy())
            else:
                sd[f"{key}.weight"] = torch.from_numpy(np.array(p["scale"]))
                sd[f"{key}.running_mean"] = torch.from_numpy(np.array(stats[name]["mean"]))
                sd[f"{key}.running_var"] = torch.from_numpy(np.array(stats[name]["var"]))
                sd[f"{key}.num_batches_tracked"] = torch.tensor(7)
            sd[f"{key}.bias"] = torch.from_numpy(np.array(p["bias"]))
    return sd


def test_vposer_snapshot_loader_matches_coma_tpus():
    dec_params = vposer_params(biased=True)
    enc_vars = np_tree(JV.VPoserEncoder().init(jax.random.PRNGKey(1), jnp.zeros((2, 63))))
    snap = torch_snapshot(dec_params, enc_vars)
    j_enc, j_dec = JV.load_torch_weights({k: v.numpy() for k, v in snap.items()})
    t_enc, t_dec = TV.load_vposer_snapshot({"state_dict": snap}, device="cpu")
    z = np.float32(np.random.default_rng(6).normal(size=(2, 32)))
    with torch.no_grad():
        np.testing.assert_allclose(t_dec(t(z)).numpy(),
                                   np.asarray(JV.VPoserDecoder().apply(j_dec, z)),
                                   **DECODER_TOL)
        pose = np.float32(np.random.default_rng(7).normal(size=(2, 63)))
        for g, w in zip(t_enc(t(pose)), JV.VPoserEncoder().apply(j_enc, pose)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert TV.load_vposer_snapshot(torch_snapshot(dec_params), device="cpu")[0] is None
    with pytest.raises(KeyError, match="missing"):
        TV.load_vposer_snapshot({k: v for k, v in snap.items() if "dec_out" not in k},
                                device="cpu")
    with pytest.raises(KeyError, match="unused"):
        TV.load_vposer_snapshot(dict(snap, stray=torch.zeros(1)), device="cpu")


# ----------------------------------------------------------- application ----

def test_vertex_normals_and_chamfer_match():
    jm = JS.random_model(num_verts=32)
    verts = np.asarray(jm.v_template)
    for v, f in ((verts, jm.faces_array), (np.float32(CUBE_V), np.asarray(CUBE_F))):
        want = np.asarray(JA.vertex_normals_jax(jnp.asarray(v), jnp.asarray(f)))
        got = TA.vertex_normals(t(v), torch.as_tensor(f)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    rng = np.random.default_rng(8)
    a, b = np.float32(rng.normal(size=(10, 3))), np.float32(rng.normal(size=(7, 3)))
    b[:3] = a[:3]                                   # coincident points
    for x, y in ((a, b), (a, a)):
        want_v, want_g = jax.value_and_grad(JA.chamfer_distance)(jnp.asarray(x), jnp.asarray(y))
        xt = t(x).requires_grad_(True)
        got = TA.chamfer_distance(xt, t(y))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want_v), **TOL)
        assert np.isfinite(np.asarray(want_g)).all()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=GRAD_RTOL,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def fit_inputs():
    """The body, the decoder params, the object (six points at posed joints
    of the starting body, so the capsule collision term is active) and the
    ComA aggregated from one sample around it."""
    jm = JS.random_model(num_verts=32)
    arrays = {f: np.asarray(getattr(jm, f)) for f in TS.TENSOR_FIELDS}
    tm = TS.SMPLXModel.from_arrays(arrays, jm.parents, jm.faces, device="cpu")
    rng = np.random.default_rng(9)
    _, joints = jax.jit(lambda tr: JS.smplx_forward(jm, transl=tr))(
        jnp.asarray([[3.0, 1.0, 0.0]]))
    ov = np.float32(np.asarray(joints[0])[[1, 4, 7, 12, 16, 20]] + rng.normal(size=(6, 3)) * 0.02)
    on = np.float32(unit(rng.normal(size=(6, 3))))
    hv = np.float32(ov.mean(0) + rng.normal(size=(32, 3)) * 0.1)
    hn = np.float32(unit(rng.normal(size=(32, 3))))
    state = jax.jit(contact_update)(init_coma_state(32, 6, 16, 0.07, 0.5), jnp.asarray(hv),
                                    jnp.asarray(hn), jnp.asarray(ov), jnp.asarray(on))
    return dict(jm=jm, tm=tm, state=state, coma=np_tree(coma_state_to_dict(state)),
                ov=ov, on=on)


def test_derive_targets_match(fit_inputs):
    for thres in (0.1, 0.3, 0.9):
        want = JA.derive_targets_from_coma(fit_inputs["coma"], 2, thres)
        got = TA.derive_targets_from_coma(fit_inputs["coma"], 2, thres)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(TA.derive_targets_from_coma(fit_inputs["coma"], 0, 0.3)[1]) > 0


def jax_losses(fit_inputs, dec_params, use_collision):
    """``coma_tpu``'s loss of ``application.py:146-169``, rebuilt from its
    functions (``optimize_smpl`` keeps it in a closure)."""
    jm, d, eps = fit_inputs["jm"], fit_inputs["coma"], 1e-6
    gt, sel_h, corr_o = JA.derive_targets_from_coma(d, 0, 0.3)
    ov = jnp.asarray(fit_inputs["ov"])
    ref = j_normalize(jnp.asarray(fit_inputs["on"]), eps)[0:1]
    faces = jnp.asarray(jm.faces_array)

    def losses(prm):
        body_pose = JV.VPoserDecoder().apply(dec_params, prm["pose_embedding"])
        verts, joints = JS.smplx_forward(
            jm, betas=jnp.zeros((1, 4)), global_orient=prm["global_orient"],
            body_pose=body_pose, left_hand_pose=prm["left_hand_pose"],
            right_hand_pose=prm["right_hand_pose"], transl=prm["transl"])
        verts, joints = verts[0], joints[0]
        canon = j_canon(JA.vertex_normals_jax(verts, faces, eps), ref,
                        jnp.asarray(d["principle_vec"]), jnp.asarray(d["sub_principle_vec"]),
                        eps)[:, 0, :]
        align = jnp.sum(jnp.asarray(gt) * canon, axis=-1)
        total = jnp.mean(jnp.nan_to_num(1.0 - (align + 1.0) / 2.0)) * WEIGHTS["orientation_weight"]
        total += JA.chamfer_distance(verts[sel_h], ov[corr_o]) * WEIGHTS["contact_weight"]
        total += JV.l2_prior(prm["pose_embedding"]) * 4.78 ** 2 * 1e1
        total += jnp.sum(JV.smplify_angle_prior(body_pose)) * 1.2
        if use_collision:
            occ = j_coap.capsule_occupancy(ov, joints, jm.parents)
            weights = j_coap.sample_scene_points_bbox(ov, verts)
            total += j_coap.collision_loss(occ * weights) * WEIGHTS["collision_weight"]
        return total

    return losses


@pytest.mark.parametrize("use_collision", [False, True])
def test_loss_and_gradient_at_a_pose_match_jax(fit_inputs, use_collision):
    """The whole loss and its gradient at the fit's start, moved to a
    generic point (every parameter perturbed; a biased decoder, so the body
    pose leaves the identity)."""
    dec_params = vposer_params(biased=True)
    problem = TA.build_problem(fit_inputs["tm"], load_flax_params(TV.VPoserDecoder(), dec_params),
                               fit_inputs["coma"], fit_inputs["ov"], fit_inputs["on"],
                               use_collision=use_collision, **WEIGHTS)
    rng = np.random.default_rng(10)
    start = {k: np.float32(v.detach().numpy() + rng.normal(size=v.shape) * 0.05)
             for k, v in problem.params.items()}
    want_v, want_g = jax.jit(jax.value_and_grad(jax_losses(fit_inputs, dec_params,
                                                           use_collision)))(
        {k: jnp.asarray(v) for k, v in start.items()})
    prm = {k: t(v).requires_grad_(True) for k, v in start.items()}
    total, _ = problem.losses_fn(prm)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_v), rtol=1e-5)
    for k in prm:
        assert np.isfinite(np.asarray(want_g[k])).all()
        scale = np.abs(np.asarray(want_g[k])).max()
        np.testing.assert_allclose(prm[k].grad.numpy(), np.asarray(want_g[k]), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("use_collision", [False, True])
def test_optimize_smpl_matches_coma_tpu(fit_inputs, use_collision):
    dec_params = vposer_params()
    dec = load_flax_params(TV.VPoserDecoder(), dec_params)
    hist = {}
    for steps in (1, 10):
        kw = dict(coma_dict=fit_inputs["coma"], obj_verts=fit_inputs["ov"],
                  obj_normals=fit_inputs["on"], num_iters=steps, use_collision=use_collision,
                  **WEIGHTS)
        want = JA.optimize_smpl(smplx_model=fit_inputs["jm"], vposer_decoder_params=dec_params,
                                **kw)
        got = TA.optimize_smpl(smplx_model=fit_inputs["tm"], vposer_decoder=dec, **kw)
        np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-4)
        assert set(got.losses) == set(want.losses) == {"orientation", "contact", "pprior",
                                                        "angle"}
        for k in want.losses:
            np.testing.assert_allclose(got.losses[k], want.losses[k], rtol=1e-4, err_msg=k)
        # the zero-bias decoder: z = 0 decodes to the identity through rot6d's
        # fallback, whose gradient is zero, so the latent never moves
        assert got.losses["pprior"] == want.losses["pprior"] == 0.0
        assert got.loss_history.shape == (steps,)
        hist[steps] = got
    assert not np.allclose(hist[10].vertices, hist[1].vertices)
    assert hist[10].loss_history[-1] < hist[10].loss_history[0]
    if use_collision:   # the collision term was active at the start
        prm = {k: jnp.asarray(v) for k, v in dict(
            pose_embedding=np.zeros((1, 32)), global_orient=np.zeros((1, 3)),
            transl=[[3.0, 1.0, 0.0]], left_hand_pose=np.zeros((1, 45)),
            right_hand_pose=np.zeros((1, 45))).items()}
        with_c = jax_losses(fit_inputs, dec_params, True)(prm)
        without = jax_losses(fit_inputs, dec_params, False)(prm)
        assert float(with_c) > float(without)
        np.testing.assert_allclose(hist[1].loss_history[0], float(with_c), rtol=1e-5)


# -------------------------------------------------------------------- CLI ----

def write_cli_inputs(tmp_path, fit_inputs):
    from tests.test_torch_smplx import write_official_npz

    npz = str(tmp_path / "smplx.npz")
    write_official_npz(npz, V=32, seed=3)
    coma = str(tmp_path / "coma.pickle")
    save_coma_state(fit_inputs["state"], coma)
    obj = str(tmp_path / "obj.pickle")
    with open(obj, "wb") as fh:
        pickle.dump(dict(downsampled_pcd_points_raw=fit_inputs["ov"],
                         downsampled_pcd_normal_raw=fit_inputs["on"]), fh)
    snap = str(tmp_path / "vposer.pt")
    torch.save(torch_snapshot(vposer_params()), snap)
    return npz, coma, obj, snap


def read_obj_vertices(path):
    with open(path) as fh:
        return np.array([[float(x) for x in l.split()[1:]] for l in fh if l.startswith("v ")])


def test_optimize_cli_matches_coma_tpu(tmp_path, fit_inputs):
    """The port loads a torch VPoser snapshot of the params ``coma_tpu``'s
    CLI makes for its random decoder (``init`` at ``PRNGKey(0)``); both read
    one SMPL-X npz."""
    from coma_tpu.cli import optimize as j_cli
    from coma_tpu_torch.cli import optimize as t_cli

    npz, coma, obj, snap = write_cli_inputs(tmp_path, fit_inputs)
    common = ["--coma_pth", coma, "--obj_downsample_pth", obj, "--smplx_model_path", npz,
              "--num_iters", "10", "--orientation_weight", "1e3", "--contact_weight", "1e3"]
    out = {}
    for name, cli, extra in (("jax", j_cli, []),
                             ("port", t_cli, ["--vposer_snapshot", snap, "--device", "cpu"])):
        obj_out, lj = str(tmp_path / f"{name}.obj"), str(tmp_path / f"{name}.json")
        cli.main(common + extra + ["--save_pth", obj_out, "--losses_json", lj])
        with open(lj) as fh:
            out[name] = (read_obj_vertices(obj_out), json.load(fh))
    assert out["port"][0].shape == (32, 3)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0, atol=1e-4)
    assert out["port"][1].keys() == out["jax"][1].keys()
    for k, v in out["jax"][1].items():
        np.testing.assert_allclose(out["port"][1][k], v, rtol=1e-4, err_msg=k)


def test_vposer_snapshot_runs_in_the_port_not_in_coma_tpu(tmp_path, fit_inputs):
    """``coma_tpu``'s CLI hands the snapshot's (encoder, decoder) pair to the
    fit as decoder params and fails; the port's takes the decoder."""
    from coma_tpu.cli import optimize as j_cli
    from coma_tpu_torch.cli import optimize as t_cli

    _, coma, obj, _ = write_cli_inputs(tmp_path, fit_inputs)
    enc_vars = np_tree(JV.VPoserEncoder().init(jax.random.PRNGKey(1), jnp.zeros((2, 63))))
    full = str(tmp_path / "vposer_full.pt")
    torch.save({"state_dict": torch_snapshot(vposer_params(biased=True), enc_vars)}, full)
    argv = ["--coma_pth", coma, "--obj_downsample_pth", obj, "--vposer_snapshot", full,
            "--num_iters", "2", "--save_pth", str(tmp_path / "o.obj")]
    with pytest.raises(AttributeError, match="tuple"):
        j_cli.main(argv)
    result = t_cli.main(argv + ["--device", "cpu"])
    assert np.isfinite(result.vertices).all() and result.losses["angle"] != 4.8


def test_optimize_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path, fit_inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from coma_tpu_torch.cli import optimize as t_cli

    _, coma, obj, _ = write_cli_inputs(tmp_path, fit_inputs)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--coma_pth", coma, "--obj_downsample_pth", obj])
