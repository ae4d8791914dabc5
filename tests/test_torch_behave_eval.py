"""The BEHAVE toolkit and the ground-truth evaluation path of the port,
against ``coma_tpu.pipelines.behave_eval`` on the same seeded inputs.

Tolerances: the frame prep within 1e-6 (the fit's rotation is float32 in
both, as ``coma_tpu`` computes it without JAX's x64 mode; the products with
it float64); the ground-truth ComA state built by
``pipelines/extract.aggregate_samples_streaming`` through K1's plain
version within rtol 2e-5 / atol 1e-6; SIM/MAE and ``cli/evaluate``'s JSON
within 1e-6; the calibration's numpy and scipy math within 1e-9. The reader
surface mirrors ``tests/test_behave_eval.py``; colour frames and masks are
read from PNG and from JPEG (BEHAVE's format) equal to ``coma_tpu``'s PIL.
"""
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from coma_tpu.affordance.contact import contact_update
from coma_tpu.affordance.io import save_coma_state as j_save_state
from coma_tpu.affordance.state import init_coma_state as j_init_state
from coma_tpu.cli import evaluate as j_cli_eval
from coma_tpu.pipelines import behave_eval as J
from coma_tpu.pipelines.extract import aggregate_samples_streaming as j_aggregate
from coma_tpu_torch.affordance.io import coma_state_to_dict, load_coma_state
from coma_tpu_torch.affordance.state import init_coma_state as t_init_state
from coma_tpu_torch.cli import evaluate as t_cli_eval
from coma_tpu_torch.config.hyperparams import get_hyperparams
from coma_tpu_torch.pipelines import behave_eval as T
from coma_tpu_torch.pipelines.extract import aggregate_samples_streaming as t_aggregate
from coma_tpu_torch.utils.ply import write_ply_pointcloud
from tests.test_geometry import CUBE_F, CUBE_V

CALIB_JSON = {
    "color": dict(fx=900.0, fy=900.0, cx=1024.0, cy=768.0, width=2048,
                  height=1536, opencv=[0, 0, 0, 0, 0.1, -0.05, 0, 0, 0, 0, 0, 0, 0]),
    "depth": dict(fx=500.0, fy=500.0, cx=256.0, cy=256.0, width=512,
                  height=512, opencv=[0] * 12),
    "depth_to_color": dict(rotation=list(np.eye(3).ravel()), translation=[0, 0, 0]),
    "color_to_depth": dict(rotation=list(np.eye(3).ravel()), translation=[0, 0, 0]),
}


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def write_frames(root, rng, n_frames, n_human=40, n_obj=24):
    """A BEHAVE-shaped set of frames: a posed human mesh pickle and the
    object's canonicalisation pickles per frame; returns the metadata and
    per-frame paths."""
    hv0 = rng.normal(size=(n_human, 3)) * 0.3
    hf = rng.integers(0, n_human, size=(2 * n_human, 3))
    human_meta = dict(downsample_indices=sorted(rng.choice(n_human, 16, replace=False)), N=16)
    obj_v = rng.normal(size=(n_obj, 3)) * 0.2
    obj_meta = dict(
        obj_vertices_original=obj_v, obj_faces_original=rng.integers(0, n_obj, size=(30, 3)),
        obj_vertex_normals_original=rng.normal(size=(n_obj, 3)),
        downsample_indices=list(range(0, n_obj, 2)), N=n_obj // 2, N_raw=20,
        downsampled_pcd_points_raw=rng.normal(size=(20, 3)) * 0.2,
        downsampled_pcd_normal_raw=unit(rng.normal(size=(20, 3))),
    )
    frames = []
    for i in range(n_frames):
        d = root / f"t{i:04d}.000"
        d.mkdir()
        with open(d / "person.pickle", "wb") as fh:
            pickle.dump(dict(verts=hv0 + rng.normal(size=3) * 0.05, faces=hf), fh)
        with open(d / "center.pickle", "wb") as fh:
            pickle.dump(dict(obj_lowres_center=rng.normal(size=3) * 0.1), fh)
        with open(d / "r2n.pickle", "wb") as fh:
            pickle.dump(dict(R_raw2normal=random_rotation(rng),
                             t_raw2normal=rng.normal(size=3) * 0.1), fh)
        with open(d / "fit.pickle", "wb") as fh:
            pickle.dump(dict(angle=rng.normal(size=3), trans=rng.normal(size=3) * 0.2), fh)
        frames.append(dict(human=str(d / "person.pickle"), center=str(d / "center.pickle"),
                           r2n=str(d / "r2n.pickle"), fit=str(d / "fit.pickle")))
    return human_meta, obj_meta, frames


def prep(module, frame, human_meta, obj_meta, raw=True):
    return module.prepare_affordance_extraction_inputs_for_behave(
        human_mesh_pth=frame["human"], human_mesh_pth_type="pickle",
        human_downsample_metadata=human_meta, object_downsample_metadata=obj_meta,
        human_use_downsample_pcd_raw=False, object_use_downsample_pcd_raw=raw,
        lowres_center_pth=frame["center"], raw2normal_pth=frame["r2n"],
        obj_param_pth=frame["fit"], eps=1e-10,
    )


@pytest.mark.parametrize("raw", [True, False])
def test_gt_prep_matches(tmp_path, raw):
    human_meta, obj_meta, frames = write_frames(tmp_path, np.random.default_rng(0), 3)
    for frame in frames:
        want = prep(J, frame, human_meta, obj_meta, raw)
        got = prep(T, frame, human_meta, obj_meta, raw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_gt_prep_rotation_is_float32(tmp_path):
    """The fit's rotation is the float32 Rodrigues matrix: a float64 one
    would move the posed points by more than float32's rounding."""
    rng = np.random.default_rng(1)
    human_meta, obj_meta, frames = write_frames(tmp_path, rng, 1)
    got = prep(T, frames[0], human_meta, obj_meta)
    from coma_tpu_torch.geometry.transforms import rodrigues

    fit = pickle.load(open(frames[0]["fit"], "rb"))
    r2n = pickle.load(open(frames[0]["r2n"], "rb"))
    center = pickle.load(open(frames[0]["center"], "rb"))["obj_lowres_center"]
    v = (np.asarray(obj_meta["downsampled_pcd_points_raw"]) - r2n["t_raw2normal"]) \
        @ r2n["R_raw2normal"] - center
    R32 = rodrigues(torch.tensor(np.float32(fit["angle"][None]))).numpy()[0]
    want32 = (v @ R32.T + fit["trans"]).astype(np.float32)
    np.testing.assert_array_equal(got["obj_verts"], want32)


def test_gt_prep_obj_mesh_and_cube_case(tmp_path, rng):
    """``tests/test_behave_eval.py``'s cube case, with the human as an OBJ."""
    from coma_tpu_torch.geometry.mesh import save_obj

    save_obj(str(tmp_path / "human.obj"), CUBE_V * 0.5 + [1.0, 0.0, 0.0], CUBE_F)
    human_meta = dict(downsample_indices=list(range(8)), N=8)
    obj_meta = dict(
        obj_vertices_original=CUBE_V, obj_faces_original=CUBE_F,
        obj_vertex_normals_original=rng.normal(size=(8, 3)),
        downsample_indices=list(range(8)), N=8, N_raw=8,
        downsampled_pcd_points_raw=CUBE_V.copy(),
        downsampled_pcd_normal_raw=rng.normal(size=(8, 3)),
    )
    pickle.dump(dict(obj_lowres_center=np.array([0.5, 0.5, 0.5])),
                open(tmp_path / "center.pickle", "wb"))
    pickle.dump(dict(R_raw2normal=np.eye(3), t_raw2normal=np.zeros(3)),
                open(tmp_path / "r2n.pickle", "wb"))
    pickle.dump(dict(angle=np.array([0.0, 0.0, np.pi / 2]), trans=np.array([1.0, 2.0, 3.0])),
                open(tmp_path / "fit.pickle", "wb"))
    kw = dict(human_mesh_pth=str(tmp_path / "human.obj"), human_mesh_pth_type="obj",
              human_downsample_metadata=human_meta, object_downsample_metadata=obj_meta,
              human_use_downsample_pcd_raw=False, object_use_downsample_pcd_raw=True,
              lowres_center_pth=str(tmp_path / "center.pickle"),
              raw2normal_pth=str(tmp_path / "r2n.pickle"),
              obj_param_pth=str(tmp_path / "fit.pickle"), eps=1e-8)
    got = T.prepare_affordance_extraction_inputs_for_behave(**kw)
    want = J.prepare_affordance_extraction_inputs_for_behave(**kw)
    np.testing.assert_allclose(got["obj_verts"][0], [1.5, 1.5, 2.5], atol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def quant_state(init, human_meta, obj_meta, **device):
    hp = get_hyperparams("quant:full")
    return init(human_meta["N"], obj_meta["N_raw"], hp["normal_res"], hp["spatial_grid_size"],
                hp["spatial_grid_thres"], hp["normal_gaussian_sigma"], hp["principle_vec"],
                hp["sub_principle_vec"], hp["eps"], **device)


def test_ground_truth_state_matches(tmp_path):
    """Frames through the prep into a ComA state at quant:full's settings
    (N = 250, σ 0.2): the port's streaming aggregation (K1's plain version
    on the CPU, slabs of 4 over 10 frames) against ``coma_tpu``'s."""
    human_meta, obj_meta, frames = write_frames(tmp_path, np.random.default_rng(2), 10)
    t_state, t_n = t_aggregate(
        quant_state(t_init_state, human_meta, obj_meta, device="cpu"), frames,
        lambda f: prep(T, f, human_meta, obj_meta), occupancy=False, batch_size=4)
    j_state, j_n = j_aggregate(
        [quant_state(j_init_state, human_meta, obj_meta)], frames,
        lambda f: prep(J, f, human_meta, obj_meta), occupancy=False, batch_size=4)
    assert t_n == j_n == 10
    got = coma_state_to_dict(t_state)
    from coma_tpu.affordance.io import coma_state_to_dict as j_to_dict

    want = j_to_dict(j_state)
    for k in ("canon_normal_grid", "prob_grid_canon_human_wrt_obj",
              "prob_grid_canon_obj_wrt_human", "contact_dist_expectation_grid_nom",
              "contact_dist_expectation_grid_denom", "significant_contact_count"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-5, atol=1e-6, err_msg=k)
    assert float(got["used_count"]) == float(want["used_count"]) == 10
    assert np.asarray(want["prob_grid_canon_human_wrt_obj"]).max() > 0


def random_states(seed):
    r = np.random.default_rng(seed)
    args = [r.normal(size=(8, 3)) * 0.1, unit(r.normal(size=(8, 3))),
            r.normal(size=(6, 3)) * 0.1, unit(r.normal(size=(6, 3)))]
    j = contact_update(j_init_state(8, 6, 16, 0.07, 0.5),
                       *(jnp.asarray(a, jnp.float32) for a in args))
    from coma_tpu_torch.affordance.contact import contact_update as t_update

    t = t_update(t_init_state(8, 6, 16, 0.07, 0.5, device="cpu"),
                 *(torch.as_tensor(np.float32(a)) for a in args))
    return j, t


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_evaluate_against_gt_matches(ratio):
    j0, t0 = random_states(0)
    j1, t1 = random_states(1)
    for (ja, jb), (ta, tb) in (((j0, j0), (t0, t0)), ((j0, j1), (t0, t1))):
        want = J.evaluate_against_gt(ja, jb, significant_contact_ratio=ratio)
        got = T.evaluate_against_gt(ta, tb, significant_contact_ratio=ratio)
        assert got.keys() == want.keys()
        for key in want:
            for m in ("sim", "mae"):
                np.testing.assert_allclose(got[key][m], want[key][m], rtol=0, atol=1e-6)
    same = T.evaluate_against_gt(t0, t0)
    assert abs(same["aggr_human_contact_metrics"]["sim"] - 1.0) < 1e-5
    assert T.evaluate_against_gt(t0, t1)["aggr_object_contact_metrics"]["sim"] < 1.0


def test_evaluate_cli_matches(tmp_path):
    j0, _ = random_states(0)
    j1, _ = random_states(1)
    pred, gt = str(tmp_path / "pred.pickle"), str(tmp_path / "gt.pickle")
    j_save_state(j0, pred)
    j_save_state(j1, gt)
    j_cli_eval.main(["--pred_coma", pred, "--gt_coma", gt, "--out_json",
                     str(tmp_path / "j.json")])
    t_cli_eval.main(["--pred_coma", pred, "--gt_coma", gt, "--out_json",
                     str(tmp_path / "t.json"), "--device", "cpu"])
    want = json.load(open(tmp_path / "j.json"))
    got = json.load(open(tmp_path / "t.json"))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys()
        for m in want[key]:
            np.testing.assert_allclose(got[key][m], want[key][m], rtol=0, atol=1e-6)
    state = load_coma_state(pred, device="cpu")
    assert state.used_count.device.type == "cpu"


def test_evaluate_cli_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    j0, _ = random_states(0)
    pred = str(tmp_path / "pred.pickle")
    j_save_state(j0, pred)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli_eval.main(["--pred_coma", pred, "--gt_coma", pred])


def test_kinect_projection_and_dmap2pc_match():
    j, t = J.KinectCalib.from_json(CALIB_JSON), T.KinectCalib.from_json(CALIB_JSON)
    pts = np.random.default_rng(3).normal(size=(20, 3)) * 0.4 + [0, 0, 2.0]
    np.testing.assert_allclose(t.project_points(pts), j.project_points(pts), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.project_points(np.array([[0.0, 0.0, 2.0]]))[0],
                               [1024.0, 768.0], atol=1e-6)
    table = np.random.default_rng(4).normal(size=(4, 4, 2))
    j.pc_table = t.pc_table = table
    depth = np.full((4, 4), 1000, np.uint16)
    depth[0, 0] = 0
    got, mask = t.dmap2pc(depth, return_mask=True)
    want, want_mask = j.dmap2pc(depth, return_mask=True)
    assert got.shape == (15, 3)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_kinect_calib_depth_color_machinery_matches(rng):
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    kw = dict(calibration_matrix=K, dist_coeffs=np.zeros(4), image_size=(64, 64),
              depth_matrix=K, depth2color_R=np.eye(3), depth2color_t=np.zeros(3),
              pc_table=None)
    j, t = J.KinectCalib(**kw), T.KinectCalib(**kw)
    pts = np.concatenate([rng.uniform(-0.2, 0.2, size=(12, 2)), np.full((12, 1), 2.0)], -1)
    far = np.vstack([pts, [[5.0, 5.0, 1.0]]])
    for a, b in zip(t.pc2color_valid(far), j.pc2color_valid(far)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    depth = rng.uniform(1, 9, size=(6, 6))
    depth[rng.uniform(size=(6, 6)) < 0.3] = 0.0
    np.testing.assert_allclose(t.interpolate_depth(depth.copy()),
                               j.interpolate_depth(depth.copy()), atol=1e-12)
    np.testing.assert_allclose(t.pc2dmap(pts), j.pc2dmap(pts), atol=1e-12)
    color = rng.uniform(0, 255, size=(64, 64, 3))
    np.testing.assert_allclose(t.get_pc_colors(pts, color), j.get_pc_colors(pts, color),
                               atol=1e-9)
    np.testing.assert_allclose(t.color_to_pc(t.pc2color(pts), pts),
                               j.color_to_pc(j.pc2color(pts), pts), atol=1e-9)
    image = (color).astype(np.uint8)
    depth_mm = np.full((64, 64), 1500, np.uint16)
    t.pc_table = j.pc_table = rng.normal(size=(64, 64, 2))
    for a, b in zip(t.dmap2colorpc(image, depth_mm), j.dmap2colorpc(image, depth_mm)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def write_sequence(tmp_path, rng, color_ext):
    seq = tmp_path / "Date03_Sub04_chairwood"
    seq.mkdir()
    json.dump(dict(cat="chairwood", gender="male", kinects=[0, 1], beta=[0.0] * 10,
                   config="calibs/config", empty=None, intrinsic="calibs/intrinsics"),
              open(seq / "info.json", "w"))
    for name in ("t0010.000", "t0002.000", "t0002.001"):
        f = seq / name
        f.mkdir()
        for kid in range(2):
            Image.fromarray(rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8)).save(
                f / f"k{kid}.color.{color_ext}")
            Image.fromarray(rng.integers(0, 4000, size=(8, 8)).astype(np.uint16)).save(
                f / f"k{kid}.depth.png")
        (f / "person" / "fit02").mkdir(parents=True)
        pickle.dump(dict(pose=np.zeros(72), betas=np.zeros(10), trans=np.ones(3)),
                    open(f / "person" / "fit02" / "person_fit.pkl", "wb"))
        write_ply_pointcloud(str(f / "person" / "person.ply"),
                             rng.normal(size=(5, 3)).astype(np.float32))
        (f / "chair" / "fit01").mkdir(parents=True)
        pickle.dump(dict(angle=np.array([0.1, 0.2, 0.3]), trans=np.zeros(3)),
                    open(f / "chair" / "fit01" / "chair_fit.pkl", "wb"))
    return seq


def test_behave_sequence_reader_matches(tmp_path, rng):
    seq = write_sequence(tmp_path, rng, "png")
    t, j = T.BehaveSequence(str(seq), ext="png"), J.BehaveSequence(str(seq), ext="png")
    assert len(t) == 3 and t.frames == j.frames == ["t0002.000", "t0002.001", "t0010.000"]
    assert t.seq_info.get_obj_name(convert=True) == "chair" and t.kids == [0, 1]
    for idx in range(3):
        for kid in range(2):
            np.testing.assert_array_equal(t.get_color_image(idx, kid), j.get_color_image(idx, kid))
            got, want = t.get_depth_image(idx, kid), j.get_depth_image(idx, kid)
            assert got.dtype == want.dtype == np.uint16
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t.get_objfit_params(0, "fit01")[0], [0.1, 0.2, 0.3])
    pose, betas, tr = t.get_smplfit_params(2, "fit02")
    assert pose.shape == (72,) and np.all(tr == 1.0)
    np.testing.assert_array_equal(t.get_person_pointcloud(1), j.get_person_pointcloud(1))
    assert t.times2indices(["t0010.000", "t0002.000"]) == [2, 0]
    assert t.get_objfit_params(0, "nope") == (None, None)


def test_jpeg_colour_frame_raises_naming_the_file(tmp_path, rng):
    """BEHAVE's JPEG colour frames and person masks read equal to
    ``coma_tpu``'s (PIL), a CMYK frame included; only a JPEG PIL refuses too
    (12-bit samples) raises, naming the file."""
    seq = write_sequence(tmp_path, rng, "jpg")
    yy, xx = np.mgrid[:24, :40]
    for frame in sorted(p for p in seq.iterdir() if p.is_dir()):
        for kid in range(2):
            blob = (yy - rng.uniform(6, 18)) ** 2 + (xx - rng.uniform(10, 30)) ** 2 < 60
            Image.fromarray(np.uint8(blob) * 255).save(frame / f"k{kid}.person_mask.jpg")
    t, j = T.BehaveSequence(str(seq)), J.BehaveSequence(str(seq))
    assert t.ext == j.ext == "jpg"
    for idx in range(3):
        for kid in range(2):
            np.testing.assert_array_equal(t.get_color_image(idx, kid), j.get_color_image(idx, kid))
            for ret_bool in (True, False):
                got = t.get_mask(idx, kid, "person", ret_bool)
                want = j.get_mask(idx, kid, "person", ret_bool)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    for got, want in zip(t.get_person_mask(1), j.get_person_mask(1)):
        np.testing.assert_array_equal(got, want)
    Image.fromarray(rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8)).convert("CMYK").save(
        seq / t.frames[0] / "k1.color.jpg")
    np.testing.assert_array_equal(t.get_color_image(0, 1), j.get_color_image(0, 1))
    data = bytearray((seq / t.frames[0] / "k0.color.jpg").read_bytes())
    data[data.index(b"\xff\xc0") + 4] = 12                    # SOF0 precision 12
    (seq / t.frames[0] / "k1.color.jpg").write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"k1\.color\.jpg.*12-bit"):
        t.get_color_image(0, 1)
    with pytest.raises(OSError):
        j.get_color_image(0, 1)
    assert t.get_depth_image(0, 0).dtype == np.uint16   # depth stays readable
    np.testing.assert_array_equal(t.get_depth_image(0, 0), j.get_depth_image(0, 0))


def test_frame_data_reader_surface_matches(tmp_path, rng):
    """``tests/test_behave_eval.py``'s surface test, masks as PNG, held
    against ``coma_tpu``'s reader (JPEG masks: the test above)."""
    seq = tmp_path / "Date01_Sub01_backpack"
    seq.mkdir()
    json.dump(dict(cat="backpack", gender="male", kinects=[0, 1], beta=[0.0] * 10,
                   config="c", empty=None, intrinsic="i"), open(seq / "info.json", "w"))
    empty = tmp_path / "Date01_empty"
    for t_name, depth_val in (("t0001.000", 2000), ("t0002.000", 2020)):
        f = empty / t_name
        f.mkdir(parents=True)
        for kid in range(2):
            Image.fromarray(np.full((8, 8), depth_val, np.uint16)).save(f / f"k{kid}.depth.png")
    f = seq / "t0003.000"
    f.mkdir()
    for kid in range(2):
        Image.fromarray(np.full((8, 8, 3), 100, np.uint8)).save(f / f"k{kid}.color.png")
        depth = np.full((8, 8), 2000, np.uint16)
        depth[2:4, 2:4] = 1500
        Image.fromarray(depth).save(f / f"k{kid}.depth.png")
    json.dump(dict(pose=list(range(72)), betas=list(range(10))), open(f / "k1.mocap.json", "w"))
    json.dump(dict(body_joints=[10.0, 20.0, 0.9, 30.0, 40.0, 0.2]),
              open(f / "k0.color.json", "w"))
    (f / "person").mkdir()
    json.dump(dict(body_joints3d=[1.0, 2.0, 3.0, 0.8]),
              open(f / "person" / "person_J3d.json", "w"))
    mask = np.zeros((8, 8, 3), np.uint8)
    mask[2:4, 2:4] = (255, 200, 10)
    Image.fromarray(mask).save(f / "k0.person_mask.png")
    Image.fromarray(mask[..., 0]).save(f / "k1.obj_mask.png")   # obj_mask fallback

    t = T.BehaveSequence(str(seq), ext="png", empty=str(empty))
    j = J.BehaveSequence(str(seq), ext="png", empty=str(empty))
    (tc, td), (jc, jd) = t[0], j[0]
    for a, b in zip(tc + td, jc + jd):
        np.testing.assert_array_equal(a, b)
    assert td[0][0, 0] == 0 and td[0][2, 2] == 1500
    assert t.get_timestamps() == j.get_timestamps() == [3.0]
    assert t.get_frame_idx("t9999.000") == -1 and t.cvt_end(99) == 1
    np.testing.assert_array_equal(t.get_mocap_pose(0, kid=1), np.arange(72))
    assert t.get_mocap_pose(0, kid=0) is None
    np.testing.assert_array_equal(t.get_body_kpts(0, kid=0), j.get_body_kpts(0, kid=0))
    np.testing.assert_allclose(t.get_body_j3d(0), [[1, 2, 3, 0.8]])
    for kid, cat in ((0, "person"), (1, "obj")):
        assert t.get_mask_file(0, kid, cat) == j.get_mask_file(0, kid, cat)
        for ret_bool in (True, False):
            np.testing.assert_array_equal(t.get_mask(0, kid, cat, ret_bool),
                                          j.get_mask(0, kid, cat, ret_bool))
    assert t.get_person_mask(0)[1] is None
    assert t.get_pcpath(0, "obj").endswith("backpack/backpack.ply")
    assert not t.pc_exists(0, "obj") and t.get_pc(0, "obj") is None
    calib_kw = dict(calibration_matrix=np.eye(3), dist_coeffs=np.zeros(4), image_size=(8, 8),
                    depth_matrix=np.eye(3), depth2color_R=np.eye(3),
                    depth2color_t=np.zeros(3), pc_table=rng.normal(size=(8, 8, 2)))
    np.testing.assert_allclose(t.get_pointcloud(0, 0, T.KinectCalib(**calib_kw)),
                               j.get_pointcloud(0, 0, J.KinectCalib(**calib_kw)), atol=1e-12)
    bkg = T.sequence_background_depth(str(empty), 0)
    np.testing.assert_array_equal(bkg, J.sequence_background_depth(str(empty), 0))
    np.testing.assert_allclose(bkg, 2010.0)
    d = np.full((8, 8), 2030, np.uint16)
    np.testing.assert_array_equal(T.remove_background_depth(d, bkg, tol=30),
                                  J.remove_background_depth(d, bkg, tol=30))


def test_prepare_inputs_object_mesh_crosscheck(tmp_path, rng):
    """``object_mesh_for_check_pth`` passes on the matching OBJ and raises
    ``coma_tpu``'s assertions on a mismatched one."""
    from coma_tpu_torch.geometry.mesh import save_obj
    from coma_tpu_torch.pipelines.affordance_inputs import prepare_affordance_extraction_inputs

    pickle.dump(dict(verts=CUBE_V * 0.5, faces=CUBE_F), open(tmp_path / "human.pickle", "wb"))
    obj_meta = dict(obj_vertices_original=CUBE_V.astype(np.float64), obj_faces_original=CUBE_F,
                    obj_vertex_normals_original=rng.normal(size=(8, 3)),
                    downsample_indices=list(range(8)), N=8)
    kw = dict(human_mesh_pth=str(tmp_path / "human.pickle"),
              human_downsample_metadata=dict(downsample_indices=list(range(8)), N=8),
              object_downsample_metadata=obj_meta, human_use_downsample_pcd_raw=False,
              object_use_downsample_pcd_raw=False, eps=1e-8)
    save_obj(str(tmp_path / "obj.obj"), CUBE_V, CUBE_F)
    out = prepare_affordance_extraction_inputs(
        **kw, object_mesh_for_check_pth=str(tmp_path / "obj.obj"))
    assert out["obj_verts"].shape == (8, 3)
    save_obj(str(tmp_path / "bad.obj"), CUBE_V + 0.5, CUBE_F)
    with pytest.raises(AssertionError, match="object OBJ does not match the downsample pickle"):
        prepare_affordance_extraction_inputs(
            **kw, object_mesh_for_check_pth=str(tmp_path / "bad.obj"))
    save_obj(str(tmp_path / "flip.obj"), CUBE_V, CUBE_F[:, ::-1])
    with pytest.raises(AssertionError, match="object faces do not match the downsample pickle"):
        prepare_affordance_extraction_inputs(
            **kw, object_mesh_for_check_pth=str(tmp_path / "flip.obj"))
