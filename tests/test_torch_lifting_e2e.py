"""Stage 2 end to end, the port's CLIs against ``coma_tpu``'s on one tree.

The tree is ``tests/test_lifting_e2e.py``'s: ``coma_tpu``'s
``render_objects`` renders a unit-cube asset from two views at 64², and
each view's ``human_preds`` hold the exact projection of a small cube
beside it (what a perfect regressor gives) and its ``human_segs`` the
cube's occluded silhouette. Both packages run initialize_depth,
optimize_depth (the capsule backend, ``auto`` without COAP weights) and
compute_metrics on copies of the tree, and the orchestrators run the chain
with ``--no_collision``. Tolerances: the chosen candidate, the IoUs, the
inlier counts, the intersection ratios and the sentinels are equal; world
vertices within 1e-5 after depth init and 1e-4 after 200 Adam steps (the
two frameworks round the projections' sums apart by ~1 ulp of pixel
coordinates, and Adam's steps of ≈ lr·sign(g) carry that little). The
port's ``cli/filter`` then reads the port's ``human_sample`` tree.
``predict_human`` runs on a tree of three 320x240 PNGs (one person, two,
none) with one Hand4Whole (its towers cut to one block per stage, as
``tests/test_torch_hand4whole.py`` cuts them) and one SMPL-X npz given to
both: the same sentinels, faces and SMPL-X keys, pixel-space vertices and
joints within 1e-4 relative / 1e-2 px, parameters within 1e-3 (poses) and
1e-4.
"""
import glob
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.cli import compute_metrics as j_metrics
from coma_tpu.cli import generate_3d_hoi_samples as j_orch
from coma_tpu.cli import initialize_depth as j_init
from coma_tpu.cli import optimize_depth as j_opt
from coma_tpu.cli import predict_human as j_predict
from coma_tpu.cli import render_objects as j_render
from coma_tpu.geometry.mesh import save_obj
from coma_tpu.lifting.cameras import OrthoCamera, project_points
from coma_tpu.lifting.rasterizer import render_silhouette
from coma_tpu_torch.cli import compute_metrics as t_metrics
from coma_tpu_torch.cli import filter as t_filter
from coma_tpu_torch.cli import generate_3d_hoi_samples as t_orch
from coma_tpu_torch.cli import initialize_depth as t_init
from coma_tpu_torch.cli import optimize_depth as t_opt
from coma_tpu_torch.cli import predict_human as t_predict
from coma_tpu_torch.utils.png import write_png
from tests.test_geometry import CUBE_F, CUBE_V
from tests.test_torch_hand4whole import small_towers, small_variables
from tests.test_torch_smplx import write_official_npz

SC, CAT = "Chair", "Lounge Chair / Cafe Chair / Office Chair"
SC_STR, CAT_STR = "Chair", "Lounge Chair : Cafe Chair : Office Chair"
ASSET = "0a5a346c-cc3b-4280-b358-ccd1c4d8a865"
PROMPT = "1 person sits on a chair"
RES = 64
STAGES = ("human_before_opt", "human_after_opt", "human_sample")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def write_tree(root):
    """``tests/test_lifting_e2e.py``'s scene under ``root``."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        save_obj("asset.obj", CUBE_V, CUBE_F)
        j_render.main(["--obj_pth", "asset.obj", "--supercategory", SC, "--category", CAT,
                       "--asset_id", ASSET, "--resolution", str(RES), str(RES),
                       "--default_view_num", "2", "--default_stride_x", "0.5",
                       "--default_stride_y", "0.5"])
        asset_world = CUBE_V @ np.array([[1, 0, 0], [0, 0, 1.0], [0, -1, 0]])
        rng = np.random.default_rng(0)
        human_world = CUBE_V * 0.5 + np.array([1.3, -1.5, 0.1])
        joints_world = rng.uniform(size=(137, 3)) * 0.5 + np.array([1.3, -1.5, 0.1])
        for p in sorted(glob.glob("results/generation/cameras/*/*/*/*.pickle")):
            view_id = p.split("/")[-1].rsplit(".", 1)[0]
            with open(p, "rb") as fh:
                d = pickle.load(fh)
            cam = OrthoCamera(R=jnp.asarray(d["R"], jnp.float32),
                              t=jnp.asarray(d["t"], jnp.float32).reshape(3),
                              scale=float(d["scale"]), resolution=tuple(d["resolution"]))
            verts_px = np.asarray(project_points(cam, jnp.asarray(human_world, jnp.float32)))
            joints_px = np.asarray(project_points(cam, jnp.asarray(joints_world, jnp.float32)))
            pred = dict(verts=verts_px, faces=CUBE_F.astype(np.int64), pelvis=joints_px[0].copy(),
                        smplx_data={}, joints_proj=joints_px[:, :2].copy(),
                        joints_img=joints_px.copy(),
                        convert_data=dict(focals=[5000.0, 5000.0], princpt=[32, 32],
                                          z_mean=10.0))
            rel = f"{SC_STR}/{CAT_STR}/{ASSET}/{view_id}/00000/{PROMPT}"
            os.makedirs(f"results/generation/human_preds/{rel}")
            with open(f"results/generation/human_preds/{rel}/00000.pickle", "wb") as fh:
                pickle.dump(pred, fh)
            mask = np.asarray(render_silhouette(
                cam, jnp.asarray(human_world, jnp.float32), jnp.asarray(CUBE_F),
                occluder_verts=jnp.asarray(asset_world, jnp.float32),
                occluder_faces=jnp.asarray(CUBE_F)))
            ys, xs = np.nonzero(mask)
            seg = dict(pred_masks=mask[None],
                       pred_boxes=np.array([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]],
                                           np.float32),
                       scores=np.array([0.99], np.float32), pred_classes=np.zeros(1, np.int64),
                       image_size=mask.shape)
            os.makedirs(f"results/generation/human_segs/{rel}")
            with open(f"results/generation/human_segs/{rel}/00000.pickle", "wb") as fh:
                pickle.dump(seg, fh)
    finally:
        os.chdir(cwd)
    return human_world


def stage_pickles(root, stage):
    out = {}
    for p in sorted(glob.glob(f"{root}/results/generation/{stage}/*/*/*/*/*/*/*.pickle")):
        with open(p, "rb") as fh:
            out[os.path.relpath(p, root)] = pickle.load(fh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' three stage CLIs, each on its copy of the tree."""
    tmp = tmp_path_factory.mktemp("lifting_e2e_port")
    os.makedirs(tmp / "src")
    human_world = write_tree(str(tmp / "src"))
    for name in ("jax", "port", "jax_orch", "port_orch"):
        shutil.copytree(tmp / "src", tmp / name)
    with pytest.MonkeyPatch.context() as mp:
        for name, init, opt, metrics, dev in (
                ("jax", j_init, j_opt, j_metrics, []),
                ("port", t_init, t_opt, t_metrics, ["--device", "cpu"])):
            mp.chdir(tmp / name)
            init.main(["--asset_obj_pth", "asset.obj", *dev])
            opt.main(["--asset_obj_pth", "asset.obj", "--minimum_inliers", "1", *dev])
            metrics.main(["--asset_obj_pth", "asset.obj", "--voxel_resolution", "24", *dev])
        flags = ["--skip", "segment", "predict", "--asset_obj_pth", "asset.obj",
                 "--no_collision", "--minimum_inliers", "1", "--voxel_resolution", "24"]
        mp.chdir(tmp / "jax_orch")
        j_orch.main(flags)
        mp.chdir(tmp / "port_orch")
        t_orch.main(flags + ["--device", "cpu"])
    return dict(tmp=tmp, human_world=human_world)


def assert_payloads_match(got, want, verts_atol):
    assert sorted(got) == sorted(want) and want
    for rel in want:
        g, w = got[rel], want[rel]
        if isinstance(w, str):
            assert g == w, rel
            continue
        assert sorted(g) == sorted(w), rel
        for key, value in w.items():
            if key in ("verts", "displacement"):
                np.testing.assert_allclose(g[key], np.asarray(value), atol=verts_atol,
                                           err_msg=f"{rel} {key}")
            elif isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype, (rel, key)
                np.testing.assert_array_equal(g[key], value, err_msg=f"{rel} {key}")
            else:
                assert g[key] == value, (rel, key, g[key], value)


@pytest.mark.parametrize("stage,atol", [("human_before_opt", 1e-5), ("human_after_opt", 1e-4),
                                        ("human_sample", 1e-4)])
@pytest.mark.parametrize("run", ["", "_orch"])
def test_stage_pickles_match(runs, stage, atol, run):
    tmp = runs["tmp"]
    assert_payloads_match(stage_pickles(tmp / f"port{run}", stage),
                          stage_pickles(tmp / f"jax{run}", stage), atol)


def test_port_recovers_the_true_depth_and_filter_reads_it(runs):
    tmp = runs["tmp"]
    after = stage_pickles(tmp / "port", "human_after_opt")
    assert len(after) == 2
    for opt in after.values():
        assert np.abs(opt["verts"] - runs["human_world"]).max() < 0.15
    samples = stage_pickles(tmp / "port", "human_sample")
    for s in samples.values():
        assert s["IoU"] > 0.8 and s["interscetion_ratio"] < 0.05 and "z_min" in s
    cwd = os.getcwd()
    os.chdir(tmp / "port")
    try:
        stats = t_filter.main([])
    finally:
        os.chdir(cwd)
    assert stats["leftover"] == 2


def test_filter_out_path_matches(runs, tmp_path, monkeypatch):
    """``--filter_out --kernel_size 5``: the collision curve's local minima,
    the same kept candidates or the same TOO_SMALL_HUMAN sentinel."""
    for name, cli, dev in (("jax", j_init, []), ("port", t_init, ["--device", "cpu"])):
        shutil.copytree(runs["tmp"] / "src", tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        cli.main(["--asset_obj_pth", "asset.obj", "--filter_out", "--kernel_size", "5", *dev])
    assert_payloads_match(stage_pickles(tmp_path / "port", "human_before_opt"),
                          stage_pickles(tmp_path / "jax", "human_before_opt"), 1e-5)


def test_stage_clis_raise_without_a_card(runs, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(runs["tmp"] / "src")
    for cli in (t_init, t_opt, t_metrics):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--asset_obj_pth", "asset.obj"])
    with pytest.raises(RuntimeError, match="cuda"):
        t_predict.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        t_orch.main(["--skip", "segment", "predict", "optimize", "metrics"])


def test_predict_human_pickles_match(tmp_path, monkeypatch):
    from coma_tpu.utils.checkpoint import save_params

    small_towers(monkeypatch)
    save_params(small_variables(seed=3), str(tmp_path / "h4w.npz"))
    write_official_npz(str(tmp_path / "smplx.npz"), V=80, n_shape=20)
    rng = np.random.default_rng(12)
    boxes = {"00000": [[60.0, 40.0, 150.0, 230.0]],
             "00001": [[10.0, 10.0, 90.0, 200.0], [180.0, 20.0, 300.0, 230.0]], "00002": []}
    rel = f"{SC_STR}/{CAT_STR}/{ASSET}/view:00000/00000/{PROMPT}, full body"
    for d in ("inpaintings", "human_segs"):
        os.makedirs(tmp_path / "src" / d / rel)
    for name, bx in boxes.items():
        write_png(str(tmp_path / "src" / "inpaintings" / rel / f"{name}.png"),
                  (rng.uniform(size=(240, 320, 3)) * 255).astype(np.uint8))
        seg = dict(pred_masks=np.zeros((len(bx), 240, 320), bool),
                   pred_boxes=np.float32(bx).reshape(-1, 4), scores=np.ones(len(bx), np.float32),
                   pred_classes=np.zeros(len(bx), np.int64), image_size=(240, 320))
        with open(tmp_path / "src" / "human_segs" / rel / f"{name}.pickle", "wb") as fh:
            pickle.dump(seg, fh)
    out = {}
    for name, cli, dev in (("jax", j_predict, []), ("port", t_predict, ["--device", "cpu"])):
        cli.main(["--inpaint_dir", str(tmp_path / "src" / "inpaintings"),
                  "--human_seg_dir", str(tmp_path / "src" / "human_segs"),
                  "--save_dir", str(tmp_path / name), "--regressor_params",
                  str(tmp_path / "h4w.npz"), "--smplx_model_path", str(tmp_path / "smplx.npz"),
                  *dev])
        out[name] = {os.path.relpath(p, tmp_path / name): pickle.load(open(p, "rb"))
                     for p in glob.glob(f"{tmp_path / name}/*/*/*/*/*/*/*.pickle")}
    assert sorted(out["port"]) == sorted(out["jax"]) and len(out["jax"]) == 3
    assert all(PROMPT + "/" in k for k in out["jax"])   # grouped by the main prompt
    for rel, want in out["jax"].items():
        got = out["port"][rel]
        if isinstance(want, str):
            assert got == want
            continue
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["faces"], want["faces"])
        for key in ("verts", "pelvis", "joints_proj", "joints_img"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-2, err_msg=key)
        for key, value in want["smplx_data"].items():
            np.testing.assert_allclose(got["smplx_data"][key], value, rtol=1e-4,
                                       atol=1e-3 if "pose" in key or key == "global_orient"
                                       else 1e-4, err_msg=key)
        for key, value in want["convert_data"].items():
            np.testing.assert_allclose(got["convert_data"][key], value, rtol=1e-5)
    assert sorted(v if isinstance(v, str) else "ok" for v in out["port"].values()) == \
        ["MORE THAN 2 HUMANS", "NO HUMANS", "ok"]
