"""The whole ComA learning stage on the CPU: ``coma_tpu_torch.cli.learn_coma``
against ``coma_tpu.cli.learn_coma`` on two copies of one tree (a seeded
SMPL-X npz in the official key layout, cube/backpack-like samples carrying
``IoU``, ``interscetion_ratio`` and ``num_inliers``, one rejected by each
threshold and one sentinel, and an asset OBJ): filter -> downsample_human ->
downsample_objects (2048, 1500, 180) -> the four default qual extractions.

Whitelists are equal; the downsample pickles have equal indices and arrays
within rtol 2e-5 / atol 1e-6 (the star template comes from two LBS
implementations in float32); the four extracted pickles and their products
agree at the golden tolerance, rtol 2e-5 / atol 1e-6.

``coma_tpu``'s ``downsample_human --smplx_model_path`` passes the model's
flat ``faces`` tuple to ``save_obj``, which needs (F, 3) rows (ROADMAP
Queue 3); its ``from_npz`` is wrapped here to hand over the rows, and
nothing else of it changes.
"""
import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from coma_tpu.cli import learn_coma as j_learn_coma
from coma_tpu.geometry.mesh import save_obj
from coma_tpu.models import smplx as j_smplx
from coma_tpu_torch.cli import learn_coma as t_learn_coma
from tests.test_torch_extract import assert_close_dicts, assert_same_product
from tests.test_torch_smplx import write_official_npz

SC, CAT, ASSET = "BEHAVE", "backpack", "behave_asset"
PROMPT = "a person carrying a backpack"
KEYS = ("qual:backpack_human_contact", "qual:backpack_object_contact",
        "qual:backpack_occupancy", "qual:backpack_orientation")
TOL = dict(rtol=2e-5, atol=1e-6)
V = 32
N_GOOD = 10


def write_tree(root):
    """``root/results`` samples, ``root/smplx.npz`` and ``root/asset.obj``."""
    rng = np.random.default_rng(0)
    os.makedirs(root)
    write_official_npz(os.path.join(root, "smplx.npz"), V=V, seed=3)
    faces = np.array([[i, i + 1, i + 2] for i in range(V - 2)])
    box = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * [0.3, 0.15, 0.45]
    box_faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                          [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]])
    save_obj(os.path.join(root, "asset.obj"), box, box_faces)
    template = rng.normal(size=(V, 3)) * 0.15 + [0.15, 0.3, 0.25]
    # (IoU, intersection ratio, inliers): survivors, then one rejected by each threshold
    metrics = [(0.9, 0.01, 5)] * N_GOOD + [(0.5, 0.01, 5), (0.9, 0.2, 5), (0.9, 0.01, 0)]
    for k, m in enumerate(metrics + [None]):
        d = os.path.join(root, "results", "generation", "human_sample", SC, CAT, ASSET,
                         f"{k // 4:03d}", "0", PROMPT if k % 2 else f"{PROMPT}, full body")
        os.makedirs(d, exist_ok=True)
        payload = "NO HUMANS" if m is None else dict(
            verts=template + rng.normal(scale=0.02, size=(V, 3)), faces=faces, IoU=m[0],
            interscetion_ratio=m[1], num_inliers=m[2])
        with open(os.path.join(d, f"{k:05d}.pickle"), "wb") as fh:
            pickle.dump(payload, fh)


def files(root, sub):
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, sub)):
        for n in names:
            out[os.path.relpath(os.path.join(dirpath, n), root)] = os.path.join(dirpath, n)
    return out


def load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def assert_downsample_close(got, want, key):
    assert set(got) == set(want), key
    for k in got:
        a, b = got[k], want[k]
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            assert a.dtype == b.dtype and a.shape == b.shape, f"{key}.{k}"
            np.testing.assert_allclose(a, b, err_msg=f"{key}.{k}", **TOL)
        elif isinstance(a, (list, np.ndarray)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{key}.{k}")
        else:
            assert a == b, f"{key}.{k}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' learn_coma, each on its copy of one tree; returns the
    (coma_tpu, port) roots."""
    tmp = tmp_path_factory.mktemp("learn_coma")
    write_tree(str(tmp / "src"))
    for name in ("jax", "port"):
        shutil.copytree(tmp / "src", tmp / name)
    from_npz = j_smplx.SMPLXModel.from_npz

    def with_face_rows(path, **kwargs):
        model = from_npz(path, **kwargs)
        return dataclasses.replace(model, faces=tuple(map(tuple, model.faces_array.tolist())))

    argv = ["--smplx_model_path", "smplx.npz", "--num_human_downsample_points_list", "16", "20000",
            "--obj_pth", "asset.obj", "--supercategory", SC, "--category", CAT,
            "--asset_id", ASSET]
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_smplx.SMPLXModel, "from_npz", staticmethod(with_face_rows))
        mp.chdir(tmp / "jax")
        j_learn_coma.main(argv)
        mp.chdir(tmp / "port")
        torch.set_num_threads(2)   # the test workers share the host's cores
        try:
            t_learn_coma.main(argv + ["--device", "cpu"])
        finally:
            torch.set_num_threads(threads)
    return str(tmp / "jax"), str(tmp / "port")


def test_whitelists_equal(runs):
    jax_root, port_root = runs
    whitelists = files(port_root, "results/coma/human_postfilterings")
    assert whitelists.keys() == files(jax_root, "results/coma/human_postfilterings").keys()
    assert len(whitelists) == 1
    for rel, path in whitelists.items():
        with open(path) as a, open(os.path.join(jax_root, rel)) as b:
            assert a.read() == b.read()


def test_downsample_pickles_match(runs):
    """The human's (16 points and FULL), the object's at 3 resolutions."""
    jax_root, port_root = runs
    downsamples = {**files(port_root, "constants/mesh"),
                   **files(port_root, "results/coma/asset_downsample")}
    assert sorted(os.path.basename(p) for p in downsamples) == sorted([
        "smplx_star.obj", "smplx_star.pickle", "smplx_star_downsampled_16.pickle",
        "smplx_star_downsampled_FULL.pickle", f"{ASSET}.obj", f"{ASSET}_2048.pickle",
        f"{ASSET}_1500.pickle", f"{ASSET}_180.pickle"])
    for rel, path in downsamples.items():
        if rel.endswith(".pickle"):
            assert_downsample_close(load(path), load(os.path.join(jax_root, rel)), rel)


@pytest.mark.parametrize("key", KEYS)
def test_extraction_and_product_match(runs, key):
    jax_root, port_root = runs
    rel = f"results/coma/extracted_coma/{SC}/{CAT}/{ASSET}/{key}:{PROMPT}.pickle"
    got = load(os.path.join(port_root, rel))
    assert got["used_count"] == N_GOOD     # the survivors of the filter
    assert_close_dicts(got, load(os.path.join(jax_root, rel)))
    product_dir = f"results/coma/affordance/{SC}/{CAT}/{ASSET}/{key}:{PROMPT}"
    products = files(port_root, product_dir)
    assert products and products.keys() == files(jax_root, product_dir).keys()
    for rel_product, path in products.items():
        assert_same_product(path, os.path.join(jax_root, rel_product))


def test_device_stages_raise_without_a_card(tmp_path, monkeypatch):
    from coma_tpu_torch.cli import downsample_human

    write_official_npz(str(tmp_path / "smplx.npz"), V=V)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        downsample_human.main(["--smplx_model_path", "smplx.npz"])
    with pytest.raises(RuntimeError, match="cuda"):
        t_learn_coma.main(["--skip", "filter", "downsample_objects", "extract",
                           "--smplx_model_path", "smplx.npz"])
    assert not (tmp_path / "constants").exists()
