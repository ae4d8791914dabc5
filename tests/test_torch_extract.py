"""Port parity end to end: extraction and inference on a synthetic results tree.

The tree of ``tests/test_pipeline_e2e.py`` (filtered and object-downsampled by
``coma_tpu``'s stages, which the port does not have yet) is copied twice;
``coma_tpu``'s and the port's ``run_affordance_extraction`` (the port on the
CPU) each run on one copy, for all four products. Pickles and ``.npy``
products agree at rtol 2e-5 / atol 1e-6; ``.ply`` points, normals and colours
are equal.
"""
import shutil

import numpy as np
import pytest
import torch

from coma_tpu.cli import downsample_objects as j_downsample_objects
from coma_tpu.pipelines.extract import run_affordance_extraction as j_extract
from coma_tpu.pipelines.postfilter import run_post_filtering
from coma_tpu.utils.colormap import jet_rgb as j_jet
from coma_tpu.utils.ply import read_ply_pointcloud
from coma_tpu_torch.affordance.io import load_pickle
from coma_tpu_torch.cli import extract_coma as t_cli_extract
from coma_tpu_torch.cli import inference as t_cli_inference
from coma_tpu_torch.pipelines.extract import run_affordance_extraction as t_extract
from coma_tpu_torch.utils.colormap import jet_rgb as t_jet
from tests.test_pipeline_e2e import ASSET, CAT, HYPER, SC, results_tree  # noqa: F401

TOL = dict(rtol=2e-5, atol=1e-6)
PRODUCTS = {
    "aggr-human-contact": {},
    "aggr-object-contact": {},
    "orientation": {},
    "occupancy": dict(spatial_res=8, normal_res=0),
}
MAINPROMPT = "a person carrying a backpack"


def prepare(results_tree, hyper, monkeypatch):
    """Filter + downsample with coma_tpu, then copy the tree for the port."""
    monkeypatch.chdir(results_tree["tmp"])
    run_post_filtering(results_root="results")
    j_downsample_objects.main([
        "--obj_pth", results_tree["obj_pth"],
        "--supercategory", SC, "--category", CAT, "--asset_id", ASSET,
        "--number_of_points", str(hyper["object_res"]),
        "--save_dir", "results/coma/asset_downsample",
    ])
    shutil.copytree("results", "results_port")


def assert_close_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "device":
            continue
        if isinstance(a[k], np.ndarray):
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
        elif isinstance(a[k], dict):
            assert_close_dicts(a[k], b[k])
        else:
            assert a[k] == b[k], k


def assert_same_product(t_path, j_path):
    if t_path.endswith(".ply"):
        for got, want in zip(read_ply_pointcloud(t_path), read_ply_pointcloud(j_path)):
            np.testing.assert_array_equal(got, want)
        return
    got, want = np.load(t_path, allow_pickle=True), np.load(j_path, allow_pickle=True)
    if got.dtype == object:  # occupancy: dict(prob_field, spatial_grid_metadata)
        got, want = got.item(), want.item()
        np.testing.assert_allclose(got["prob_field"], want["prob_field"], **TOL)
        assert got["spatial_grid_metadata"].keys() == want["spatial_grid_metadata"].keys()
        return
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("visualize_type", list(PRODUCTS))
def test_extraction_and_inference_match(results_tree, monkeypatch, visualize_type):
    hyper = dict(HYPER, visualize_type=visualize_type, **PRODUCTS[visualize_type])
    prepare(results_tree, hyper, monkeypatch)
    common = dict(hyperparams=hyper, hyperparams_key="qual:test",
                  constants_mesh_dir=results_tree["constants"])
    (j_product,) = j_extract(results_root="results", **common)
    (t_product,) = t_extract(results_root="results_port", device="cpu", **common)
    assert t_product == j_product.replace("results/", "results_port/", 1)
    assert_same_product(t_product, j_product)

    rel = f"coma/extracted_coma/{SC}/{CAT}/{ASSET}/qual:test:{MAINPROMPT}.pickle"
    t_dict, j_dict = load_pickle(f"results_port/{rel}"), load_pickle(f"results/{rel}")
    assert t_dict["device"] == "cpu" and t_dict["used_count"] == results_tree["n_good"]
    assert_close_dicts(t_dict, j_dict)

    # the port's inference CLI re-derives coma_tpu's product from coma_tpu's pickle
    key = "qual:backpack_occupancy" if visualize_type == "occupancy" else "qual:backpack_human_contact"
    inferred = t_cli_inference.main([
        "--supercategory", SC, "--category", CAT, "--coma_path", f"results/{rel}",
        "--visualize_type", visualize_type, "--hyperparams_key", key,
        "--asset_downsample_pth",
        f"results/coma/asset_downsample/{SC}/{CAT}/{ASSET}_{hyper['object_res']}.pickle",
        "--output_dir", "output_port", "--device", "cpu",
    ])
    assert_same_product(inferred, j_product)


def test_jet_matches_matplotlib():
    edges = np.arange(257) / 256.0
    for values in (
        np.linspace(-0.1, 1.1, 2001, dtype=np.float32),
        np.linspace(-0.1, 1.1, 2001),
        np.concatenate([edges, np.nextafter(edges, -1), np.nextafter(edges, 2)]),
        np.float32([0.0, 1.0, np.nan, -np.inf, np.inf]),
    ):
        np.testing.assert_array_equal(t_jet(values), j_jet(values))


def test_cuda_request_without_card_raises(results_tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_extract(HYPER, "qual:test", results_root="results", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli_extract.main(["--hyperparams_key", "qual:backpack_human_contact"])


def _flag_argv(action) -> list:
    """A command line that sets one of ``coma_tpu``'s extract_coma options."""
    flag = action.option_strings[-1]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, str(list(action.choices)[0])]
    value = action.default if action.default not in (None, []) else "1"
    return [flag] + ([str(value)] if action.nargs in (None, 1) else [str(value), "2"])


def _reference_options():
    from coma_tpu.cli import extract_coma as j_cli

    return [a for a in j_cli.build_parser()._actions if a.option_strings
            and "--help" not in a.option_strings]


@pytest.mark.parametrize("action", _reference_options(),
                         ids=[a.option_strings[-1] for a in _reference_options()])
def test_parser_accepts_every_coma_tpu_flag(action):
    """Every flag ``coma_tpu.cli.extract_coma`` accepts parses in the port,
    with ``coma_tpu``'s default (the seven reference-only directory flags are
    accepted and unused in both)."""
    required = ["--hyperparams_key", "qual:backpack_human_contact"]
    argv = _flag_argv(action)
    args = t_cli_extract.build_parser().parse_args(
        argv + (required if action.dest != "hyperparams_key" else []))
    assert hasattr(args, action.dest)
    defaults = t_cli_extract.build_parser().parse_args(required)
    assert getattr(defaults, action.dest) == (action.default if action.dest != "hyperparams_key"
                                              else "qual:backpack_human_contact")
