"""Port parity of the post-filter stage: on a seeded results tree whose
samples straddle each of the three thresholds (IoU, intersection ratio under
the reference's ``interscetion_ratio`` [sic] key, inlier count), with
sentinels, viewpoint-augmented and ``total`` prompts, the whitelist JSONs
and the statistics equal ``coma_tpu``'s, in both
``enable_aggregate_total_prompts`` modes, through the library and the CLI.
"""
import os
import pickle

import numpy as np
import pytest

from coma_tpu.pipelines.postfilter import run_post_filtering as j_filter
from coma_tpu_torch.cli import filter as t_cli
from coma_tpu_torch.pipelines.postfilter import run_post_filtering as t_filter

SC, ASSET = "BEHAVE", "behave_asset"
PROMPTS = ["a person carrying a backpack", "a person carrying a backpack, full body",
           "a person carrying a backpack, from behind",   # not an allowed viewpoint
           "a person wearing a backpack", "total:a person with a backpack"]


def write_tree(root, seed=0):
    """Per (category, view, prompt) six samples with values drawn across the
    thresholds, the odd one a sentinel; some without ``num_inliers``, some
    under the corrected ``intersection_ratio`` key."""
    rng = np.random.default_rng(seed)
    for cat in ("backpack", "a/b"):
        for view in ("000", "001"):
            for prompt in PROMPTS:
                d = os.path.join(root, "generation", "human_sample", SC, cat.replace("/", ":"),
                                 ASSET, view, "0", prompt)
                os.makedirs(d)
                for i in range(6):
                    if rng.uniform() < 0.15:
                        payload = "NO HUMANS"
                    else:
                        payload = {"verts": np.zeros((3, 3)), "faces": np.zeros((1, 3), int),
                                   "IoU": float(rng.choice([0.69, 0.7, 0.71, rng.uniform()]))}
                        ratio = float(rng.choice([0.049, 0.05, 0.051, rng.uniform(0, 0.1)]))
                        payload["interscetion_ratio" if rng.uniform() < 0.8
                                else "intersection_ratio"] = ratio
                        if rng.uniform() < 0.85:
                            payload["num_inliers"] = int(rng.integers(0, 3))
                    with open(os.path.join(d, f"{i:05d}.pickle"), "wb") as fh:
                        pickle.dump(payload, fh)


def read_all(save_dir):
    out = {}
    for dirpath, _, names in os.walk(save_dir):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p) as fh:
                out[os.path.relpath(p, save_dir)] = fh.read()
    return out


@pytest.mark.parametrize("total", [False, True])
@pytest.mark.parametrize("thresholds", [dict(), dict(IoU_threshold_min=0.5,
                                                     intersection_volume_ratio_threshold_max=0.02,
                                                     inlier_num_threshold_min=2)])
def test_whitelists_and_statistics_equal(tmp_path, total, thresholds):
    write_tree(str(tmp_path / "results"))
    common = dict(results_root=str(tmp_path / "results"), enable_aggregate_total_prompts=total,
                  verbose=False, **thresholds)
    want = j_filter(save_dir=str(tmp_path / "j"), **common)
    got = t_filter(save_dir=str(tmp_path / "t"), **common)
    assert got == want
    assert want["initial"] > 0 and want["leftover"] > 0
    if not total and not thresholds:   # the seeded tree reaches every rejection
        assert min(want["rejected_iou"], want["rejected_intersection"],
                   want["rejected_inliers"]) > 0
    j_files, t_files = read_all(tmp_path / "j"), read_all(tmp_path / "t")
    assert j_files == t_files and j_files


def test_cli_filters_by_category_and_prompt(tmp_path, monkeypatch):
    write_tree(str(tmp_path / "results"), seed=1)
    monkeypatch.chdir(tmp_path)
    stats = t_cli.main(["--categories", "a/b", "--prompts", "a person wearing a backpack",
                        "--save_dir", "t"])
    want = j_filter(categories=["a/b"], prompts=["a person wearing a backpack"],
                    results_root="results", save_dir="j", verbose=False)
    assert stats == want
    files = read_all("t")
    assert files == read_all("j")
    assert list(files) == [f"{SC}/a:b/{ASSET}/a person wearing a backpack.json"]
