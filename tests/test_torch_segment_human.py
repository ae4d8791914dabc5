"""``segment_human`` and the instance utilities, the port against ``coma_tpu``.

A seeded 7-level tree of 128² inpainted PNGs (``coma_tpu``'s synthetic
people, two categories, two prompts) goes through both CLIs on the CPU.
With the committed U-Net checkpoint the pickles hold the same keys, dtypes,
shapes, masks, boxes, classes and image sizes, and scores within 1e-6 (the
mean of probabilities the two frameworks compute in float32). With one
numpy probability function standing in for the U-Net on both sides the
pickles are equal byte for byte. ``connected_instances``, ``seg2bbox`` and
``merge_bbox`` are exact.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.cli import segment_human as j_cli
from coma_tpu.models import segmentation as j_seg
from coma_tpu.models.synthetic_person import person_batch
from coma_tpu_torch.cli import segment_human as t_cli
from coma_tpu_torch.models import segmentation as t_seg
from coma_tpu_torch.utils.png import write_png

TREE = [("BEHAVE", "backpack", "1 person wears the backpack"),
        ("BEHAVE", "backpack", "1 person wears the backpack, full body"),
        ("SAPIEN", "chair", "1 person sits on the chair, full body")]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("segment_tree")
    imgs, _ = person_batch(np.random.default_rng(31), 6, 128)
    k = 0
    for sc, cat, prompt in TREE:
        d = root / "inp" / sc / cat / "asset_0" / "view:00000" / "0" / prompt
        d.mkdir(parents=True)
        for i in range(2):
            write_png(str(d / f"{i:05d}.png"), (imgs[k] * 255).astype(np.uint8))
            k += 1
    return root


def read_pickles(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = pickle.load(fh)
    return out


def run_both(tree, tag, extra=()):
    argv = ["--inpaint_dir", str(tree / "inp"), "--threshold", "0.5", *extra]
    j_cli.main(argv + ["--save_dir", str(tree / f"j_{tag}")])
    t_cli.main(argv + ["--save_dir", str(tree / f"t_{tag}"), "--device", "cpu"])
    return read_pickles(tree / f"j_{tag}"), read_pickles(tree / f"t_{tag}")


def test_pickles_match_coma_tpu(tree):
    want, got = run_both(tree, "unet")
    assert len(want) == 6 and got.keys() == want.keys()
    n_instances = 0
    for name, w in want.items():
        g = got[name]
        assert list(g) == list(w) == ["pred_masks", "pred_boxes", "scores", "pred_classes",
                                      "image_size"]
        assert g["image_size"] == w["image_size"] == (128, 128)
        for k in ("pred_masks", "pred_boxes", "scores", "pred_classes"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (name, k)
        for k in ("pred_masks", "pred_boxes", "pred_classes"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-6)
        n_instances += len(w["scores"])
    assert n_instances >= 3
    assert want[next(iter(want))]["pred_masks"].dtype == bool


def fake_probs(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) -> (B, H, W) float32: a fixed numpy function of the image."""
    x = images.astype(np.float32)
    return np.float32(1.0) / (np.float32(1.0) + np.exp((x[..., 1] - x[..., 0]) * np.float32(8)))


@pytest.mark.parametrize("extra", [[], ["--only_full_body_prompts"],
                                   ["--prompts", "1 person sits on the chair"],
                                   ["--supercategories", "behave", "--threshold", "0.9"],
                                   ["--parallel_num", "2", "--parallel_idx", "1"]])
def test_pickles_equal_with_one_probability_function(tree, monkeypatch, extra):
    def j_probs(model, params, imgs):
        spec = jax.ShapeDtypeStruct(imgs.shape[:-1], jnp.float32)
        return jax.pure_callback(lambda a: fake_probs(np.asarray(a)), spec, imgs)

    monkeypatch.setattr(j_seg, "person_probs_canonical", j_probs)
    monkeypatch.setattr(t_seg, "person_probs_canonical",
                        lambda model, x: torch.from_numpy(fake_probs(
                            x.permute(0, 2, 3, 1).numpy())))
    tag = "fake_" + "_".join(extra).replace("-", "").replace(" ", "")
    want, got = run_both(tree, tag, extra)
    assert got.keys() == want.keys() and len(want) >= 1
    for name in want:
        assert pickle.dumps(got[name]) == pickle.dumps(want[name]), name


def test_pointrend_segmenter_writes_the_same_layout(tree, tmp_path, monkeypatch):
    """``--segmenter pointrend`` on a seeded Flax ``.npz`` (the ``--tiny``
    detector config, to keep the CPU run short); the pickles' layout is
    ``coma_tpu``'s; without ``--segmenter_params`` the CLI refuses."""
    from coma_tpu.utils.checkpoint import save_params
    from coma_tpu_torch.models import pointrend as tpr
    from coma_tpu_torch.models.layers import init_flax_default_

    tiny = tpr.PointRendConfig(max_detections=4, test_size=64, pre_nms_topk=64,
                               post_nms_topk=32, box_candidates=32)
    model = init_flax_default_(tpr.PointRendModel(tiny), torch.Generator().manual_seed(3))
    tree_np = {}
    for key, value in model.state_dict().items():
        node = tree_np
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        arr = value.numpy()
        if leaf == "weight" and arr.ndim in (2, 4) and parents[-1] != "norm":
            leaf, arr = "kernel", (arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))
        node[leaf] = arr
    save_params({"params": tree_np}, str(tmp_path / "pr.npz"))
    monkeypatch.setattr(tpr, "PointRendConfig", lambda: tiny)
    t_cli.main(["--inpaint_dir", str(tree / "inp"), "--save_dir", str(tmp_path / "out"),
                "--segmenter", "pointrend", "--segmenter_params", str(tmp_path / "pr.npz"),
                "--threshold", "0.0", "--device", "cpu"])
    got = read_pickles(tmp_path / "out")
    assert len(got) == 6
    for g in got.values():
        assert list(g) == ["pred_masks", "pred_boxes", "scores", "pred_classes", "image_size"]
        n = len(g["scores"])
        assert g["pred_masks"].dtype == bool and g["pred_masks"].shape == (n, 128, 128)
        assert g["pred_boxes"].dtype == np.float32 and g["pred_boxes"].shape == (n, 4)
        assert g["scores"].dtype == np.float32 and g["pred_classes"].dtype == np.int64
    with pytest.raises(SystemExit, match="segmenter_params"):
        t_cli.main(["--inpaint_dir", str(tree / "inp"), "--segmenter", "pointrend",
                    "--device", "cpu"])


def test_mode_and_device_defaults():
    args = t_cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.segmenter == "unet" and args.threshold == 0.8
    for mode in ("lvis", "odise"):
        with pytest.raises(NotImplementedError):
            t_cli.main(["--mode", mode])


def test_instance_utilities_match():
    rng = np.random.default_rng(32)
    mask = np.zeros((64, 80), np.float32)
    mask[5:30, 5:20] = 1          # an instance
    mask[40:60, 50:78] = 1        # another, touching nothing
    mask[2:6, 70:74] = 1          # 16 pixels: under min_area
    mask[30:33, 30:60] = (rng.uniform(size=(3, 30)) > 0.3)
    for min_area in (64, 8):
        want = j_seg.connected_instances(mask, min_area)
        got = t_seg.connected_instances(mask, min_area)
        assert len(got) == len(want) >= 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a["area"] == b["area"]
            np.testing.assert_array_equal(a["mask"], b["mask"])
            np.testing.assert_array_equal(a["bbox"], b["bbox"])
            assert a["bbox"].dtype == b["bbox"].dtype == np.float32
    np.testing.assert_array_equal(t_seg.seg2bbox(mask), j_seg.seg2bbox(mask))
    boxes = [np.array([3, 4, 10, 12]), np.array([1, 8, 7, 20]), np.array([5, 0, 9, 9])]
    np.testing.assert_array_equal(t_seg.merge_bbox(boxes), j_seg.merge_bbox(boxes))
    with pytest.raises(ValueError):
        t_seg.merge_bbox([])
