"""Stage 1 end to end, the port's CLIs against ``coma_tpu``'s on the CPU.

A textured asset (``tests/test_torch_rendering.py``'s ``write_textured_asset``)
under the registered Chair id goes through ``render_objects`` (64², 2 views,
every other flag at its default: AO 8, specular 0.25, sky environment, ACES
tonemap), ``select_mask`` and ``generate_prompts`` in both packages, in two
directories. Segmentations, candidate masks, camera, valid-mask and prompt
pickles are equal; renders (uint8, truncated on both sides) within 1 level on
99.9% of values and within 0.15 x 255 everywhere (a shadow-map tap can flip,
``tests/test_torch_rendering.py``). Then the port's ``inpaint --tiny`` takes
one batch of 4 from the port's tree, and ``generate_2d_hoi_images`` runs the
stages from one mixed flag list.
"""
import glob
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from coma_tpu.cli import generate_prompts as j_prompts
from coma_tpu.cli import render_objects as j_render
from coma_tpu.cli import select_mask as j_select
from coma_tpu_torch.cli import generate_2d_hoi_images as t_orch
from coma_tpu_torch.cli import generate_prompts as t_prompts
from coma_tpu_torch.cli import inpaint as t_inpaint
from coma_tpu_torch.cli import render_objects as t_render
from coma_tpu_torch.cli import select_mask as t_select
from coma_tpu_torch.utils.png import read_png
from tests.test_torch_rendering import write_textured_asset

SC, CAT = "Chair", "Lounge Chair / Cafe Chair / Office Chair"
ASSET = "0a5a346c-cc3b-4280-b358-ccd1c4d8a865"
GEN = "results/generation"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def render_flags(obj_pth):
    return ["--obj_pth", obj_pth, "--supercategory", SC, "--category", CAT,
            "--asset_id", ASSET, "--resolution", "64", "64", "--default_view_num", "2"]


def run_stage1(root, package, obj_pth, monkeypatch):
    os.makedirs(root, exist_ok=True)
    monkeypatch.chdir(root)
    device = ["--device", "cpu"] if package == "torch" else []
    render, select, prompts = ((t_render, t_select, t_prompts) if package == "torch"
                               else (j_render, j_select, j_prompts))
    render.main(render_flags(obj_pth) + device)
    select.main(device)
    prompts.main([])


def load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Stage 1 of both packages on one asset: {"jax": root, "torch": root}."""
    base = tmp_path_factory.mktemp("stage1")
    obj_pth = write_textured_asset(str(base))
    mp = pytest.MonkeyPatch()
    try:
        roots = {}
        for package in ("jax", "torch"):
            roots[package] = str(base / package)
            run_stage1(roots[package], package, obj_pth, mp)
    finally:
        mp.undo()
    return roots


def test_stage1_outputs_match_coma_tpu(trees):
    want = sorted(os.path.relpath(p, trees["jax"])
                  for p in glob.glob(f"{trees['jax']}/{GEN}/**/*.*", recursive=True))
    got = sorted(os.path.relpath(p, trees["torch"])
                 for p in glob.glob(f"{trees['torch']}/{GEN}/**/*.*", recursive=True))
    assert got == want
    kinds = {rel.split("/")[2] for rel in want}
    assert kinds == {"renders", "asset_segs", "asset_masks", "cameras", "valid_masks", "prompts"}
    assert sum("/asset_masks/" in rel for rel in want) > 50
    for rel in want:
        a, b = (os.path.join(trees[k], rel) for k in ("jax", "torch"))
        if rel.endswith(".pickle"):
            pa, pb = load(a), load(b)
            assert pb.keys() == pa.keys(), rel
            for k in pa:
                np.testing.assert_array_equal(np.asarray(pb[k]), np.asarray(pa[k]), err_msg=rel)
            continue
        with Image.open(a) as im:
            ref, mode = np.asarray(im), im.mode
        img = read_png(b)
        img = img[..., 0] if img.shape[-1] == 1 else img
        assert img.shape == ref.shape and mode in ("L", "RGB"), rel
        if "/renders/" in rel:
            diff = np.abs(img.astype(int) - ref)
            assert (diff > 1).mean() <= 1e-3 and diff.max() <= 0.15 * 255, rel
        else:
            np.testing.assert_array_equal(img, ref, err_msg=rel)


def test_renders_have_a_white_background_and_a_textured_object(trees):
    for view in ("view:00000", "view:00001"):
        tree = f"{trees['torch']}/{GEN}"
        rgb = read_png(glob.glob(f"{tree}/renders/*/*/*/{view}.png")[0])
        seg = read_png(glob.glob(f"{tree}/asset_segs/*/*/*/{view}.png")[0])[..., 0]
        assert rgb.shape == (64, 64, 3) and set(np.unique(seg)) == {0, 255}
        obj = rgb[seg > 0].astype(float)
        assert obj.std() > 5 and (rgb[seg == 0] < 255).any()   # ground shading below


def test_inpaint_one_batch_from_the_ports_tree(trees, tmp_path, monkeypatch):
    """Two views with a mask each, one prompt, both view augmentations, one
    image each: one batch of 4 through ``inpaint --tiny``."""
    import shutil

    root = tmp_path / "inpaint"
    shutil.copytree(trees["torch"], root)
    monkeypatch.chdir(root)
    kept = 0
    for p in sorted(glob.glob(f"{GEN}/valid_masks/*/*/*/*.pickle")):
        d = load(p)
        d["valid_mask_ids"] = (d["valid_mask_ids"] or ["00000"])[:1]
        kept += 1
        with open(p, "wb") as fh:
            pickle.dump(d, fh)
    assert kept == 2
    pp = glob.glob(f"{GEN}/prompts/*/*/*/prompts.pickle")[0]
    prompts = load(pp)
    prompts["prompts"] = prompts["prompts"][:1]
    with open(pp, "wb") as fh:
        pickle.dump(prompts, fh)
    t_inpaint.main(["--device", "cpu", "--random_weights", "--tiny",
                    "--num_img_per_combination", "1", "--batch_size", "4"])
    outs = glob.glob(f"{GEN}/inpaintings/*/*/*/*/*/*/*.png")
    assert len(outs) == 4
    for p in outs:
        img = read_png(p)
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8


def test_orchestrator_reads_one_mixed_flag_list(tmp_path, monkeypatch):
    obj_pth = write_textured_asset(str(tmp_path), n=2)
    monkeypatch.chdir(tmp_path)
    t_orch.main(["--skip", "inpaint"] + render_flags(obj_pth) + [
        "--device", "cpu", "--ao_samples", "0", "--default_min_seg_overlap_ratio", "0.0",
        "--default_max_seg_overlap_ratio", "1.0"])
    assert len(glob.glob(f"{GEN}/renders/*/*/*/*.png")) == 2
    assert len(glob.glob(f"{GEN}/valid_masks/*/*/*/*.pickle")) == 2
    assert len(glob.glob(f"{GEN}/prompts/*/*/*/prompts.pickle")) == 1


def test_cli_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_render.main(render_flags(str(tmp_path / "absent.obj")))
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_select.main([])


def test_generate_prompts_with_a_vlm_stub(tmp_path, monkeypatch):
    """``--use_vlm`` imports ``openai`` lazily; a stub module answers, and
    both packages write the same pickle from its reply."""
    calls = []

    class Completions:
        def create(self, **kw):
            calls.append(kw)
            text = "1. 1 person sits on a chair.\nnoise\n2. A 1 person lifts a chair"
            message = types.SimpleNamespace(content=text)
            return types.SimpleNamespace(choices=[types.SimpleNamespace(message=message)])

    class OpenAI:
        def __init__(self):
            self.chat = types.SimpleNamespace(completions=Completions())

    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=OpenAI))
    results = {}
    for name, mod in (("jax", j_prompts), ("torch", t_prompts)):
        root = tmp_path / name
        render_dir = root / GEN / "renders" / SC / "Lounge Chair : Cafe Chair : Office Chair"
        (render_dir / ASSET).mkdir(parents=True)
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(render_dir / ASSET / "view:00000.png")
        monkeypatch.chdir(root)
        mod.main(["--use_vlm", "--selected_view", "3"])
        results[name] = load(glob.glob(f"{GEN}/prompts/*/*/*/prompts.pickle")[0])
    assert results["torch"] == results["jax"]
    assert results["torch"]["prompts"] == ["1 person sits on a chair", "1 person lifts a chair"]
    assert [c["temperature"] for c in calls] == [0.0, 0.0]
