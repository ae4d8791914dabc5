"""The port's weights-readiness check (``models/weights_readiness.py``,
``cli/convert_weights.py``; ROADMAP item 16) against ``coma_tpu``'s, on the
CPU.

- ``MANIFEST`` equals ``coma_tpu``'s, field by field.
- ``expected_shapes`` names what the port's loaders read: a seeded stand-in
  in each published layout (COAP's Lightning ``.ckpt`` at ``COAPConfig()``,
  a VPoser snapshot at ``VPoserConfig()``, a diffusers directory at the
  tests' tiny widths with its configs, detectron2's PointRend R50-FPN,
  SAM ViT-B and Hand4Whole's ``snapshot_6.pth.tar`` at their published
  widths) goes through ``read_published`` with no problem from
  ``verify_tree``; a wrong shape, a missing and a stray array are reported.
- ``convert_weights --all``: an empty root exits 0 with every entry
  missing; present stand-ins are ``loaded``; a corrupt file, a wrong shape
  and a file whose md5 does not start with the publisher's prefix each exit
  1 with their status; ``--kind/--src/--out`` are refused.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from coma_tpu.models import weights_readiness as J
from coma_tpu_torch.cli import convert_weights as t_cli
from coma_tpu_torch.models import weights_readiness as T
from coma_tpu_torch.models.hand4whole import Hand4Whole
from coma_tpu_torch.models.layers import init_flax_default_
from coma_tpu_torch.models.vposer import VPoserConfig, VPoserDecoder, VPoserEncoder
from tests import torch_pointrend_mirror as pointrend_mirror
from tests.test_sam import _official_tiny_state_dict
from tests.test_torch_coap_weights import write_checkpoint
from tests.test_torch_hand4whole import torch_layout
from tests.test_torch_sd_weights import write_sd_dir
from tests.test_torch_smplx import write_official_npz


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_manifest_equals_coma_tpus():
    assert len(T.MANIFEST) == len(J.MANIFEST)
    for got, want in zip(T.MANIFEST, J.MANIFEST):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def write_vposer(path, seed=0):
    cfg, gen = VPoserConfig(), torch.Generator().manual_seed(seed)
    sd = {}
    for module in (VPoserDecoder(cfg, device="cpu"), VPoserEncoder(cfg, device="cpu")):
        for k, v in init_flax_default_(module, gen).state_dict().items():
            sd[f"bodyprior_{k}"] = v
    sd["bodyprior_enc_bn1.num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": sd}, path)


def write_stand_in(kind, root):
    """A seeded file in ``kind``'s published layout under ``root``; returns
    its path."""
    rng = np.random.default_rng(0)
    if kind == "coap":
        path = os.path.join(root, "coap_smplx_neutral.ckpt")
        write_checkpoint(path, 20, (True, "model."))
    elif kind == "vposer":
        path = os.path.join(root, "TR00_E096.pt")
        write_vposer(path)
    elif kind == "sd":
        path = os.path.join(root, "stable-diffusion-2-inpainting")
        os.makedirs(path)
        write_sd_dir(path)
    elif kind == "pointrend":
        torch.manual_seed(0)
        path = os.path.join(root, "model_final.pth")
        torch.save({k: v for k, v in pointrend_mirror.PointRendRCNNMirror().state_dict().items()
                    if "._box." not in k}, path)
    elif kind == "sam":
        from coma_tpu.models.sam import SAMConfig

        path = os.path.join(root, "sam_vit_b.pth")
        torch.save(_official_tiny_state_dict(SAMConfig(), rng), path)
    else:
        path = os.path.join(root, "snapshot_6.pth.tar")
        torch.save({"network": torch_layout(Hand4Whole(), rng), "epoch": 6}, path)
    return path


@pytest.mark.parametrize("kind", ["coap", "vposer", "sd", "pointrend", "sam", "hand4whole"])
def test_expected_shapes_name_what_the_loaders_read(kind, tmp_path):
    path = write_stand_in(kind, str(tmp_path))
    tree = T.read_published(kind, path)
    src_dir = path if kind == "sd" else None
    assert T.verify_tree(kind, tree, src_dir) == []
    want = T.expected_shapes(kind, src_dir)
    assert len(want) == len(tree) > 0
    name = sorted(tree)[len(tree) // 2]
    bad = dict(tree, **{name: np.zeros(tuple(want[name]) + (2,), np.float32)})
    missing = sorted(tree)[0]
    del bad[missing]
    bad["not_a_layer.weight"] = np.zeros(3, np.float32)
    assert T.verify_tree(kind, bad, src_dir) == [
        f"missing leaf {missing} (expected {want[missing]})",
        "unexpected leaf not_a_layer.weight (3,)",
        f"shape mismatch {name}: got {tuple(want[name]) + (2,)}, expected {want[name]}"]


def run_all(root, tmp_path):
    report = str(tmp_path / "report.json")
    with pytest.raises(SystemExit) as done:
        t_cli.main(["--all", "--weights_root", str(root), "--report", report])
    with open(report) as f:
        return done.value.code, json.load(f)


def test_all_on_an_empty_root_exits_0(tmp_path):
    (tmp_path / "root").mkdir()
    code, report = run_all(tmp_path / "root", tmp_path)
    assert code == 0
    assert list(report) == [e.name for e in T.MANIFEST]
    assert all(item["status"] == "missing" and item["path"] is None for item in report.values())


def test_all_loads_present_stand_ins(tmp_path):
    root = tmp_path / "root"
    for sub in ("coap", "vposer", "smplx"):
        (root / sub).mkdir(parents=True)
    write_stand_in("coap", str(root / "coap"))
    write_stand_in("vposer", str(root / "vposer"))
    write_official_npz(str(root / "smplx" / "SMPLX_NEUTRAL.npz"), V=40)
    code, report = run_all(root, tmp_path)
    assert code == 0
    loaded = {k for k, v in report.items() if v["status"] == "loaded"}
    assert loaded == {"coap_smplx_neutral", "vposer", "smplx_neutral"}
    assert report["smplx_neutral"]["num_verts"] == 40
    assert all(len(report[k]["sha256"]) == 64 for k in loaded)


@pytest.mark.parametrize("fault,status", [("corrupt", "load_failed"),
                                          ("shape", "shape_mismatch"),
                                          ("md5", "checksum_mismatch")])
def test_all_on_a_failing_file_exits_1(tmp_path, fault, status):
    root = tmp_path / "root"
    (root / "coap").mkdir(parents=True)
    if fault == "md5":
        name = "pointrend_r50_fpn_3x"
        (root / "model_final_edd263.pkl").write_bytes(b"not the publisher's bytes")
    else:
        name = "coap_smplx_neutral"
        path = str(root / "coap" / "coap_smplx_neutral.ckpt")
        if fault == "corrupt":
            with open(path, "wb") as f:
                f.write(b"\x00" * 64)
        else:
            write_checkpoint(path, 20, (True, "model."))
            ckpt = torch.load(path, weights_only=True)
            ckpt["state_dict"]["model.decoder.lin2.weight"] = torch.zeros(5, 5)
            torch.save(ckpt, path)
    code, report = run_all(root, tmp_path)
    assert code == 1
    assert report[name]["status"] == status
    if fault == "shape":
        assert report[name]["problems"] == [
            "shape mismatch decoder.lin2.weight: got (5, 5), expected (125, 256)"]
    if fault == "md5":
        assert report[name]["md5_prefix_ok"] is False


def test_one_file_conversion_is_refused():
    with pytest.raises(SystemExit, match="reads the published files directly"):
        t_cli.main(["--kind", "coap", "--src", "x.ckpt", "--out", "x.npz"])
