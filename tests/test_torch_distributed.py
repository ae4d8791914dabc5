"""Multi-process extraction of the port (``parallel/distributed.py``) on the
CPU under gloo, against sequential aggregation.

- ``process_shard_worklist`` equals ``coma_tpu``'s for 0–13 items on 1–8 ranks.
- The extraction CLI with ``--multihost`` on 2 ranks (``COMA_*`` variables)
  and on 3 (torchrun's variables), 13 whitelisted samples in batches of 4, at
  ``qual:backpack_human_contact`` and ``qual:backpack_occupancy``, against
  the port's single-process run and ``coma_tpu``'s sequential
  ``run_affordance_extraction`` on copies of one tree: contact fields at
  rtol 2e-5 / atol 1e-6, occupancy hits and ``used_count`` equal.
- ``aggregate_shards`` onto a non-zero carried state (2 ranks), with a rank
  whose every sample is rejected (3 ranks; the occupancy anchor must be the
  last valid sample's), and with a rank whose shard is empty (3 ranks),
  against sequential aggregation in the port and in ``coma_tpu``.

Every group of processes has its own timeout of 120 s.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.affordance.contact import contact_update_batch as j_contact_update
from coma_tpu.affordance.occupancy import occupancy_update_batch as j_occupancy_update
from coma_tpu.affordance.state import init_coma_state as j_init_coma
from coma_tpu.affordance.state import init_occupancy_state as j_init_occupancy
from coma_tpu.cli import downsample_objects as j_downsample_objects
from coma_tpu.config.hyperparams import get_hyperparams
from coma_tpu.geometry.mesh import save_obj
from coma_tpu.parallel.multihost import process_shard_worklist as j_shard
from coma_tpu.pipelines.downsample import downsample_human_template, save_human_downsample
from coma_tpu.pipelines.extract import run_affordance_extraction as j_extract
from coma_tpu.pipelines.postfilter import run_post_filtering
from coma_tpu_torch.affordance.contact import contact_update_batch
from coma_tpu_torch.affordance.occupancy import occupancy_update_batch
from coma_tpu_torch.ops import build
from coma_tpu_torch.parallel import distributed
from coma_tpu_torch.parallel.distributed import ADDITIVE_FIELDS, process_shard_worklist
from coma_tpu_torch.pipelines.extract import run_affordance_extraction as t_extract
from tests import test_torch_distributed_ranks as W
from tests.test_geometry import CUBE_F, CUBE_V
from tests.torch_mesh_ranks import TIMEOUT_S, free_port, spawn_command

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "test_torch_distributed_ranks.py")
TOL = dict(rtol=2e-5, atol=1e-6)
SC, CAT, ASSET = "BEHAVE", "backpack", "behave_asset"
PROMPT = "a person carrying a backpack"
N_SAMPLES = 13


def spawn(world, args, style):
    """``world`` processes of this file's rank script with ``style`` launch
    variables; returns each rank's JSON lines."""
    return spawn_command(world, [RANKS, *map(str, args)], style)


@pytest.mark.parametrize("world", range(1, 9))
def test_process_shard_worklist_matches_coma_tpu(world):
    for n in range(14):
        items = list(range(n))
        shards = [process_shard_worklist(items, r, world) for r in range(world)]
        assert shards == [j_shard(items, r, world) for r in range(world)]
        assert [x for s in shards for x in s] == items


def test_launch_config_reads_torchrun_then_coma_variables():
    assert distributed.launch_config({}) is None
    torchrun = dict(RANK="2", WORLD_SIZE="4", LOCAL_RANK="0", MASTER_ADDR="h", MASTER_PORT="9")
    assert distributed.launch_config(torchrun) == ("h:9", 4, 2, 0)
    coma = dict(COMA_COORDINATOR="h:7", COMA_NUM_PROCESSES="3", COMA_PROCESS_ID="1")
    assert distributed.launch_config(coma) == ("h:7", 3, 1, 1)
    with pytest.raises(ValueError, match="COMA_PROCESS_ID"):
        distributed.launch_config(dict(COMA_COORDINATOR="h:7", COMA_NUM_PROCESSES="3"))


def test_initialize_rules(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "COMA_COORDINATOR", "COMA_NUM_PROCESSES",
                "COMA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    ctx = distributed.initialize("gloo", "cpu")    # no variables: one process
    assert (ctx.rank, ctx.world_size, ctx.backend, ctx.device.type) == (0, 1, None, "cpu")
    distributed.shutdown(ctx)
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.initialize("nccl", "cuda")


# ---------------------------------------------------------------------------
# the extraction CLI over 2 and 3 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_tree(tmp_path_factory):
    """13 whitelisted cube humans over a cube asset, one low-IoU sample and
    one sentinel; filtered, object-downsampled (180, 1500) and with the FULL
    human downsample, by ``coma_tpu``'s stages."""
    tmp = tmp_path_factory.mktemp("dist_tree")
    rng = np.random.default_rng(0)
    base = tmp / "results" / "generation" / "human_sample" / SC / CAT / ASSET
    for k in range(N_SAMPLES + 2):
        d = base / f"{k // 5:03d}" / "0" / PROMPT
        d.mkdir(parents=True, exist_ok=True)
        verts = CUBE_V * 0.5 + [0.25, 0.25, 1.0] + rng.normal(scale=0.01, size=CUBE_V.shape)
        payload = dict(verts=verts, faces=CUBE_F, IoU=0.1 if k == N_SAMPLES else 0.9,
                       interscetion_ratio=0.01, num_inliers=5)
        with open(d / f"{k % 5:05d}.pickle", "wb") as fh:
            pickle.dump("NO HUMANS" if k == N_SAMPLES + 1 else payload, fh)
    constants = tmp / "constants"
    save_human_downsample(downsample_human_template(CUBE_V, CUBE_F, 100), 100, str(constants))
    obj = str(tmp / "asset.obj")
    save_obj(obj, CUBE_V, CUBE_F)
    results = str(tmp / "results")
    stats = run_post_filtering(results_root=results, save_dir=f"{results}/coma/human_postfilterings",
                               verbose=False)
    assert stats["leftover"] == N_SAMPLES
    for n in (180, 1500):
        j_downsample_objects.main(["--obj_pth", obj, "--supercategory", SC, "--category", CAT,
                                   "--asset_id", ASSET, "--number_of_points", str(n),
                                   "--save_dir", f"{results}/coma/asset_downsample"])
    return tmp


def pickle_of(root, key):
    path = f"{root}/coma/extracted_coma/{SC}/{CAT}/{ASSET}/{key}:{PROMPT}.pickle"
    with open(path, "rb") as fh:
        return pickle.load(fh)


def assert_contact_close(got, want):
    for f in ADDITIVE_FIELDS["ComAState"][:-1] + ("canon_normal_grid",):
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)
    assert got["used_count"] == want["used_count"] == N_SAMPLES


def assert_occupancy_equal(got, want):
    np.testing.assert_array_equal(got["spatial_occupancy_grids"], want["spatial_occupancy_grids"])
    assert got["used_count"] == want["used_count"] == N_SAMPLES
    np.testing.assert_array_equal(got["debug_obj_vert"], want["debug_obj_vert"])
    assert got["spatial_occupancy_grids"].sum() > 0


@pytest.fixture(scope="module")
def sequential_runs(base_tree, tmp_path_factory):
    """Both keys extracted in one process by the port (batches of 4) and by
    coma_tpu, each on its copy of the tree; returns their results roots."""
    tmp = tmp_path_factory.mktemp("sequential")
    roots = {name: str(tmp / name / "results") for name in ("single", "jax")}
    for root in roots.values():
        shutil.copytree(base_tree / "results", root)
    for key in (W.CONTACT_KEY, W.OCCUPANCY_KEY):
        common = dict(hyperparams=get_hyperparams(key), hyperparams_key=key,
                      constants_mesh_dir=str(base_tree / "constants"), verbose=False)
        t_extract(results_root=roots["single"], device="cpu", batch_size=4, **common)
        j_extract(results_root=roots["jax"], **common)
    return roots


@pytest.mark.parametrize("world,style", [(2, "coma"), (3, "torchrun")])
def test_multi_rank_extraction_matches_sequential(base_tree, sequential_runs, tmp_path, world,
                                                  style):
    roots = dict(sequential_runs, ranks=str(tmp_path / "ranks" / "results"))
    shutil.copytree(base_tree / "results", roots["ranks"])
    constants = str(base_tree / "constants")
    reports = spawn(world, ["extract", tmp_path, roots["ranks"], constants, free_port()], style)

    # every rank reports both runs, each with its own shard of the 13 samples
    for rank, lines in enumerate(reports):
        runs = [l["extract_rank"] for l in lines if "extract_rank" in l]
        assert [(r["rank"], r["world_size"], r["backend"]) for r in runs] \
            == [(rank, world, "gloo")] * 2
        assert runs[0]["allreduce_bytes"] > 0 and runs[0]["peak_device_gb"] is None
        assert runs[0]["wait_ms"] >= 0 and runs[0]["allreduce_ms"] > 0
        assert runs[0]["launches"]["flash_attention"] == 0
    for key, check in ((W.CONTACT_KEY, assert_contact_close),
                       (W.OCCUPANCY_KEY, assert_occupancy_equal)):
        ranks = pickle_of(roots["ranks"], key)
        check(ranks, pickle_of(roots["single"], key))
        check(ranks, pickle_of(roots["jax"], key))
    # rank 0 alone wrote the products
    products = os.path.join(roots["ranks"], "coma", "affordance", SC, CAT, ASSET)
    assert sorted(os.listdir(products)) == sorted(f"{k}:{PROMPT}" for k in
                                                  (W.CONTACT_KEY, W.OCCUPANCY_KEY))


def test_learn_coma_multihost_matches_one_process(base_tree, sequential_runs, tmp_path):
    """learn_coma on 2 ranks: rank 0 filters and downsamples, both extract."""
    shutil.copytree(base_tree / "results", tmp_path / "ranks" / "results")
    for sub in ("human_postfilterings", "asset_downsample"):   # rank 0 writes them anew
        shutil.rmtree(tmp_path / "ranks" / "results" / "coma" / sub)
    reports = spawn(2, ["learn_coma", tmp_path, tmp_path / "ranks", base_tree / "constants",
                        base_tree / "asset.obj"], "coma")
    assert [len([l for l in lines if "extract_rank" in l]) for lines in reports] == [2, 2]
    for key, check in ((W.CONTACT_KEY, assert_contact_close),
                       (W.OCCUPANCY_KEY, assert_occupancy_equal)):
        check(pickle_of(tmp_path / "ranks" / "results", key),
              pickle_of(sequential_runs["single"], key))


# ---------------------------------------------------------------------------
# aggregate_shards: carried state, a rank of rejected samples, an empty shard
# ---------------------------------------------------------------------------

def sequential(name):
    """The scenario's samples aggregated in order, in the port (plain
    versions) and in coma_tpu, onto the same carried state."""
    items, rejected, carried = W.SCENARIOS[name]
    samples = [s for i, s in zip(items, W.make_samples(len(items), seed=7)) if i not in rejected]
    stack = lambda ss, f: np.stack([d[f] for d in ss])
    contact, occupancy = W.fresh_states()
    jc = j_init_coma(W.H, W.O, W.N, 0.07, 0.5, 0.25, eps=1e-10)
    jo = j_init_occupancy(W.H, W.O, W.R, scale_tolerance=3.0)
    batches = ([W.make_samples(5, seed=99)] if carried else []) + [samples]
    for ss in batches:
        t = lambda f: torch.from_numpy(stack(ss, f))
        contact_update_batch(contact, t("human_verts"), t("human_normals"), t("obj_verts"),
                             t("obj_normals"))
        occupancy_update_batch(occupancy, t("human_verts"), t("obj_verts"))
        j = lambda f: jnp.asarray(stack(ss, f))
        jc = j_contact_update(jc, j("human_verts"), j("human_normals"), j("obj_verts"),
                              j("obj_normals"))
        jo = j_occupancy_update(jo, j("human_verts"), j("obj_verts"))
    port = W.state_arrays(contact, occupancy)
    ref = {k: np.asarray(getattr(jc if k.startswith("contact") else jo, k.split(".")[1]))
           for k in port}
    return len(samples), port, ref


@pytest.mark.parametrize("name,world", [("carried", 2), ("sentinel_rank", 3), ("empty_shard", 3)])
def test_aggregate_shards_matches_sequential(tmp_path, name, world):
    reports = spawn(world, [name, tmp_path], "coma")
    n_valid, port, ref = sequential(name)
    got = np.load(tmp_path / f"{name}.npz")
    assert list(got["n"]) == [n_valid, n_valid]
    assert [r[0]["rank"]["samples"] for r in reports] == [[n_valid, n_valid]] * world
    for want in (port, ref):
        for k, v in want.items():
            if k.startswith("contact.") and not k.endswith("used_count"):
                np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
            else:   # hit counts, used counts and the anchor: equal
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not np.isnan(got["occupancy.anchor_vert"]).any()
    assert got["occupancy.used_count"] == n_valid + (5 if name == "carried" else 0)


# ---------------------------------------------------------------------------
# kernel builds from several processes at once
# ---------------------------------------------------------------------------

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    for i in range(20):
        print(f"ptxas info    : pid {{os.getpid()}} line {{i}}", flush=True)
        time.sleep(0.01)
    open(out, "wb").write(b"library")
""")

BUILDER = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from coma_tpu_torch.ops import build
    build.BUILD_DIR = Path(sys.argv[1])
    build.nvcc_path = lambda: sys.argv[2]
    build.build_all(["contact_splat"])
""")


def test_concurrent_builds_keep_one_process_log(tmp_path):
    """Two processes build one source at once: the library and the log are
    each one process's whole output, renamed into place."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=REPO)
    out_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(out_dir), str(nvcc)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    log = (out_dir / "contact_splat.log").read_text().splitlines()
    assert len(log) == 20 and len({line.split()[4] for line in log}) == 1
    libs = sorted(p.name for p in out_dir.iterdir())
    assert libs == ["contact_splat.log", build.library_path("contact_splat").name]


FAILING_NVCC = textwrap.dedent("""\
    #!{python}
    print("error: this build fails")
    raise SystemExit(1)
""")


def test_failed_build_leaves_its_log_and_no_temporary(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output, which replaces an
    earlier build's log; neither its temporary log nor library stays."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAILING_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    build.BUILD_DIR.mkdir()
    build.log_path("contact_splat").write_text("ptxas info    : an earlier build\n")
    with pytest.raises(RuntimeError, match="this build fails"):
        build.build_all(["contact_splat"])
    assert build.log_path("contact_splat").read_text() == "error: this build fails\n"
    assert [p.name for p in build.BUILD_DIR.iterdir()] == ["contact_splat.log"]
