"""``--mesh`` inpainting in the port (``parallel/flagship.py``,
``cli/inpaint.py``; ROADMAP item 13d) on the CPU.

- ``--mesh 2`` on two gloo ranks (torchrun's variables) against the
  one-process run of the same work: ``--tiny --random_weights``, 5 items
  (``--num_img_per_combination 6``, then ``--parallel_num 2 --parallel_idx
  1`` of the 12) at ``--batch_size 2``, so the last batch is ragged, with
  ``--save_step_video``. Every PNG and every step GIF byte-equal. Both runs
  are subprocesses with one thread, each with a timeout of 240 s.
- ``resolve_mesh`` against the launch, ``rank_batches`` over every batch
  once, and nccl on the CPU raising before any process group exists.
"""
import os

import pytest

from coma_tpu_torch.cli import inpaint as t_cli
from coma_tpu_torch.parallel.flagship import rank_batches, resolve_mesh
from tests.torch_mesh_ranks import spawn_command
from tests.test_torch_inpaint import make_tree

ARGV = ["-m", "coma_tpu_torch.cli.inpaint", "--device", "cpu", "--tiny", "--random_weights",
        "--num_img_per_combination", "6", "--parallel_num", "2", "--parallel_idx", "1",
        "--batch_size", "2", "--save_step_video"]


def outputs(root):
    base = os.path.join(root, "results", "generation", "inpaintings")
    found = {}
    for d, _, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                found[os.path.relpath(os.path.join(d, f), base)] = fh.read()
    return found


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"one": files of the one-process run, "mesh": files of --mesh 2}."""
    got = {}
    for name, world, extra in (("one", 1, []),
                               ("mesh", 2, ["--mesh", "2", "--dist_backend", "gloo"])):
        root = tmp_path_factory.mktemp(name)
        make_tree(root)
        spawn_command(world, ARGV + extra, None if world == 1 else "torchrun", cwd=root,
                      timeout=240)
        got[name] = outputs(root)
    return got


def test_mesh_two_ranks_write_the_one_process_pngs(runs):
    pngs = {k: v for k, v in runs["one"].items() if not k.endswith(".steps.gif")}
    assert len(pngs) == 5
    assert {k: v for k, v in runs["mesh"].items() if not k.endswith(".steps.gif")} == pngs


def test_mesh_two_ranks_write_the_one_process_step_videos(runs):
    gifs = {k: v for k, v in runs["one"].items() if k.endswith(".steps.gif")}
    assert len(gifs) == 3                      # one per batch: 2 + 2 + 1 items
    assert {k: v for k, v in runs["mesh"].items() if k.endswith(".steps.gif")} == gifs


TORCHRUN = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="h", MASTER_PORT="9")


@pytest.mark.parametrize("spec,env,want", [
    (None, {}, 1), ("1", {}, 1), ("all", {}, 1), ("all", TORCHRUN, 2), ("2", TORCHRUN, 2),
    ("3", dict(COMA_COORDINATOR="h:7", COMA_NUM_PROCESSES="3", COMA_PROCESS_ID="0"), 3),
    ("2", {}, "--mesh 2 but this launch has 1 rank"),
    ("all", dict(COMA_COORDINATOR="h:7"), "set all of"),
    ("3", TORCHRUN, "--mesh 3 but this launch has 2 rank"),
    (None, TORCHRUN, "no --mesh but this launch has 2 rank"),
    ("1", TORCHRUN, "--mesh 1 but this launch has 2 rank"),
    ("0", {}, "takes 'all' or a number of ranks"), ("two", {}, "takes 'all'"),
])
def test_resolve_mesh_against_the_launch(spec, env, want):
    if isinstance(want, int):
        assert resolve_mesh(spec, env) == want
    else:
        with pytest.raises((SystemExit, ValueError), match=want):
            resolve_mesh(spec, env)


@pytest.mark.parametrize("n,batch,world", [(5, 2, 2), (12, 4, 3), (3, 4, 2), (0, 2, 2),
                                           (16, 1, 4)])
def test_rank_batches_cover_each_batch_once(n, batch, world):
    starts = [list(rank_batches(n, batch, r, world)) for r in range(world)]
    assert sorted(s for rank in starts for s in rank) == list(range(0, n, batch))
    for r, rank in enumerate(starts):
        assert all((s // batch) % world == r for s in rank)


def test_nccl_on_the_cpu_raises_before_a_group(tmp_path, monkeypatch):
    for var, value in dict(TORCHRUN, MASTER_ADDR="localhost").items():
        monkeypatch.setenv(var, value)
    make_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="nccl backend needs the card"):
        t_cli.main(["--device", "cpu", "--tiny", "--random_weights", "--mesh", "2"])
