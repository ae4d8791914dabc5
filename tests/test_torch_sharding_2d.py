"""The port's 2-D ComA aggregation (``parallel/sharding.py``) and
``quat_to_rotmat`` against ``coma_tpu``'s (ROADMAP item 8a), on the CPU.

- ``sharded_contact_aggregate_2d`` on 4 gloo ranks as 2 data x 2 model
  (``tests/torch_mesh_ranks.py``), gathered onto rank 0, against
  ``coma_tpu``'s on ``mesh_2d(2, 2)`` of the 8 virtual devices: 5 samples
  (n_data does not divide them), one of them a padded slot (valid 0), a
  zero human normal; rtol 2e-5 / atol 1e-6, ``used_count`` equal. The same
  function on one process (a 1 x 1 grid) against ``coma_tpu``'s too.
- ``round_up``, ``pad_batch`` and ``shard_state_over_h`` against
  ``coma_tpu``'s (equal arrays: both copy).
- ``quat_to_rotmat`` within 1e-6, a zero quaternion included.

The 4-rank group has its own timeout of 120 s.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from coma_tpu.affordance.contact import contact_update_batch as j_update
from coma_tpu.affordance.state import init_coma_state as j_init
from coma_tpu.geometry.transforms import quat_to_rotmat as j_quat
from coma_tpu.parallel import sharding as j_sharding
from coma_tpu_torch.affordance.state import init_coma_state
from coma_tpu_torch.geometry import quat_to_rotmat
from coma_tpu_torch.parallel import distributed, sharding
from coma_tpu_torch.parallel.distributed import ADDITIVE_FIELDS
from tests.torch_mesh_ranks import REPO, spawn_command

RANKS = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
TOL = dict(rtol=2e-5, atol=1e-6)
B, H, O, N = 5, 12, 9, 50
PARAMS = (0.07, 0.5, 0.25)     # proximity scale, significance threshold, sigma
VALID = np.float32([1, 1, 0, 1, 1])


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def samples(seed=0):
    rng = np.random.default_rng(seed)
    hn = unit(rng.normal(size=(B, H, 3)))
    hn[:, 3] = 0.0                                   # a zero normal
    return dict(hv=np.float32(rng.normal(size=(B, H, 3)) * 0.2), hn=np.float32(hn),
                ov=np.float32(rng.normal(size=(B, O, 3)) * 0.2),
                on=np.float32(unit(rng.normal(size=(B, O, 3)))))


def coma_tpu_2d(s, n_data, n_model):
    out = j_sharding.sharded_contact_aggregate_2d(
        j_init(H, O, N, *PARAMS), *(jnp.asarray(s[k]) for k in ("hv", "hn", "ov", "on")),
        j_sharding.mesh_2d(n_data, n_model), valid=jnp.asarray(VALID))
    return {f: np.asarray(getattr(out, f)) for f in ADDITIVE_FIELDS["ComAState"]}


def test_aggregate_2d_on_four_ranks_matches_coma_tpu(tmp_path):
    s = samples()
    np.savez(tmp_path / "in.npz", hon=np.int64([H, O, N]), params=np.float64(PARAMS),
             valid=VALID, **s)
    reports = spawn_command(4, [RANKS, "aggregate_2d", tmp_path / "in.npz",
                                tmp_path / "out.npz", 2, 2, "cpu"], "torchrun")
    places = sorted((r[0]["rank"]["data"], r[0]["rank"]["model"], r[0]["rank"]["rows"])
                    for r in reports)
    assert places == [(0, 0, 6), (0, 1, 6), (1, 0, 6), (1, 1, 6)]
    # each rank all-reduces its own rows of the five grids and the count, over data only
    row_bytes = (2 * O * N + 3 * O) * 4 * (H // 2) + 4
    assert all(r[0]["rank"]["allreduce_bytes"] == row_bytes for r in reports)
    want = coma_tpu_2d(s, 2, 2)
    with np.load(tmp_path / "out.npz") as got:
        for f in ADDITIVE_FIELDS["ComAState"]:
            np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)
        assert float(got["used_count"]) == float(want["used_count"]) == 4.0
        assert np.isfinite(got["prob_grid_canon_human_wrt_obj"]).all()


def test_aggregate_2d_on_one_process_matches_coma_tpu():
    s = samples(1)
    ctx = distributed.DistContext(0, 1, 0, None, torch.device("cpu"))
    grid = sharding.grid_2d(ctx, 1, 1)
    state = sharding.shard_state_over_h(init_coma_state(H, O, N, *PARAMS, device="cpu"), 0, 1)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    sharding.sharded_contact_aggregate_2d(state, t["hv"], t["hn"], t["ov"], t["on"], grid,
                                          valid=torch.from_numpy(VALID))
    assert sharding.gather_over_h(state, grid) is state
    want = coma_tpu_2d(s, 1, 1)
    for f in ADDITIVE_FIELDS["ComAState"]:
        np.testing.assert_allclose(getattr(state, f).numpy(), want[f], err_msg=f, **TOL)


def test_aggregate_2d_refuses_h_that_does_not_divide():
    ctx = distributed.DistContext(0, 1, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide over model=5"):
        sharding.shard_state_over_h(init_coma_state(H, O, N, *PARAMS, device="cpu"), 0, 5)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        sharding.grid_2d(ctx, 2, 2)


def test_round_up_and_pad_batch_match_coma_tpu():
    for n in range(12):
        for m in (1, 2, 3, 8):
            assert sharding.round_up(n, m) == j_sharding.round_up(n, m)
    rng = np.random.default_rng(2)
    arrays = [np.float32(rng.normal(size=(3, 4, 3))), np.float32(rng.normal(size=(3,)))]
    for size in (3, 4, 8):
        got, got_valid = sharding.pad_batch([torch.from_numpy(a) for a in arrays], size)
        want, want_valid = j_sharding.pad_batch([jnp.asarray(a) for a in arrays], size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("parts", [2, 4])
def test_shard_state_over_h_matches_coma_tpu(parts):
    s = samples(3)
    j_state = j_update(j_init(H, O, N, *PARAMS), *(jnp.asarray(s[k])
                                                  for k in ("hv", "hn", "ov", "on")))
    full = dataclasses.replace(init_coma_state(H, O, N, *PARAMS, device="cpu"), **{
        f: torch.from_numpy(np.array(getattr(j_state, f))) for f in ADDITIVE_FIELDS["ComAState"]})
    placed = j_sharding.shard_state_over_h(j_state, Mesh(np.array(jax.devices()[:parts]),
                                                         ("data",)))
    for part in range(parts):
        mine = sharding.shard_state_over_h(full, part, parts)
        assert mine.human_res == H // parts
        for f in sharding.H_FIELDS[:5]:
            shards = {s.index[0].start or 0: np.asarray(s.data)
                      for s in getattr(placed, f).addressable_shards}
            np.testing.assert_array_equal(getattr(mine, f).numpy(), shards[part * H // parts])
        assert torch.equal(mine.used_count, full.used_count)


def test_quat_to_rotmat_matches_coma_tpu():
    rng = np.random.default_rng(4)
    q = np.float32(rng.normal(size=(6, 5, 4)))
    q[0, 0] = 0.0
    q[1, 2] = (1e-9, 0.0, 0.0, 0.0)
    got = quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_quat(jnp.asarray(q))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 0], np.eye(3, dtype=np.float32))
    rot = got[2:].reshape(-1, 3, 3)
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
