"""The rank processes of ``tests/test_torch_distributed.py``; it holds no
test of its own. Each process of a multi-rank case runs this file:

    python tests/test_torch_distributed_ranks.py extract OUT RESULTS_ROOT CONSTANTS PORT2
    python tests/test_torch_distributed_ranks.py learn_coma OUT TREE CONSTANTS OBJ
    python tests/test_torch_distributed_ranks.py {carried,sentinel_rank,empty_shard} OUT

The launch variables (``COMA_*`` or torchrun's) come from the environment;
everything runs on the CPU under gloo. ``extract`` drives the extraction CLI
twice (contact, then occupancy, each with a process group of its own, the
second on PORT2); ``learn_coma`` drives that CLI in TREE (its host stages on
rank 0, both extractions on every rank in one process group); the other
scenarios call ``aggregate_shards`` on seeded samples and rank 0 writes the
states to ``OUT/<scenario>.npz``. Every rank prints its ``extract_rank`` or
``rank`` JSON line. This module imports no JAX, so that the ranks start fast.
"""
import json
import os
import sys

import numpy as np

H, O, N, R = 12, 9, 50, 6
CONTACT_KEY, OCCUPANCY_KEY = "qual:backpack_human_contact", "qual:backpack_occupancy"


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def make_samples(n, seed):
    """``n`` seeded samples; the object moves per sample, so every sample
    has its own occupancy anchor."""
    rng = np.random.default_rng(seed)
    return [dict(
        human_verts=np.float32(rng.normal(size=(H, 3)) * 0.2),
        human_normals=np.float32(unit(rng.normal(size=(H, 3)))),
        obj_verts=np.float32(rng.normal(size=(O, 3)) * 0.2 + rng.normal(size=3) * 0.05),
        obj_normals=np.float32(unit(rng.normal(size=(O, 3)))),
    ) for _ in range(n)]


# scenario -> (sample items, items prepared as None, carried state)
SCENARIOS = {
    "carried": (list(range(13)), set(), True),
    "sentinel_rank": (list(range(13)), {5, 6, 7, 8, 9}, False),  # rank 1 of 3: all rejected
    "empty_shard": (list(range(2)), set(), False),                # rank 2 of 3: no item
}


def fresh_states(device="cpu"):
    from coma_tpu_torch.affordance.state import init_coma_state, init_occupancy_state

    return (init_coma_state(H, O, N, 0.07, 0.5, 0.25, eps=1e-10, device=device),
            init_occupancy_state(H, O, R, scale_tolerance=3.0, device=device))


def carry(contact, occupancy):
    """A non-zero carried state: five other samples aggregated sequentially."""
    import torch

    from coma_tpu_torch.affordance.contact import contact_update_batch
    from coma_tpu_torch.affordance.occupancy import occupancy_update_batch

    s = make_samples(5, seed=99)
    stack = lambda f: torch.from_numpy(np.stack([d[f] for d in s]))
    contact_update_batch(contact, stack("human_verts"), stack("human_normals"),
                         stack("obj_verts"), stack("obj_normals"))
    occupancy_update_batch(occupancy, stack("human_verts"), stack("obj_verts"))


def state_arrays(contact, occupancy):
    from coma_tpu_torch.parallel.distributed import ADDITIVE_FIELDS

    out = {f"contact.{f}": getattr(contact, f).numpy() for f in ADDITIVE_FIELDS["ComAState"]}
    out.update({f"occupancy.{f}": getattr(occupancy, f).numpy()
                for f in ADDITIVE_FIELDS["OccupancyState"]})
    out["occupancy.anchor_vert"] = occupancy.anchor_vert.numpy()
    return out


def run_scenario(name, out):
    from coma_tpu_torch.parallel import distributed
    from coma_tpu_torch.pipelines.extract import aggregate_shards

    items, rejected, carried = SCENARIOS[name]
    samples = make_samples(len(items), seed=7)
    prepare = lambda i: None if i in rejected else samples[i]
    ctx = distributed.initialize("gloo", "cpu")
    try:
        contact, occupancy = fresh_states()
        if carried:
            carry(contact, occupancy)
        contact, n_contact = aggregate_shards(contact, items, prepare, False, ctx, batch_size=4)
        occupancy, n_occ = aggregate_shards(occupancy, items, prepare, True, ctx, batch_size=4)
        if ctx.is_root:
            np.savez(os.path.join(out, f"{name}.npz"), n=np.array([n_contact, n_occ]),
                     **state_arrays(contact, occupancy))
        print(json.dumps({"rank": dict(rank=ctx.rank, world_size=ctx.world_size,
                                       samples=[n_contact, n_occ],
                                       allreduce_bytes=ctx.allreduce_bytes)}), flush=True)
    finally:
        distributed.shutdown(ctx)


def batches_of_four():
    """The extraction CLI with batches of 4 samples (32 in use), so that each
    rank's shard spans several batches."""
    import functools

    from coma_tpu_torch.cli import extract_coma

    extract_coma.run_affordance_extraction = functools.partial(
        extract_coma.run_affordance_extraction, batch_size=4)
    return extract_coma


def run_extract(root, constants, port2):
    extract_coma = batches_of_four()
    for key in (CONTACT_KEY, OCCUPANCY_KEY):
        extract_coma.main([
            "--human_sample_dir", f"{root}/generation/human_sample",
            "--constants_mesh_dir", constants, "--hyperparams_key", key,
            "--device", "cpu", "--multihost", "--dist_backend", "gloo",
        ])
        # the second CLI run builds its own process group on another port
        for var in ("MASTER_PORT", "COMA_COORDINATOR"):
            if var in os.environ:
                os.environ[var] = port2 if var == "MASTER_PORT" else f"localhost:{port2}"


def run_learn_coma(tree, constants, obj):
    from coma_tpu_torch.cli import learn_coma

    batches_of_four()
    os.chdir(tree)
    learn_coma.main([
        "--multihost", "--dist_backend", "gloo", "--device", "cpu",
        "--skip", "downsample_human", "--hyperparams_keys", CONTACT_KEY, OCCUPANCY_KEY,
        "--object_resolutions", "180", "1500", "--obj_pth", obj, "--supercategory", "BEHAVE",
        "--category", "backpack", "--asset_id", "behave_asset", "--constants_mesh_dir", constants,
    ])


if __name__ == "__main__":
    scenario, out_dir = sys.argv[1], sys.argv[2]
    if scenario == "extract":
        run_extract(*sys.argv[3:6])
    elif scenario == "learn_coma":
        run_learn_coma(*sys.argv[3:6])
    else:
        run_scenario(scenario, out_dir)
