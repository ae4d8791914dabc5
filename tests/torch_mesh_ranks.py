"""The rank processes of ``tests/test_torch_sharding_2d.py``, of the
distributed ``make_step`` case of ``tests/test_torch_segmenter_training.py``
and of the 2-D card case of ``tests/test_torch_cuda.py``, and
:func:`spawn_command`, which the multi-process tests launch ranks with; it
holds no test of its own. Each process of a case runs::

    python tests/torch_mesh_ranks.py aggregate_2d IN.npz OUT.npz N_DATA N_MODEL DEVICE
    python tests/torch_mesh_ranks.py seg_step IN.npz OUT.npz

with the launch variables in its environment, under gloo (the aggregation
on DEVICE, ``cpu`` or ``cuda``; the step on the CPU). IN holds the seeded
inputs the test made; rank 0 writes OUT. Every rank prints
one ``{"rank": ...}`` JSON line. This module imports no JAX, so that the
ranks start fast.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

SCHEDULE = (1e-3, 3e-3, 2, 10, 1e-4)     # as tests/test_torch_segmenter_training.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_command(world, argv, style=None, cwd=None, timeout=TIMEOUT_S):
    """``world`` processes of ``python argv`` with ``style`` launch variables
    (``"coma"`` or ``"torchrun"``; none for one process without ``style``);
    returns each rank's JSON lines. Kills them all past the timeout."""
    port = free_port()
    procs = []
    for rank in range(world):
        # one thread a rank: the work is tiny, and the test shares the host
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                    "COMA_COORDINATOR", "COMA_NUM_PROCESSES", "COMA_PROCESS_ID"):
            env.pop(var, None)
        if style == "coma":
            env.update(COMA_COORDINATOR=f"localhost:{port}", COMA_NUM_PROCESSES=str(world),
                       COMA_PROCESS_ID=str(rank))
        elif style is not None:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, *map(str, argv)], env=env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n\n".join(outs)
    lines = []
    for out in outs:
        lines.append([json.loads(l) for l in out.splitlines() if l.startswith("{")])
    return lines


def aggregate_2d(ctx, inp, out, n_data, n_model):
    """The 2-D aggregation of IN's samples into a fresh state of IN's
    hyperparameters on the rank's device (K1 on the card); rank 0 writes
    the gathered accumulators."""
    from coma_tpu_torch.affordance.state import init_coma_state
    from coma_tpu_torch.ops import contact_kernel
    from coma_tpu_torch.parallel import distributed, sharding

    with np.load(inp) as f:
        a = {k: f[k] for k in f.files}
    H, O, N = (int(x) for x in a["hon"])
    size, thres, sigma = (float(x) for x in a["params"])
    grid = sharding.grid_2d(ctx, n_data, n_model)
    state = sharding.shard_state_over_h(init_coma_state(H, O, N, size, thres, sigma,
                                                        device=ctx.device), grid.model, n_model)
    t = lambda k: torch.from_numpy(a[k]).to(ctx.device)
    contact_kernel.launches = 0
    sharding.sharded_contact_aggregate_2d(state, t("hv"), t("hn"), t("ov"), t("on"), grid,
                                          valid=t("valid"))
    launches = contact_kernel.launches
    rows = state.human_res
    full = sharding.gather_over_h(state, grid)
    if ctx.is_root:
        np.savez(out, **{f: getattr(full, f).cpu().numpy()
                         for f in distributed.ADDITIVE_FIELDS["ComAState"]})
    return dict(rows=rows, data=grid.data, model=grid.model, launches=launches,
                allreduce_bytes=ctx.allreduce_bytes)


def seg_step(ctx, inp, out):
    """Three distributed steps of ``SegTrainer.make_step(ctx)`` from IN's
    parameters on IN's global batches; rank 0 writes the losses and the
    parameters after the first and third steps."""
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.models.segmentation_train import SegTrainer
    from coma_tpu_torch.optim import warmup_cosine_decay_schedule

    with np.load(inp) as f:
        a = {k: f[k] for k in f.files}
    model = PersonSegmenter()
    model.load_state_dict({k[len("p."):]: torch.from_numpy(v) for k, v in a.items()
                           if k.startswith("p.")})
    trainer = SegTrainer(model, warmup_cosine_decay_schedule(*SCHEDULE), weight_decay=1e-4)
    step = trainer.make_step(ctx)
    losses, saved = [], {}
    for i in range(a["images"].shape[0]):
        losses.append(float(step(torch.from_numpy(a["images"][i]),
                                 torch.from_numpy(a["masks"][i]))))
        if i in (0, 2):
            saved.update({f"step{i}.{k}": v.detach().numpy().copy()
                          for k, v in model.state_dict().items()})
    if ctx.is_root:
        np.savez(out, losses=np.float64(losses), **saved)
    return dict(losses=losses)


def main(argv):
    from coma_tpu_torch.parallel import distributed

    task, inp, out, *rest = argv
    ctx = distributed.initialize("gloo", rest[2] if task == "aggregate_2d" else "cpu")
    try:
        if task == "aggregate_2d":
            report = aggregate_2d(ctx, inp, out, int(rest[0]), int(rest[1]))
        else:
            report = seg_step(ctx, inp, out)
        print(json.dumps({"rank": dict(rank=ctx.rank, world_size=ctx.world_size, **report)}),
              flush=True)
    finally:
        distributed.shutdown(ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
