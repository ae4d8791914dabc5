"""``--mesh`` for the inpainting CLI: whole batches, round-robin over ranks.

Counterpart of ``coma_tpu/parallel/flagship.py``. There, ``--mesh N`` shards
each batch over N devices of one program, and ``pad_ragged_batch`` repeats
the last image until the batch divides over them; the noise is then drawn at
the padded batch's shape, so a ragged batch's images differ from the
one-device run's. Here ``--mesh N`` means N ranks, one process per card
(several may share a card under gloo), launched with torchrun's variables
or ``coma_tpu``'s (``parallel/distributed.py``). Batch j of the work list
goes whole to rank j mod N: it keeps its items and its seed (``seed ·
1000003 + inpaint_id`` of its first item), so every image equals the
one-process run's, and nothing is sliced or padded.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

from coma_tpu_torch.parallel.distributed import launch_config


def resolve_mesh(spec: Optional[str], environ: Mapping[str, str] = os.environ) -> int:
    """The ``--mesh`` value against the launch: the number of ranks.
    ``None`` or ``"1"`` is one process, ``"all"`` the launch's world size, an
    integer must equal it. A launch of several ranks without ``--mesh``, or
    of another size than ``--mesh`` asks for, raises ``SystemExit``."""
    config = launch_config(environ)
    world = 1 if config is None else config[1]
    if spec is None or spec == "all":
        n = 1 if spec is None else world
    elif spec.isdigit() and int(spec) >= 1:
        n = int(spec)
    else:
        raise SystemExit(f"--mesh takes 'all' or a number of ranks, not {spec!r}")
    if n != world:
        given = "no --mesh" if spec is None else f"--mesh {spec}"
        raise SystemExit(
            f"{given} but this launch has {world} rank(s): start {n} processes with "
            "torchrun (or COMA_COORDINATOR, COMA_NUM_PROCESSES, COMA_PROCESS_ID), "
            "one per card under nccl")
    return n


def rank_batches(n_items: int, batch_size: int, rank: int, world_size: int) -> range:
    """Start indices of this rank's batches: batch j (items ``j·batch_size``
    on) goes to rank ``j mod world_size``."""
    return range(rank * batch_size, n_items, batch_size * world_size)
