"""Multi-process extraction over ``torch.distributed``.

Counterpart of ``coma_tpu/parallel/multihost.py`` (bootstrap, per-process
work list, cross-process sum of the accumulators) with the aggregation
semantics of ``coma_tpu/parallel/sharding.py:58-213`` (additive fields
summed once, the occupancy anchor combined, not summed). One process per
rank; each aggregates its shard of the sample list on its device, then the
additive accumulators are all-reduced and rank 0 writes the outputs.

Launch, per process, with either torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or
``coma_tpu``'s (``COMA_COORDINATOR`` host:port, ``COMA_NUM_PROCESSES``,
``COMA_PROCESS_ID``). The backend is the caller's choice and nothing
switches it: ``nccl`` takes one card per rank (``cuda:LOCAL_RANK``) and
reduces in place on the card; ``gloo`` may put several ranks on one card
(``cuda:LOCAL_RANK % device_count``) or on the CPU, and reduces through a
host copy of at most :data:`GLOO_CHUNK` elements at a time.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from coma_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
GLOO_CHUNK = 1 << 26   # elements per host copy (256 MB of float32)
GROUP_TIMEOUT = datetime.timedelta(minutes=30)   # a collective that waits longer fails

# the additive accumulators of each state; everything else (sphere grid,
# principal vectors, voxel centres) is identical on every rank and is not
# summed, and the occupancy anchor is combined by allreduce_state
ADDITIVE_FIELDS = {
    "ComAState": (
        "prob_grid_canon_human_wrt_obj",
        "prob_grid_canon_obj_wrt_human",
        "contact_dist_expectation_grid_nom",
        "contact_dist_expectation_grid_denom",
        "significant_contact_count",
        "used_count",
    ),
    "OccupancyState": ("spatial_occupancy_grids", "used_count"),
}


@dataclasses.dataclass
class DistContext:
    """One rank of a run: where it is, what it reduces with, and what its
    all-reduces have cost so far (host wall clock and payload bytes)."""

    rank: int
    world_size: int
    local_rank: int
    backend: Optional[str]       # None for a run of one process
    device: torch.device
    wait_ms: float = 0.0         # the sample count's all-reduce: waiting for the slowest rank
    allreduce_ms: float = 0.0    # the accumulators' all-reduces after it
    allreduce_bytes: int = 0

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def launch_config(environ: Mapping[str, str] = os.environ) -> Optional[Tuple[str, int, int, int]]:
    """(``host:port``, world size, rank, local rank) from torchrun's variables,
    else from ``COMA_*``; ``None`` when neither is set (one process)."""
    if "RANK" in environ and "WORLD_SIZE" in environ:
        address = f"{environ.get('MASTER_ADDR', 'localhost')}:{environ['MASTER_PORT']}"
        rank = int(environ["RANK"])
        return address, int(environ["WORLD_SIZE"]), rank, int(environ.get("LOCAL_RANK", rank))
    names = ("COMA_COORDINATOR", "COMA_NUM_PROCESSES", "COMA_PROCESS_ID")
    given = [n for n in names if n in environ]
    if not given:
        return None
    if len(given) != len(names):
        raise ValueError(f"set all of {names} (got {given})")
    rank = int(environ["COMA_PROCESS_ID"])
    return environ["COMA_COORDINATOR"], int(environ["COMA_NUM_PROCESSES"]), rank, rank


def _rank_device(base: torch.device, backend: str, local_rank: int) -> torch.device:
    if base.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs the card; on the CPU pass "
                             "--dist_backend gloo")
        return base
    count = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= count:
        raise ValueError(f"nccl takes one card per rank: local rank {local_rank} of "
                         f"{count} card(s); share a card with --dist_backend gloo")
    return torch.device("cuda", local_rank % count)


def initialize(backend: str = "nccl", device="cuda") -> DistContext:
    """Create the process group the launch variables describe and take this
    rank's device; a run of one process when no variable is set. The caller
    destroys the group with :func:`shutdown`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    base = resolve_device(device)
    config = launch_config()
    if config is None:
        ctx = DistContext(0, 1, 0, None, _rank_device(base, backend, 0))
    else:
        address, world, rank, local = config
        dev = _rank_device(base, backend, local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                                rank=rank, timeout=GROUP_TIMEOUT)
        ctx = DistContext(rank, world, local, backend, dev)
    where = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    print(f"[distributed] rank {ctx.rank} of {ctx.world_size} ({ctx.backend or 'one process'}) "
          f"on {ctx.device}: {where}", flush=True)
    return ctx


def shutdown(ctx: DistContext) -> None:
    """Destroy the process group :func:`initialize` created for ``ctx``."""
    if ctx.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


def barrier(ctx: DistContext) -> None:
    if ctx.world_size > 1:
        dist.barrier()


def process_shard_worklist(items: Sequence, rank: int, world_size: int) -> list:
    """Contiguous per-rank shard of a deterministically ordered work list:
    the reference's ``sub_length = len(X)//n + 1`` slicing
    (``inpaint.py:271-278``), as ``coma_tpu``'s multihost applies it. The
    last ranks may get nothing."""
    sub = len(items) // world_size + 1
    return list(items[rank * sub : (rank + 1) * sub])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flat_op(t: torch.Tensor, ctx: DistContext, op, write_back: bool = True) -> torch.Tensor:
    """``op`` on ``t`` viewed flat: in place under NCCL or on the CPU, and for
    a card tensor under gloo through host copies of at most
    :data:`GLOO_CHUNK` elements (copied back unless ``write_back`` is off)."""
    flat = t.view(-1)
    if ctx.backend == "nccl" or t.device.type == "cpu":
        op(flat)
        return t
    for start in range(0, flat.numel(), GLOO_CHUNK):
        part = flat[start : start + GLOO_CHUNK]
        host = part.cpu()
        op(host)
        if write_back:
            part.copy_(host)
    return t


def allreduce_(t: torch.Tensor, ctx: DistContext,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum ``t`` over the ranks (of ``group``, else all), in place."""
    if ctx.world_size == 1:
        return t
    return _flat_op(t, ctx, lambda x: dist.all_reduce(x, group=group))


def send(t: torch.Tensor, dst: int, ctx: DistContext) -> None:
    """Send ``t`` to rank ``dst``, which takes it with :func:`recv_`."""
    _flat_op(t, ctx, lambda x: dist.send(x, dst), write_back=False)


def recv_(t: torch.Tensor, src: int, ctx: DistContext) -> torch.Tensor:
    """Receive into ``t``, in place, what rank ``src`` sent with :func:`send`."""
    return _flat_op(t, ctx, lambda x: dist.recv(x, src))


def allreduce_state(state, ctx: DistContext, group: Optional[dist.ProcessGroup] = None):
    """Sum the additive accumulators of a ComA or occupancy state over the
    ranks (over ``group`` only, for a ComA state, when given), in place, and
    combine the occupancy anchor. Each rank must hold only its own
    contribution (the carried state on one rank, zeros on the others:
    :func:`zero_contribution`), or the carried state is counted once per
    rank.

    The anchor is the last valid sample's object vertex, so it is taken from
    the highest rank that holds one (a rank that saw no valid sample holds
    NaN): the sequential aggregation's anchor, since the shards are
    contiguous and in rank order. Where every rank's anchor is the same
    vertex, as in the extraction, this is ``sharding.py``'s rule (any
    non-NaN value; NaN only if every rank has NaN). Returns ``state``."""
    if ctx.world_size == 1:
        return state
    if group is not None and hasattr(state, "anchor_vert"):
        raise ValueError("the occupancy anchor is combined over all ranks, not a group")
    sync(state.device)
    t0 = time.perf_counter()
    for name in ADDITIVE_FIELDS[type(state).__name__]:
        t = getattr(state, name)
        allreduce_(t, ctx, group)
        ctx.allreduce_bytes += t.numel() * t.element_size()
    if hasattr(state, "anchor_vert"):
        state.anchor_vert = _combine_anchor(state.anchor_vert, ctx)
    sync(state.device)
    ctx.allreduce_ms += (time.perf_counter() - t0) * 1e3
    return state


def _combine_anchor(anchor: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The anchor of the highest rank whose anchor is not NaN, else NaN.
    Each rank fills its row of a (world, 4) float64 table (the anchor, and 1
    where it is set); the table is summed, which adds only zeros to a row."""
    coll = anchor.device if ctx.backend == "nccl" else torch.device("cpu")
    table = torch.zeros((ctx.world_size, 4), dtype=torch.float64, device=coll)
    if not torch.isnan(anchor).any():
        table[ctx.rank, :3] = anchor.to(coll, torch.float64)
        table[ctx.rank, 3] = 1.0
    dist.all_reduce(table)
    set_ranks = torch.nonzero(table[:, 3] > 0).flatten()
    if len(set_ranks) == 0:
        return torch.full_like(anchor, float("nan"))
    return table[int(set_ranks[-1]), :3].to(anchor.device, anchor.dtype)


def zero_contribution(state, keep: bool):
    """Unless ``keep`` (true on the one rank of a reduction that carries the
    state), make ``state`` a zero contribution, in place: its additive
    accumulators 0 and its anchor unset, so that after
    :func:`allreduce_state` the carried state counts once. Returns
    ``state``."""
    if not keep:
        for name in ADDITIVE_FIELDS[type(state).__name__]:
            getattr(state, name).zero_()
        if hasattr(state, "anchor_vert"):
            state.anchor_vert = torch.full_like(state.anchor_vert, float("nan"))
    return state


def allreduce_count(n: int, ctx: DistContext) -> int:
    """The sum of an integer count over the ranks. Called as the first
    collective after a rank's own work, its 8 bytes return when the slowest
    rank arrives, so its time is this rank's wait (``ctx.wait_ms``)."""
    if ctx.world_size == 1:
        return n
    sync(ctx.device)
    t0 = time.perf_counter()
    coll = ctx.device if ctx.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([float(n)], dtype=torch.float64, device=coll)
    dist.all_reduce(t)
    n = int(t.item())
    ctx.wait_ms += (time.perf_counter() - t0) * 1e3
    return n
