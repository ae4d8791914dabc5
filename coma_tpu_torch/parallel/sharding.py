"""The ComA aggregation over a (data, model) grid of ranks.

Counterpart of ``coma_tpu/parallel/sharding.py``'s ``round_up``,
``pad_batch``, ``shard_state_over_h``, ``mesh_2d`` and
``sharded_contact_aggregate_2d``. There a 2-D mesh inside one program splits
the samples over ``data`` and the H (human-vertex) axis of the accumulators
over ``model``. Here the same grid is laid over the ranks of
``parallel/distributed.py``: rank r is (data r // n_model, model
r % n_model), holds only its H rows of the grids, and aggregates its sample
shard into them (K1 on the card). The update is elementwise in H, so the
model axis needs no collective; one all-reduce over each data group sums
the sample shards. The 1-D ``sharded_{contact,occupancy}_aggregate`` are
``distributed.py``'s multi-process extraction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from coma_tpu_torch.affordance.state import ComAState
from coma_tpu_torch.ops.contact_kernel import fused_contact_update_batch
from coma_tpu_torch.parallel import distributed

# the H-leading accumulators of a ComA or occupancy state
H_FIELDS = (
    "prob_grid_canon_human_wrt_obj",
    "prob_grid_canon_obj_wrt_human",
    "contact_dist_expectation_grid_nom",
    "contact_dist_expectation_grid_denom",
    "significant_contact_count",
    "spatial_occupancy_grids",
)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_batch(arrays: Sequence[torch.Tensor], batch_axis_size: int
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Zero-pad (B, ...) tensors to ``batch_axis_size`` rows; returns them and
    the (batch_axis_size,) validity, 1 for the given rows and 0 for the pad."""
    B = arrays[0].shape[0]
    if batch_axis_size < B:
        raise ValueError(f"cannot pad {B} rows to {batch_axis_size}")
    pad = batch_axis_size - B
    padded = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in arrays]
    valid = torch.cat([arrays[0].new_ones(B), arrays[0].new_zeros(pad)])
    return padded, valid


@dataclasses.dataclass
class Grid2D:
    """A rank's place in an (n_data, n_model) grid, and the process group of
    its data axis: the ranks that hold the same H rows."""

    ctx: distributed.DistContext
    n_data: int
    n_model: int
    data_group: Optional[dist.ProcessGroup]

    @property
    def data(self) -> int:
        return self.ctx.rank // self.n_model

    @property
    def model(self) -> int:
        return self.ctx.rank % self.n_model


def grid_2d(ctx: distributed.DistContext, n_data: int, n_model: int) -> Grid2D:
    """The counterpart of ``mesh_2d``: rank r at (r // n_model, r % n_model).
    Every rank must call it, as it creates each data group on every rank in
    the same order (``dist.new_group`` is collective)."""
    if n_data * n_model != ctx.world_size:
        raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} ranks, "
                         f"this launch has {ctx.world_size}")
    group = None
    if ctx.world_size > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == ctx.rank % n_model:
                group = g
    return Grid2D(ctx, n_data, n_model, group)


def _rows(H: int, part: int, parts: int) -> slice:
    if H % parts:
        raise ValueError(f"H={H} must divide over model={parts}")
    n = H // parts
    return slice(part * n, (part + 1) * n)


def shard_state_over_h(state, part: int, parts: int):
    """Rows ``part`` of ``parts`` equal slices of the H-leading accumulators
    of a ComA or occupancy state, as tensors of their own (the full ones can
    be freed); the rest as it is, ``human_res`` the slice's."""
    rows = _rows(state.human_res, part, parts)
    fields = {f: getattr(state, f)[rows].clone() for f in H_FIELDS if hasattr(state, f)}
    return dataclasses.replace(state, human_res=rows.stop - rows.start, **fields)


def sharded_contact_aggregate_2d(
    state: ComAState,
    human_verts: torch.Tensor,    # (B, H, 3)
    human_normals: torch.Tensor,  # (B, H, 3)
    obj_verts: torch.Tensor,      # (B, O, 3)
    obj_normals: torch.Tensor,    # (B, O, 3)
    grid: Grid2D,
    valid: Optional[torch.Tensor] = None,   # (B,)
) -> ComAState:
    """Aggregate the whole batch into this rank's H slice ``state``
    (:func:`shard_state_over_h`), IN PLACE; returns it. B is padded to a
    multiple of n_data (padded slots valid 0, skipped); the rank aggregates
    its data shard against its H rows, and the six accumulators are summed
    over the data group only (the model ranks hold other rows). The carried
    state counts once: ranks off data row 0 add their shard to zeros."""
    ctx = grid.ctx
    H = human_verts.shape[1]
    rows = _rows(H, grid.model, grid.n_model)
    if state.human_res != rows.stop - rows.start:
        raise ValueError(f"the state holds {state.human_res} rows, this rank's slice of "
                         f"H={H} has {rows.stop - rows.start}")
    B = human_verts.shape[0]
    if valid is None:
        valid = human_verts.new_ones(B)
    padded, _ = pad_batch([human_verts, human_normals, obj_verts, obj_normals, valid],
                          round_up(B, grid.n_data))
    hv, hn, ov, on, v = padded
    n = hv.shape[0] // grid.n_data
    mine = slice(grid.data * n, (grid.data + 1) * n)
    distributed.zero_contribution(state, keep=grid.data == 0)
    fused_contact_update_batch(state, hv[mine, rows].contiguous(), hn[mine, rows].contiguous(),
                               ov[mine].contiguous(), on[mine].contiguous(),
                               valid=v[mine].contiguous())
    if grid.n_data > 1:
        distributed.allreduce_state(state, ctx, group=grid.data_group)
    return state


def gather_over_h(state, grid: Grid2D):
    """The whole state on rank 0 from the H slices of data row 0 (each rank
    of that row sends its rows to rank 0); ``None`` on every other rank."""
    ctx = grid.ctx
    if ctx.world_size == 1:
        return state
    names = [f for f in H_FIELDS if hasattr(state, f)]
    if ctx.rank == 0:
        parts = {f: [getattr(state, f)] for f in names}
        for src in range(1, grid.n_model):
            for f in names:
                buf = torch.empty_like(getattr(state, f))
                distributed.recv_(buf, src, ctx)
                parts[f].append(buf)
        fields = {f: torch.cat(p) for f, p in parts.items()}
        return dataclasses.replace(state, human_res=state.human_res * grid.n_model, **fields)
    if grid.data == 0:
        for f in names:
            distributed.send(getattr(state, f), 0, ctx)
    return None
