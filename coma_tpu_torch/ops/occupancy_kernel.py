"""K2: voxel-occupancy hit accumulation.

Replaces the TPU kernel ``coma_tpu/ops/occupancy_kernel.py:77``
(``occupancy_accumulate_padded``, driven by ``fused_occupancy_update_batch``
at ``:133``) with the hand-written CUDA kernel ``csrc/occupancy_hits.cu``.
:func:`fused_occupancy_update_batch` is a drop-in for
:func:`coma_tpu_torch.affordance.occupancy.occupancy_update_batch`, its plain
version: on a CPU state it runs that plain version; on a CUDA state it
launches the kernel once per slab of samples, or raises. The hit counts of
kernel and plain version are equal.

The kernel culls: a block owns a brick of voxels (``BRICK_I`` slices of the
slowest axis by :func:`brick_rows` rows by the whole fastest axis) and tests
only the valid (vertex, sample) pairs whose squared distance to the brick's
box of voxel centres is at most ``thres² + MARGIN·(‖x‖² + max‖g‖² + thres²)``,
and it reads and writes only the (vertex, brick) rows of the accumulator
that have such a pair. :func:`cull_keep` repeats that decision on tensors,
:func:`culled_hits` the hits it leaves, and :func:`kept_work` counts the
tests the kernel runs and the accumulator elements it touches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from coma_tpu_torch.affordance.occupancy import (
    last_valid_anchor,
    occupancy_update_batch,
    point_sq_norms,
    voxel_sq_norms,
)
from coma_tpu_torch.affordance.state import OccupancyState
from coma_tpu_torch.ops import build

SOURCE = "occupancy_hits"
MAX_SLAB = 64      # the kernel keeps a 64-bit mask of samples per vertex
THREADS = 128      # threads per block: R ≤ 128 (the kernel refuses another)
BRICK_I = 4        # slices of the slowest axis per brick (likewise)
MARGIN = 2.0 ** -17  # the cull's slack, relative to ‖x‖² + max‖g‖² + thres²

# Kernel launches since import; callers may reset it to 0.
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_F, _F, _P]


def _kernel():
    lib = build.load(SOURCE)
    fn = lib.coma_occupancy_hits
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


# ---------------------------------------------------------------------------
# The cull, on tensors
# ---------------------------------------------------------------------------

def brick_rows(R: int) -> int:
    """Rows of the middle axis per brick: the most whose voxels fit the
    block's threads, one run of the fastest axis each."""
    if not 1 <= R <= THREADS:
        raise ValueError(f"the kernel takes 1 to {THREADS} voxels per axis, got {R}")
    return THREADS // R


def brick_boxes(spatial_grid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                      torch.Tensor, torch.Tensor]:
    """Per brick of the (3, R, R, R) grid, in the kernel's block order: the
    lower and upper corners (bricks, 3) of the box of its voxel centres, the
    largest ‖g‖² (bricks,), and the brick of every voxel (R³,)."""
    R = spatial_grid.shape[-1]
    bj = brick_rows(R)
    n_bj = -(-R // bj)
    flat = spatial_grid.reshape(3, -1)
    gsq = voxel_sq_norms(flat)
    axis = torch.arange(R, device=flat.device)
    brick = ((axis[:, None] // BRICK_I) * n_bj + axis[None, :] // bj)[:, :, None]
    brick = brick.expand(R, R, R).reshape(-1)
    n = -(-R // BRICK_I) * n_bj
    lo = torch.full((n, 3), float("inf"), device=flat.device)
    hi = torch.full((n, 3), float("-inf"), device=flat.device)
    idx = brick[:, None].expand(-1, 3)
    lo.scatter_reduce_(0, idx, flat.T, "amin")
    hi.scatter_reduce_(0, idx, flat.T, "amax")
    g2max = torch.zeros(n, device=flat.device).scatter_reduce_(0, brick, gsq, "amax")
    return lo, hi, g2max, brick


def cull_keep(x: torch.Tensor, xsq: torch.Tensor, valid: torch.Tensor,
              spatial_grid: torch.Tensor, thres_sq: float) -> torch.Tensor:
    """(S, H, bricks) bool: the (sample, vertex, brick) tests the kernel runs,
    from the anchored vertices ``x`` (S, H, 3) and ‖x‖² (S, H), in float32
    as the kernel computes them (``fmax`` drops a NaN, as the card's
    ``fmaxf`` does; a NaN limit keeps the pair)."""
    lo, hi, g2max, _ = brick_boxes(spatial_grid)
    zero = torch.zeros((), device=x.device)
    d = torch.fmax(torch.fmax(lo - x[..., None, :], x[..., None, :] - hi), zero)  # (S, H, bricks, 3)
    dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    limit = thres_sq + MARGIN * (xsq[..., None] + g2max + thres_sq)
    return (valid > 0)[:, None, None] & ~(dist2 > limit)


def _anchored(state: OccupancyState, human_verts: torch.Tensor, obj_verts: torch.Tensor):
    anchors = obj_verts[:, state.selected_obj_idx]            # (B, 3)
    x = (human_verts - anchors[:, None, :]).contiguous()      # (B, H, 3)
    return anchors, x, point_sq_norms(x).contiguous()         # (B, H)


def _thres_sq(state: OccupancyState) -> float:
    return float(np.float32(state.rel_dist_thres * state.rel_dist_thres))


def kept_work(state: OccupancyState, human_verts: torch.Tensor, obj_verts: torch.Tensor,
              valid: torch.Tensor) -> Tuple[int, int, int]:
    """(tests the kernel runs, dense tests over the valid samples,
    accumulator elements it reads and writes) for one call of at most a
    slab, counted per voxel: a kept (sample, vertex, brick) is one test per
    voxel of the brick, and a (vertex, brick) with a kept sample is a row of
    the brick's voxels."""
    _, x, xsq = _anchored(state, human_verts, obj_verts)
    keep = cull_keep(x, xsq, valid, state.spatial_grid, _thres_sq(state))
    per_brick = torch.bincount(brick_boxes(state.spatial_grid)[3], minlength=keep.shape[-1])
    kept = int((keep.sum(dim=(0, 1)) * per_brick).sum())
    touched = int((keep.any(dim=0).sum(dim=0) * per_brick).sum())
    dense = int((valid > 0).sum()) * state.human_res * state.spatial_res ** 3
    return kept, dense, touched


def culled_hits(state: OccupancyState, human_verts: torch.Tensor, obj_verts: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """(H, R, R, R) hit counts of a batch with the cull applied: the plain
    version's test for the kept pairs, nothing for the others."""
    R = state.spatial_res
    _, x, xsq = _anchored(state, human_verts, obj_verts)
    keep = cull_keep(x, xsq, valid, state.spatial_grid, _thres_sq(state))
    brick = brick_boxes(state.spatial_grid)[3]
    grid = state.spatial_grid.reshape(3, -1)
    gsq = voxel_sq_norms(grid)
    hits = torch.zeros(state.human_res, R ** 3, device=x.device)
    for s in range(x.shape[0]):
        cross = (x[s, :, 0, None] * grid[0][None, :] + x[s, :, 1, None] * grid[1][None, :]
                 + x[s, :, 2, None] * grid[2][None, :])
        d_sq = gsq[None, :] - 2.0 * cross + xsq[s][:, None]
        hits += (keep[s][:, brick] & (d_sq < state.rel_dist_thres * state.rel_dist_thres)).float()
    return hits.reshape(-1, R, R, R)


def fused_occupancy_update_batch(
    state: OccupancyState,
    human_verts: torch.Tensor,  # (B, H, 3)
    obj_verts: torch.Tensor,    # (B, O, 3)
    valid: Optional[torch.Tensor] = None,  # (B,)
    slab: int = 32,
) -> OccupancyState:
    """Aggregate a batch into ``state`` IN PLACE; returns ``state``.

    On CUDA, one kernel launch per ``slab`` samples reads and writes the
    (H, R³) accumulator once; the anchor carry (last valid sample's anchor)
    and the sample count stay here.
    """
    global launches
    device = state.device
    if device.type == "cpu":
        return occupancy_update_batch(state, human_verts, obj_verts, valid=valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not 1 <= slab <= MAX_SLAB:
        raise ValueError(f"slab must be in [1, {MAX_SLAB}], got {slab}")
    B, H = human_verts.shape[0], state.human_res
    O, R = state.obj_res, state.spatial_res
    L = R * R * R
    if valid is None:
        valid = torch.ones(B, dtype=torch.float32, device=device)
    for name, t, shape in (
        ("human_verts", human_verts, (B, H, 3)),
        ("obj_verts", obj_verts, (B, O, 3)),
        ("valid", valid, (B,)),
        ("spatial_grid", state.spatial_grid, (3, R, R, R)),
        ("spatial_occupancy_grids", state.spatial_occupancy_grids, (H, R, R, R)),
    ):
        build.check_tensor(name, t, device, shape)
    brick_rows(R)
    if B == 0:
        return state
    lib, fn = _kernel()

    anchors, x, xsq = _anchored(state, human_verts, obj_verts)
    grid_flat = state.spatial_grid.reshape(3, L)
    gsq = voxel_sq_norms(grid_flat).contiguous()              # (L,)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for start in range(0, B, slab):
            stop = min(start + slab, B)
            code = fn(
                state.spatial_occupancy_grids.data_ptr(),
                x[start:stop].data_ptr(), xsq[start:stop].data_ptr(),
                grid_flat.data_ptr(), gsq.data_ptr(), valid[start:stop].data_ptr(),
                stop - start, H, R, THREADS, BRICK_I, _thres_sq(state), MARGIN, stream,
            )
            build.check(lib, code, "occupancy_hits launch")
            launches += 1
    state.used_count.add_(valid.sum())
    state.anchor_vert = last_valid_anchor(state.anchor_vert, anchors, valid)
    return state
