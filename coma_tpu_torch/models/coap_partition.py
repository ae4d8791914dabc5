"""COAP body partitioning: per-bone parts, local frames, bbox gating (PyTorch).

Counterpart of ``coma_tpu/models/coap_partition.py`` (reference:
``imports/coap/coap.py:Partitioner:162-560``): SMPL-X vertices fall into
per-bone parts by the argmax of their LBS weights after the merge list, each
part gets a bone-local frame from the kinematic transforms, and occupancy
queries are gated by padded per-part boxes. The tables are numpy (computed
once per body model); the frames and gates are tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# coap.py:178-189 (smplx): joints merged into their parents
MERGE_BODY_PARTS_SMPLX = (15, 10, 11, 3, 13, 14, 9)
NUM_BODY_JOINTS_COAP = 22  # pelvis .. wrists


def build_part_mapping(parents: Tuple[int, ...]) -> np.ndarray:
    """(22,) joint -> part index after merging (merged joints take their
    parent's part; parts re-indexed densely)."""
    part_of = np.arange(NUM_BODY_JOINTS_COAP)
    for j in sorted(MERGE_BODY_PARTS_SMPLX, reverse=True):
        part_of[j] = parents[j]
    for j in range(NUM_BODY_JOINTS_COAP):     # a merged joint whose parent merged too
        while part_of[part_of[j]] != part_of[j]:
            part_of[j] = part_of[part_of[j]]
    kept = sorted(set(part_of.tolist()))
    reindex = {k: i for i, k in enumerate(kept)}
    return np.asarray([reindex[p] for p in part_of], dtype=np.int64)


def partition_vertices(lbs_weights: np.ndarray, parents: Tuple[int, ...]) -> Tuple[np.ndarray, int]:
    """(V,) part per vertex by the body-joint argmax of the LBS weights (hand
    and face joints' weights folded into their body-joint ancestor first)."""
    W = np.asarray(lbs_weights).copy()
    for j in range(NUM_BODY_JOINTS_COAP, W.shape[1]):
        anc = j
        while anc >= NUM_BODY_JOINTS_COAP:
            anc = parents[anc]
        W[:, anc] += W[:, j]
    part_of_joint = build_part_mapping(parents)
    parts = part_of_joint[np.argmax(W[:, :NUM_BODY_JOINTS_COAP], axis=1)]
    return parts, int(part_of_joint.max()) + 1


@dataclasses.dataclass
class BodyPartition:
    """Static per-model partition tables."""

    vertex_part: np.ndarray        # (V,) part index
    part_joint: np.ndarray         # (K,) representative joint per part
    num_parts: int
    max_part_size: int
    part_vertex_ids: np.ndarray    # (K, max_part_size) padded vertex selectors
    part_vertex_valid: np.ndarray  # (K, max_part_size) 1/0


def build_partition(lbs_weights, parents) -> BodyPartition:
    vertex_part, num_parts = partition_vertices(lbs_weights, parents)
    part_of_joint = build_part_mapping(parents)
    part_joint = np.zeros(num_parts, np.int64)
    for j in range(NUM_BODY_JOINTS_COAP):
        # representative: the first (shallowest) joint mapped to the part
        if part_joint[part_of_joint[j]] == 0 and part_of_joint[j] != part_of_joint[0]:
            part_joint[part_of_joint[j]] = j
    sizes = [(vertex_part == k).sum() for k in range(num_parts)]
    m = int(max(sizes))
    ids = np.zeros((num_parts, m), np.int64)
    valid = np.zeros((num_parts, m), np.float32)
    for k in range(num_parts):
        idx = np.flatnonzero(vertex_part == k)
        ids[k, : len(idx)] = idx
        valid[k, : len(idx)] = 1.0
        if len(idx):
            ids[k, len(idx):] = idx[0]  # pad with a real vertex
    return BodyPartition(vertex_part=vertex_part, part_joint=part_joint, num_parts=num_parts,
                         max_part_size=m, part_vertex_ids=ids, part_vertex_valid=valid)


def _homogeneous_inverse(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(K, 3, 3), (K, 3) -> (K, 4, 4) inverse of the rigid transform [R | t]."""
    K = R.shape[0]
    R_inv = R.transpose(1, 2)
    t_inv = -torch.einsum("kij,kj->ki", R_inv, t)
    bottom = torch.tensor([[[0.0, 0.0, 0.0, 1.0]]], dtype=R.dtype, device=R.device).expand(K, 1, 4)
    return torch.cat([torch.cat([R_inv, t_inv[:, :, None]], dim=2), bottom], dim=1)


def bone_local_frames(
    rel_transforms: torch.Tensor,   # (J, 4, 4) from batch_rigid_transform
    rest_joints: torch.Tensor,      # (J, 3)
    part_joint: np.ndarray,         # (K,)
) -> torch.Tensor:
    """(K, 4, 4) world -> bone-local transforms: the inverse of the
    representative joint's posed transform composed with its rest offset
    (reference: ``coap.py:compute_abs_transformations:562``)."""
    idx = torch.as_tensor(part_joint, device=rel_transforms.device)
    K = len(part_joint)
    T = rel_transforms[idx]
    offset = torch.eye(4, dtype=T.dtype, device=T.device).repeat(K, 1, 1)
    offset[:, :3, 3] = rest_joints[idx]
    world = T @ offset
    return _homogeneous_inverse(world[:, :3, :3], world[:, :3, 3])


def to_part_local(points: torch.Tensor, local_frames: torch.Tensor) -> torch.Tensor:
    """World points (Q, 3) -> per-part local coordinates (K, Q, 3)."""
    homo = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    return torch.einsum("kij,qj->kqi", local_frames, homo)[:, :, :3]


def part_bbox_gate(
    part_points_local: torch.Tensor,   # (K, M, 3)
    part_valid: torch.Tensor,          # (K, M)
    query_local: torch.Tensor,         # (K, Q, 3)
    bbox_padding: float = 1.2,         # coap.py:77
) -> torch.Tensor:
    """(K, Q) 1/0: queries inside each part's padded local box (reference:
    ``coap.py:get_bbox_bounds`` and the inside-bbox gate of ``query``)."""
    valid = part_valid[..., None] > 0
    lo = torch.where(valid, part_points_local, torch.full_like(part_points_local, 1e9))
    hi = torch.where(valid, part_points_local, torch.full_like(part_points_local, -1e9))
    lo = lo.amin(dim=1, keepdim=True)
    hi = hi.amax(dim=1, keepdim=True)
    center = (lo + hi) / 2
    half = (hi - lo) / 2 * bbox_padding
    inside = ((query_local >= center - half) & (query_local <= center + half)).all(dim=-1)
    return inside.to(query_local.dtype)
