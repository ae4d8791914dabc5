"""COAP-style body occupancy and collision losses (PyTorch).

Counterpart of ``coma_tpu/models/coap.py`` (reference: ``imports/coap/``;
the pipeline consumes only ``collision_loss`` = Σ relu(occupancy − 0.5) over
scene points, ``optimize_depth.py:752``, ``application/optimize.py:301``).
Two occupancy backends:

- :class:`COAPOccupancy`, the neural architecture (``ResnetPointnet`` part
  encoders and ``ImplicitNet`` decoders of ``imports/coap/modules.py``) for
  the published checkpoint. Submodules carry ``coma_tpu``'s Flax names
  (``encoder.block_0.fc_0``, ``decoder.lin3``, ...), so
  ``models/flax_params.py`` maps its params across.
- :func:`capsule_occupancy`, a weight-free capsule field around the posed
  bones, σ(κ(r − d)), 0.5 on the capsule surface. ``coma_tpu`` loops over the
  bones in Python; here the distance to every bone is one batched
  expression, with the same value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.coap_partition import (
    BodyPartition,
    bone_local_frames,
    part_bbox_gate,
    to_part_local,
)
from coma_tpu_torch.models.layers import Dense

# --------------------------------------------------------------------------
# Neural backend (the architecture of the published weights)
# --------------------------------------------------------------------------


class ResnetBlockFC(nn.Module):
    """FC ResNet block (reference: ``imports/coap/modules.py:64-105``)."""

    def __init__(self, size_in: int, size_out: int, size_h: Optional[int] = None,
                 device=None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = Dense(size_in, size_h, device=device)
        self.fc_1 = Dense(size_h, size_out, device=device)
        self.shortcut = (Dense(size_in, size_out, use_bias=False, device=device)
                         if size_in != size_out else None)

    def forward(self, x):
        net = self.fc_0(F.relu(x))
        dx = self.fc_1(F.relu(net))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + dx


class ResnetPointnet(nn.Module):
    """PointNet encoder with max-pool context (``modules.py:7-62``):
    (B, T, dim) -> (B, out_dim)."""

    def __init__(self, out_dim: int, hidden_dim: int, dim: int = 3, device=None):
        super().__init__()
        h = hidden_dim
        self.fc_pos = Dense(dim, 2 * h, device=device)
        self.block_0 = ResnetBlockFC(2 * h, h, device=device)
        self.block_1 = ResnetBlockFC(2 * h, h, device=device)
        self.block_3 = ResnetBlockFC(2 * h, h, device=device)
        self.block_4 = ResnetBlockFC(2 * h, h, device=device)
        self.fc_c = Dense(h, out_dim, device=device)

    def forward(self, p):
        def pool_cat(net):
            pooled = net.amax(dim=1, keepdim=True)
            return torch.cat([net, pooled.expand_as(net)], dim=-1)

        net = self.block_0(self.fc_pos(p))
        net = self.block_1(pool_cat(net))
        net = self.block_3(pool_cat(net))
        net = self.block_4(pool_cat(net))
        return self.fc_c(F.relu(net.amax(dim=1)))


class ImplicitNet(nn.Module):
    """IGR-style MLP (``modules.py:108-165``): softplus(β = 100) hidden
    activations, skip layers that re-concatenate the input scaled by 1/√2.
    When layer i+1 is a skip layer, ``lin{i}`` outputs ``dims[i+1] - d_in``,
    so the concatenation comes back to ``dims[i+1]``. No activation after
    the last layer."""

    def __init__(self, d_in: int, d_out: int = 1, dims: Tuple[int, ...] = (256, 256, 256),
                 skip_in: Tuple[int, ...] = (), device=None):
        super().__init__()
        all_dims = (d_in,) + tuple(dims) + (d_out,)
        self.n_layers = len(all_dims) - 1
        self.skip_in = tuple(skip_in)
        width = d_in
        for layer in range(self.n_layers):
            out_dim = all_dims[layer + 1] - (d_in if layer + 1 in self.skip_in else 0)
            if layer in self.skip_in:
                width += d_in
            self.add_module(f"lin{layer}", Dense(width, out_dim, device=device))
            width = out_dim

    def forward(self, x):
        inp = x
        for layer in range(self.n_layers):
            if layer in self.skip_in:
                x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"lin{layer}")(x)
            if layer < self.n_layers - 1:
                x = F.softplus(x * 100.0) / 100.0
        return x


@dataclasses.dataclass(frozen=True)
class COAPConfig:
    """Published-checkpoint hyperparameters (``coap.py:602-620``)."""

    num_parts: int = 20            # SMPL-X after MERGE_BODY_PARTS
    code_dim: int = 128
    hidden_dim: int = 128
    query_dims: Tuple[int, ...] = (256, 256, 256)
    query_skip: Tuple[int, ...] = (2,)
    query_out: int = 128
    decoder_dims: Tuple[int, ...] = (256, 256, 256, 256, 256, 256)
    decoder_skip: Tuple[int, ...] = (3,)
    level_set: float = 0.5


class COAPOccupancy(nn.Module):
    """Per-part encode, query encode, implicit decode, max over parts
    (``coap.py:COAPBodyModel.query:688-725``). The query feature is [local
    query (3), inside-bbox (1), part one-hot (K), part code]; the decoder
    sees [local query, query code]; occupancy sigmoid(−x) gated by the box.
    ``config.num_parts`` fixes K, which ``coma_tpu``'s Flax module reads
    from its input."""

    def __init__(self, config: COAPConfig = COAPConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        self.encoder = ResnetPointnet(cfg.code_dim, cfg.hidden_dim, device=device)
        self.query_encoder = ImplicitNet(3 + 1 + cfg.num_parts + cfg.code_dim, cfg.query_out,
                                         cfg.query_dims, cfg.query_skip, device=device)
        self.decoder = ImplicitNet(3 + cfg.query_out, 1, cfg.decoder_dims, cfg.decoder_skip,
                                   device=device)

    def forward(self, part_points, query_local, inside_bbox):
        """part_points (K, T, 3) local part clouds; query_local (K, Q, 3);
        inside_bbox (K, Q) in {0, 1}. Returns (Q,) occupancy in [0, 1]."""
        cfg = self.config
        K, Q, _ = query_local.shape
        if K != cfg.num_parts:
            raise ValueError(f"{K} parts given, the model was built for {cfg.num_parts}")
        codes = self.encoder(part_points)                                  # (K, code)
        one_hot = torch.eye(K, dtype=query_local.dtype, device=query_local.device)
        z = torch.cat([
            query_local,
            inside_bbox[..., None].to(query_local.dtype),
            one_hot[:, None, :].expand(K, Q, K),
            codes[:, None, :].expand(K, Q, cfg.code_dim),
        ], dim=-1)
        z = self.query_encoder(z)                                          # (K, Q, 128)
        raw = self.decoder(torch.cat([query_local, z], dim=-1))[..., 0]    # (K, Q)
        occ = torch.sigmoid(-raw) * inside_bbox
        return occ.amax(dim=0)


# --------------------------------------------------------------------------
# Geometric capsule backend (weight-free, differentiable)
# --------------------------------------------------------------------------

def capsule_occupancy(
    points: torch.Tensor,       # (Q, 3) query points (world)
    joints: torch.Tensor,       # (J, 3) posed joints (world)
    parents: Sequence[int],
    radii: Optional[torch.Tensor] = None,   # (J,) per-bone radius
    sharpness: float = 30.0,
) -> torch.Tensor:
    """Smooth occupancy of a capsule skeleton, σ(κ(r − d(point, bone))),
    max over bones: 0.5 on the capsule surface (COAP's level set). Bone j
    runs from its parent to joint j (a root is a point)."""
    if radii is None:
        radii = torch.full((len(parents),), 0.07, dtype=points.dtype, device=points.device)
    start = torch.as_tensor([p if p >= 0 else j for j, p in enumerate(parents)],
                            device=joints.device)
    a = joints[start]                                        # (J, 3)
    ab = joints - a                                          # (J, 3)
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-9)    # (J,)
    rel = points[None, :, :] - a[:, None, :]                 # (J, Q, 3)
    t = torch.clamp(torch.sum(rel * ab[:, None, :], dim=-1) / denom[:, None], 0.0, 1.0)
    diff = points[None, :, :] - (a[:, None, :] + t[..., None] * ab[:, None, :])
    # safe norm: a query on the bone axis is a legal input (maximally inside)
    dists = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)   # (J, Q)
    occ = torch.sigmoid(sharpness * (radii[:, None] - dists))
    return occ.amax(dim=0)


def collision_loss(occupancy: torch.Tensor, level_set: float = 0.5) -> torch.Tensor:
    """Σ relu(occ − level_set) (reference: ``coap.py:collision_loss:732-742``)."""
    return torch.sum(F.relu(occupancy - level_set))


def sample_scene_points_bbox(scene_points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(N,) 1/0 weight of the scene points inside the human's box (the
    reference's pre-filter, ``optimize_depth.py:sample_scene_points:105-124``)."""
    lo = verts.amin(dim=0)
    hi = verts.amax(dim=0)
    inside = ((scene_points >= lo) & (scene_points <= hi)).all(dim=-1)
    return inside.to(scene_points.dtype)


# --------------------------------------------------------------------------
# World-space query: partition, frames, bbox gate, neural occupancy
# --------------------------------------------------------------------------

def coap_occupancy_world(
    occ_model: COAPOccupancy,
    partition: BodyPartition,
    rest_joints: torch.Tensor,     # (J, 3)
    rel_transforms: torch.Tensor,  # (J, 4, 4) from the LBS
    translation: torch.Tensor,     # (3,) rigid translation (transl, depth)
    verts_world: torch.Tensor,     # (V, 3) posed and translated vertices
    query_points: torch.Tensor,    # (Q, 3) world scene points
) -> torch.Tensor:
    """The reference's ``coap.py:query:688-725`` end to end: part clouds and
    queries into bone-local frames (the translation folded into the
    frames), padded-box gate, neural occupancy, max over parts. (Q,)."""
    frames = bone_local_frames(rel_transforms, rest_joints, partition.part_joint)
    # local = R_inv (x - (t + d)): fold -R_inv d into the frames' translation
    shift = torch.zeros_like(frames)
    shift[:, :3, 3] = -torch.einsum("kij,j->ki", frames[:, :3, :3], translation)
    frames = frames + shift
    ids = torch.as_tensor(partition.part_vertex_ids, device=verts_world.device)
    part_pts = verts_world[ids]                                          # (K, M, 3)
    homo = torch.cat([part_pts, torch.ones_like(part_pts[..., :1])], dim=-1)
    local_parts = torch.einsum("kij,kmj->kmi", frames, homo)[..., :3]
    query_local = to_part_local(query_points, frames)
    valid = torch.as_tensor(partition.part_vertex_valid, device=verts_world.device)
    inside = part_bbox_gate(local_parts, valid, query_local, bbox_padding=1.125)  # coap.py:603
    return occ_model(local_parts, query_local, inside)


# OpenPose BODY_25 skeleton (the 25-joint body subset the depth optimizer
# works in): parent per joint, -1 = root (MidHip). The capsule fallback's.
BODY25_PARENTS = (
    1, 8, 1, 2, 3, 1, 5, 6, -1, 8, 9, 10, 8, 12, 13,
    0, 0, 15, 16, 14, 19, 14, 11, 22, 11,
)
# Per-bone capsule radii (meters): torso and head thicker than limbs and feet.
BODY25_RADII = (
    0.08, 0.10, 0.09, 0.05, 0.04, 0.09, 0.05, 0.04, 0.12, 0.10, 0.07, 0.05,
    0.10, 0.07, 0.05, 0.07, 0.07, 0.06, 0.06, 0.03, 0.03, 0.04, 0.03, 0.03,
    0.04,
)


def pad_scene_points(points: np.ndarray, max_points: int,
                     dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) scene points -> (max_points, 3) and a (max_points,) valid mask.
    Pad slots sit at 1e6, outside every box; the mask zeroes any residual
    occupancy before the collision sum."""
    pts = np.full((max_points, 3), 1e6, dtype=dtype)
    valid = np.zeros((max_points,), dtype=dtype)
    n = min(len(points), max_points)
    if n:
        pts[:n] = points[:n]
        valid[:n] = 1.0
    return pts, valid


def make_capsule_collision_aux_fn(
    parents: Sequence[int] = BODY25_PARENTS,
    radii=None,
    sharpness: float = 30.0,
    level_set: float = 0.5,
):
    """Weight-free collision term of one sample for the depth optimizer:
    ``fn(verts_world, aux)`` with ``aux`` = dict(joints (J, 3) at zero
    displacement, base_centroid (3,), scene_points (Q, 3), scene_valid
    (Q,)). The displacement is the centroid shift (the depth optimizer only
    translates the body along the camera ray)."""
    radii_t = torch.as_tensor(radii if radii is not None else BODY25_RADII[: len(parents)],
                              dtype=torch.float32)

    def fn(verts_world, aux):
        d = verts_world.mean(dim=0) - aux["base_centroid"]
        occ = capsule_occupancy(aux["scene_points"], aux["joints"] + d[None], parents,
                                radii_t.to(verts_world.device), sharpness)
        return collision_loss(occ * aux["scene_valid"], level_set)

    return fn


def make_coap_collision_aux_fn(occ_model: COAPOccupancy, partition: BodyPartition,
                               level_set: float = 0.5):
    """Neural-COAP collision term of one sample for the depth optimizer
    (reference default: ``optimize_depth.py:752-762``, w = 0.4). ``aux`` =
    dict(rest_joints (J, 3), rel_transforms (J, 4, 4), translation (3,) from
    LBS space to the world at zero displacement, base_centroid (3,),
    scene_points (Q, 3), scene_valid (Q,))."""

    def fn(verts_world, aux):
        d = verts_world.mean(dim=0) - aux["base_centroid"]
        occ = coap_occupancy_world(occ_model, partition, aux["rest_joints"],
                                   aux["rel_transforms"], aux["translation"] + d, verts_world,
                                   aux["scene_points"])
        return collision_loss(occ * aux["scene_valid"], level_set)

    return fn


def make_coap_collision_fn(
    occ_model: COAPOccupancy,
    partition: BodyPartition,
    rest_joints: torch.Tensor,
    rel_transforms: torch.Tensor,
    base_verts: torch.Tensor,     # (V, 3) posed vertices at zero displacement
    scene_points: torch.Tensor,   # (Q, 3)
    level_set: float = 0.5,
):
    """``collision_fn(verts_world)`` for a depth optimizer that only
    translates the body: the displacement is the centroid shift from
    ``base_verts``, folded into the bone frames."""
    base_centroid = base_verts.mean(dim=0)

    def collision_fn(verts_world):
        d = verts_world.mean(dim=0) - base_centroid
        occ = coap_occupancy_world(occ_model, partition, rest_joints, rel_transforms, d,
                                   verts_world, scene_points)
        return collision_loss(occ, level_set)

    return collision_fn
