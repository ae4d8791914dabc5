"""SMPL-X body model: batched linear blend skinning in PyTorch.

Counterpart of ``coma_tpu/models/smplx.py``, with the same fields, functions
and defaults. Reference parity: the vendored smplx package
(``smplx/body_models.py:722`` SMPLX, ``smplx/lbs.py:134-227`` lbs, ``:248``
blend_shapes, ``:320`` batch_rigid_transform).

Everything runs in float32 on the model's device, with TF32 off for the
products (:func:`full_fp32`): the star-pose template feeds float64
poisson-disk elimination and nearest-vertex indices downstream, which must
not see a rounding the CPU does not make.

The weights are license-gated (the SMPL-X npz from MPG) and never
redistributed: :meth:`SMPLXModel.from_npz` loads a user's file,
:func:`random_model` builds a seeded synthetic model (the same one as
``coma_tpu``'s for the same seed), and :meth:`SMPLXModel.from_arrays` builds
one from numpy arrays, so both packages can be fed one model.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from coma_tpu_torch.geometry.transforms import rodrigues

NUM_BODY_JOINTS = 21   # SMPLX: SMPL's 23 minus the two hand roots
NUM_HAND_JOINTS = 15
NUM_FACE_JOINTS = 3    # jaw, leye, reye
NUM_JOINTS = NUM_BODY_JOINTS + NUM_FACE_JOINTS + 2 * NUM_HAND_JOINTS  # 54 (+root)

TENSOR_FIELDS = (
    "v_template", "shapedirs", "expr_dirs", "posedirs", "J_regressor",
    "lbs_weights", "pose_mean", "left_hand_components", "right_hand_components",
)


@contextlib.contextmanager
def full_fp32():
    """Matrix products in full float32 on the card (TF32 off), restored after."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


@dataclasses.dataclass(frozen=True)
class SMPLXModel:
    """SMPL-X weights as tensors on one device (parents and faces on the host)."""

    v_template: torch.Tensor          # (V, 3)
    shapedirs: torch.Tensor           # (V, 3, n_betas)
    expr_dirs: torch.Tensor           # (V, 3, n_expr)
    posedirs: torch.Tensor            # (9*J, V*3) — (R - I) feature basis
    J_regressor: torch.Tensor         # (J+1, V)
    lbs_weights: torch.Tensor         # (V, J+1)
    pose_mean: torch.Tensor           # ((J+1)*3,) — hand means unless flat_hand_mean
    left_hand_components: torch.Tensor   # (n_pca, 45)
    right_hand_components: torch.Tensor  # (n_pca, 45)
    parents: Tuple[int, ...] = ()     # (J+1,)
    faces: Tuple = ()                 # flat; use .faces_array

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def faces_array(self) -> np.ndarray:
        return np.asarray(self.faces, dtype=np.int64).reshape(-1, 3)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @classmethod
    def from_arrays(
        cls,
        arrays: Mapping[str, np.ndarray],
        parents: Sequence[int],
        faces,
        device="cuda",
        dtype=torch.float32,
    ) -> "SMPLXModel":
        """A model from numpy arrays named as :data:`TENSOR_FIELDS`."""
        tensors = {f: torch.as_tensor(np.array(arrays[f]), dtype=dtype).to(device)
                   for f in TENSOR_FIELDS}
        return cls(**tensors, parents=tuple(int(p) for p in parents),
                   faces=tuple(np.asarray(faces, dtype=np.int64).ravel().tolist()))

    @classmethod
    def from_npz(
        cls,
        path: str,
        num_betas: int = 10,
        num_expression_coeffs: int = 10,
        flat_hand_mean: bool = False,
        device="cuda",
        dtype=torch.float32,
    ) -> "SMPLXModel":
        """Load the official SMPL-X npz (user-provided; license-gated).

        The reference's loading semantics (``body_models.py:SMPLX.__init__``):
        shapedirs' last axis splits into 300 shape + 100 expression dirs (or
        10 + 10 for reduced models); pose_mean embeds the hand means unless
        ``flat_hand_mean``.
        """
        data = np.load(path, allow_pickle=True)
        shapedirs_full = np.asarray(data["shapedirs"], dtype=np.float64)
        SHAPE_SPACE_DIM = 300
        if shapedirs_full.shape[-1] < SHAPE_SPACE_DIM + 10:
            shape_dirs = shapedirs_full[..., :10][..., :num_betas]
            expr_dirs = shapedirs_full[..., 10:][..., :num_expression_coeffs]
        else:
            shape_dirs = shapedirs_full[..., :num_betas]
            expr_dirs = shapedirs_full[
                ..., SHAPE_SPACE_DIM : SHAPE_SPACE_DIM + num_expression_coeffs
            ]

        posedirs = np.asarray(data["posedirs"], dtype=np.float64)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (9J, V*3)

        parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
        parents[0] = -1

        left_mean = np.asarray(data["hands_meanl"], dtype=np.float64).ravel()
        right_mean = np.asarray(data["hands_meanr"], dtype=np.float64).ravel()
        if flat_hand_mean:
            left_mean = np.zeros_like(left_mean)
            right_mean = np.zeros_like(right_mean)
        pose_mean = np.concatenate([
            np.zeros(3),                      # global orient
            np.zeros(NUM_BODY_JOINTS * 3),
            np.zeros(3 * NUM_FACE_JOINTS),    # jaw, leye, reye
            left_mean,
            right_mean,
        ])
        arrays = dict(
            v_template=data["v_template"], shapedirs=shape_dirs, expr_dirs=expr_dirs,
            posedirs=posedirs, J_regressor=data["J_regressor"], lbs_weights=data["weights"],
            pose_mean=pose_mean, left_hand_components=data["hands_componentsl"],
            right_hand_components=data["hands_componentsr"],
        )
        return cls.from_arrays(arrays, parents, data["f"], device=device, dtype=dtype)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3). Reference: ``lbs.py:blend_shapes:248``."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3). Reference: ``lbs.py:vertices2joints:230``."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def batch_rigid_transform(
    rot_mats: torch.Tensor,   # (B, J, 3, 3)
    joints: torch.Tensor,     # (B, J, 3)
    parents: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the kinematic tree.

    Returns (posed_joints (B,J,3), rel_transforms (B,J,4,4)).
    Reference: ``lbs.py:batch_rigid_transform:320``.
    """
    B, J = joints.shape[:2]
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, list(parents[1:])]

    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, 1, 4)

    def make_tf(R, t):  # (B,3,3),(B,3) -> (B,4,4)
        return torch.cat([torch.cat([R, t[:, :, None]], dim=2), bottom], dim=1)

    chain = [make_tf(rot_mats[:, 0], rel_joints[:, 0])]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ make_tf(rot_mats[:, i], rel_joints[:, i]))
    transforms = torch.stack(chain, dim=1)  # (B, J, 4, 4)

    posed_joints = transforms[:, :, :3, 3]
    # remove the rest-pose joint location from the translation (lbs.py:359-363)
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=2)
    moved = torch.einsum("bjkl,bjl->bjk", transforms, joints_homo)
    rel = transforms - torch.nn.functional.pad(moved[:, :, :, None], (3, 0))
    return posed_joints, rel


def lbs(
    betas: torch.Tensor,        # (B, n_shape_components)
    pose: torch.Tensor,         # (B, J*3) axis-angle full pose
    v_template: torch.Tensor,   # (V, 3)
    shapedirs: torch.Tensor,    # (V, 3, n)
    posedirs: torch.Tensor,     # (9(J-1), V*3)
    J_regressor: torch.Tensor,  # (J, V)
    parents: Tuple[int, ...],
    lbs_weights: torch.Tensor,  # (V, J)
    return_rel_transforms: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Linear blend skinning. Returns (verts (B,V,3), joints (B,J,3)), plus
    (rel_transforms (B,J,4,4), rest_joints (B,J,3)) when
    ``return_rel_transforms``. Reference: ``lbs.py:lbs:134-227``."""
    with full_fp32():
        B = max(betas.shape[0], pose.shape[0])
        J = J_regressor.shape[0]

        v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
        joints = vertices2joints(J_regressor, v_shaped)

        rot_mats = rodrigues(pose.reshape(B, J, 3))                    # (B, J, 3, 3)
        eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)          # (B, 9(J-1))
        pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)     # (B, V, 3)
        v_posed = v_shaped + pose_offsets

        posed_joints, rel_tf = batch_rigid_transform(rot_mats, joints, parents)

        T = torch.einsum("vj,bjkl->bvkl", lbs_weights, rel_tf)         # (B, V, 4, 4)
        v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=2)
        verts = torch.einsum("bvkl,bvl->bvk", T, v_homo)[:, :, :3]
    if return_rel_transforms:
        return verts, posed_joints, rel_tf, joints
    return verts, posed_joints


def smplx_forward(
    model: SMPLXModel,
    betas: Optional[torch.Tensor] = None,            # (B, n_betas)
    expression: Optional[torch.Tensor] = None,       # (B, n_expr)
    global_orient: Optional[torch.Tensor] = None,    # (B, 3)
    body_pose: Optional[torch.Tensor] = None,        # (B, 63)
    jaw_pose: Optional[torch.Tensor] = None,         # (B, 3)
    leye_pose: Optional[torch.Tensor] = None,
    reye_pose: Optional[torch.Tensor] = None,
    left_hand_pose: Optional[torch.Tensor] = None,   # (B, 45) or (B, n_pca)
    right_hand_pose: Optional[torch.Tensor] = None,
    transl: Optional[torch.Tensor] = None,           # (B, 3)
    use_pca: bool = False,
    batch_size: Optional[int] = None,
    return_rel_transforms: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Full SMPL-X forward: assemble the pose, add pose_mean, run LBS.

    Returns (vertices (B,V,3), joints (B,J,3)); with
    ``return_rel_transforms`` also (rel_transforms (B,J,4,4), rest_joints
    (B,J,3)), into which ``transl`` is not folded. Reference:
    ``body_models.py:SMPLX.forward:928-1069``.
    """
    dtype, device = model.v_template.dtype, model.device
    B = batch_size or next(
        (int(a.shape[0]) for a in (betas, body_pose, global_orient, transl) if a is not None),
        1,
    )
    z = lambda n: torch.zeros((B, n), dtype=dtype, device=device)
    betas = betas if betas is not None else z(model.shapedirs.shape[-1])
    expression = expression if expression is not None else z(model.expr_dirs.shape[-1])
    global_orient = global_orient if global_orient is not None else z(3)
    body_pose = body_pose if body_pose is not None else z(NUM_BODY_JOINTS * 3)
    jaw_pose = jaw_pose if jaw_pose is not None else z(3)
    leye_pose = leye_pose if leye_pose is not None else z(3)
    reye_pose = reye_pose if reye_pose is not None else z(3)
    n_hand = model.left_hand_components.shape[0] if use_pca else NUM_HAND_JOINTS * 3
    left_hand_pose = left_hand_pose if left_hand_pose is not None else z(n_hand)
    right_hand_pose = right_hand_pose if right_hand_pose is not None else z(n_hand)

    with full_fp32():
        if use_pca:
            left_hand_pose = left_hand_pose @ model.left_hand_components
            right_hand_pose = right_hand_pose @ model.right_hand_components

    full_pose = torch.cat([
        global_orient, body_pose, jaw_pose, leye_pose, reye_pose,
        left_hand_pose, right_hand_pose,
    ], dim=1) + model.pose_mean[None]
    shape_components = torch.cat([betas, expression], dim=-1)
    shapedirs = torch.cat([model.shapedirs, model.expr_dirs], dim=-1)

    out = lbs(
        shape_components, full_pose, model.v_template, shapedirs, model.posedirs,
        model.J_regressor, model.parents, model.lbs_weights,
        return_rel_transforms=return_rel_transforms,
    )
    verts, joints = out[0], out[1]
    if transl is not None:
        verts = verts + transl[:, None, :]
        joints = joints + transl[:, None, :]
    if return_rel_transforms:
        return verts, joints, out[2], out[3]
    return verts, joints


def star_pose_vertices(model: SMPLXModel) -> torch.Tensor:
    """The canonical 'star pose' template: body_pose[2] = +π/6,
    body_pose[5] = -π/6, all else zero (reference:
    ``src/coma/downsample_human.py:20-26``). Returns (V, 3) on the model's
    device."""
    body_pose = torch.zeros((1, NUM_BODY_JOINTS * 3), dtype=model.v_template.dtype,
                            device=model.device)
    body_pose[0, 2] = math.pi / 6
    body_pose[0, 5] = -math.pi / 6
    verts, _ = smplx_forward(model, body_pose=body_pose)
    return verts[0]


def random_model(
    num_verts: int = 64,
    num_betas: int = 4,
    num_expr: int = 2,
    seed: int = 0,
    device="cuda",
    dtype=torch.float32,
) -> SMPLXModel:
    """A tiny synthetic SMPL-X-shaped model for tests (full 55-joint tree);
    the numpy draws of ``coma_tpu``'s ``random_model``, in its order."""
    rng = np.random.default_rng(seed)
    J = NUM_JOINTS + 1
    V = num_verts
    parents = [-1] + [rng.integers(0, max(1, j)) for j in range(1, J)]
    lbs_w = rng.uniform(size=(V, J))
    lbs_w /= lbs_w.sum(-1, keepdims=True)
    faces = []
    for i in range(V - 2):
        faces.extend([i, i + 1, i + 2])
    arrays = dict(
        v_template=rng.normal(size=(V, 3)),
        shapedirs=rng.normal(size=(V, 3, num_betas)) * 0.1,
        expr_dirs=rng.normal(size=(V, 3, num_expr)) * 0.01,
        posedirs=rng.normal(size=(9 * (J - 1), V * 3)) * 0.01,
        J_regressor=rng.dirichlet(np.ones(V), size=J),
        lbs_weights=lbs_w,
        pose_mean=np.zeros(J * 3),
        left_hand_components=rng.normal(size=(6, 45)),
        right_hand_components=rng.normal(size=(6, 45)),
    )
    return SMPLXModel.from_arrays(arrays, parents, faces, device=device, dtype=dtype)
