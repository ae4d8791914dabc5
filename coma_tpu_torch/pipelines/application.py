"""HOI reconstruction: fit a SMPL-X human to a learned ComA (PyTorch).

Counterpart of ``coma_tpu/pipelines/application.py`` (reference:
``src/application/optimize.py:optimize_smpl:167-317``): orientation targets
(the argmax of the relative-normal grid at a reference object vertex) and
contact pairs (proximity expectation above a threshold) from the ComA
pickle, then Adam steps over the VPoser latent, global orient, translation
and both hand poses, with the orientation loss, the chamfer contact loss,
the VPoser and angle priors and an optional capsule collision term.

``coma_tpu`` compiles the steps into one ``lax.scan``; here they are an
eager loop with autograd through the port's SMPL-X forward (LBS in float32,
TF32 off) and an Adam written in optax's order of operations, so the two fits
round alike step by step. The loop does not wait for the card: the loss of
every step stays on the device until the end.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from coma_tpu_torch.affordance.canonicalize import canonicalize_pairwise
from coma_tpu_torch.geometry.transforms import normalize_vectors
from coma_tpu_torch.models.coap import capsule_occupancy, collision_loss, sample_scene_points_bbox
from coma_tpu_torch.models.smplx import SMPLXModel, smplx_forward
from coma_tpu_torch.models.vposer import VPoserDecoder, l2_prior, smplify_angle_prior
from coma_tpu_torch.optim import OptaxAdam


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Differentiable area-weighted vertex normals (reference:
    ``application/optimize.py:compute_vertex_normals:118-152``): each face's
    cross product added to its three vertices (``index_add``), then
    normalised with the norm clamped below by ``eps``. The norm's square
    root is taken through a double-where, so a vertex with a zero sum has a
    zero gradient, not NaN; the value is ``coma_tpu``'s."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    n2 = torch.sum(vn * vn, dim=-1, keepdim=True)
    pos = n2 > 0
    norm = torch.where(pos, torch.sqrt(torch.where(pos, n2, torch.ones_like(n2))),
                       torch.zeros_like(n2))
    return vn / torch.clamp(norm, min=eps)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer (reference: ``optimize.py:chamfer_distance:155-164``)
    with the square root stabilised by 1e-12, so coincident points give a
    zero gradient, not NaN. Builds the (A, B) distance matrix."""
    diff = a[:, None, :] - b[None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return d.amin(dim=1).mean() + d.amin(dim=0).mean()


def derive_targets_from_coma(coma_dict: Dict[str, Any], reference_object_vertex_index: int,
                             contact_threshold: float):
    """Orientation targets and contact correspondences from a raw ComA
    pickle dict (reference: ``optimize.py:188-196``); numpy."""
    grid_prob = np.asarray(
        coma_dict["prob_grid_canon_human_wrt_obj"])[:, reference_object_vertex_index, :]  # (H, N)
    grid = np.asarray(coma_dict["canon_normal_grid"])                                    # (N, 3)
    orientation_gt = grid[np.argmax(grid_prob, axis=1)]                                  # (H, 3)
    prox = np.asarray(coma_dict["contact_dist_expectation_grid_nom"]) / np.asarray(
        coma_dict["contact_dist_expectation_grid_denom"])                                # (H, O)
    selected_human = np.flatnonzero(prox.max(axis=1) > contact_threshold)
    corresponding_obj = np.argmax(prox[selected_human], axis=1)
    return orientation_gt, selected_human, corresponding_obj


@dataclasses.dataclass
class HOIOptResult:
    vertices: np.ndarray
    faces: np.ndarray
    losses: Dict[str, float]
    loss_history: Optional[np.ndarray] = None   # (num_iters,) total loss before each step


@dataclasses.dataclass
class HOIProblem:
    """The fit's free parameters (leaf tensors that require grad) and its
    functions of them: ``forward(params)`` -> (vertices (V, 3), joints
    (J, 3), body pose (1, 63)); ``losses_fn(params)`` -> (total, parts)."""

    params: Dict[str, torch.Tensor]
    forward: Callable
    losses_fn: Callable


def build_problem(
    smplx_model: SMPLXModel,
    vposer_decoder: VPoserDecoder,
    coma_dict: Dict[str, Any],
    obj_verts: np.ndarray,        # (O, 3) raw pcd points
    obj_normals: np.ndarray,      # (O, 3)
    reference_object_vertex_index: int = 0,
    contact_threshold: float = 0.3,
    scale_factor: float = 1.0,
    body_pose_weight: float = 4.78,
    bending_prior_weight: float = 1.2,
    pprior_weight: float = 1e1,
    orientation_weight: float = 1e12,
    contact_weight: float = 2.6e11,
    collision_weight: float = 1e9,
    use_collision: bool = False,
    betas: Optional[np.ndarray] = None,
    eps: float = 1e-6,
) -> HOIProblem:
    """The fit at the reference's start (zero latent, orient and hands;
    translation (3, 1, 0)) with the losses of ``application.py:146-169``,
    on the model's device."""
    device = smplx_model.device
    f32 = dict(dtype=torch.float32, device=device)
    orientation_gt, sel_h, corr_o = derive_targets_from_coma(
        coma_dict, reference_object_vertex_index, contact_threshold)

    obj_verts_t = torch.as_tensor(np.asarray(obj_verts), **f32)
    obj_normals_t = normalize_vectors(torch.as_tensor(np.asarray(obj_normals), **f32), eps)
    ref_normal = obj_normals_t[reference_object_vertex_index: reference_object_vertex_index + 1]
    orientation_gt_t = torch.as_tensor(np.asarray(orientation_gt), **f32)
    sel_h_t = torch.as_tensor(sel_h, dtype=torch.long, device=device)
    contact_targets = obj_verts_t[torch.as_tensor(corr_o, dtype=torch.long, device=device)]
    faces = torch.as_tensor(smplx_model.faces_array, device=device)
    p = torch.as_tensor(np.array(coma_dict.get("principle_vec", [0, 0, 1])), **f32)
    q = torch.as_tensor(np.array(coma_dict.get("sub_principle_vec", [0, 1, 0])), **f32)
    betas_t = (torch.as_tensor(np.asarray(betas), **f32).reshape(1, -1) if betas is not None
               else torch.zeros((1, smplx_model.shapedirs.shape[-1]), **f32))

    params = dict(
        pose_embedding=torch.zeros((1, vposer_decoder.config.latent_dim), **f32),
        global_orient=torch.zeros((1, 3), **f32),
        transl=torch.tensor([[3.0, 1.0, 0.0]], **f32),
        left_hand_pose=torch.zeros((1, 45), **f32),
        right_hand_pose=torch.zeros((1, 45), **f32),
    )
    for v in params.values():
        v.requires_grad_(True)
    for w in vposer_decoder.parameters():
        w.requires_grad_(False)

    def forward(prm):
        body_pose = vposer_decoder(prm["pose_embedding"])
        verts, joints = smplx_forward(
            smplx_model, betas=betas_t, global_orient=prm["global_orient"],
            body_pose=body_pose, left_hand_pose=prm["left_hand_pose"],
            right_hand_pose=prm["right_hand_pose"], transl=prm["transl"])
        return verts[0] * scale_factor, joints[0] * scale_factor, body_pose

    def losses_fn(prm):
        verts, joints, body_pose = forward(prm)
        human_normals = vertex_normals(verts, faces, eps)
        # canonicalise against the reference object normal only: (H, 1, 3)
        canon = canonicalize_pairwise(human_normals, ref_normal, p, q, eps)[:, 0, :]
        align = torch.sum(orientation_gt_t * canon, dim=-1)
        orient = torch.mean(torch.nan_to_num(1.0 - (align + 1.0) / 2.0)) * orientation_weight
        contact = (chamfer_distance(verts[sel_h_t], contact_targets) * contact_weight
                   if len(sel_h) > 0 else torch.zeros((), **f32))
        pprior = l2_prior(prm["pose_embedding"]) * body_pose_weight ** 2 * pprior_weight
        angle = torch.sum(smplify_angle_prior(body_pose)) * bending_prior_weight
        total = orient + contact + pprior + angle
        if use_collision:
            weights = sample_scene_points_bbox(obj_verts_t, verts)
            occ = capsule_occupancy(obj_verts_t, joints, smplx_model.parents)
            total = total + collision_loss(occ * weights) * collision_weight
        return total, dict(orientation=orient, contact=contact, pprior=pprior, angle=angle)

    return HOIProblem(params=params, forward=forward, losses_fn=losses_fn)


def optimize_smpl(
    smplx_model: SMPLXModel,
    vposer_decoder: VPoserDecoder,
    coma_dict: Dict[str, Any],
    obj_verts: np.ndarray,
    obj_normals: np.ndarray,
    num_iters: int = 2000,
    lr: float = 1e-2,
    **problem_kwargs,
) -> HOIOptResult:
    """``num_iters`` Adam steps on :func:`build_problem`'s fit (its keyword
    arguments pass through). Returns the final vertices, the final losses
    and the total loss before every step."""
    problem = build_problem(smplx_model, vposer_decoder, coma_dict, obj_verts, obj_normals,
                            **problem_kwargs)
    params = problem.params
    opt = OptaxAdam(params, lr)
    history = torch.empty(num_iters, dtype=torch.float32, device=smplx_model.device)
    names = list(params)
    for step in range(num_iters):
        total, _ = problem.losses_fn(params)
        grads = torch.autograd.grad(total, [params[k] for k in names])
        history[step] = total.detach()
        opt.step(params, dict(zip(names, grads)))

    with torch.no_grad():
        verts, _, _ = problem.forward(params)
        _, parts = problem.losses_fn(params)
    return HOIOptResult(
        vertices=verts.cpu().numpy(),
        faces=np.asarray(smplx_model.faces_array),
        losses={k: float(v) for k, v in parts.items()},
        loss_history=history.cpu().numpy(),
    )


def save_optimized_obj(result: HOIOptResult, save_dir: str, supercategory: str,
                       category: str) -> str:
    from coma_tpu_torch.geometry.mesh import save_obj

    out_dir = f"{save_dir}/{supercategory}/{category}"
    os.makedirs(out_dir, exist_ok=True)
    path = f"{out_dir}/optimized.obj"
    save_obj(path, result.vertices, result.faces)
    return path
