"""Mocap adapter: Hand4Whole regression -> pixel-space mesh (PyTorch).

Counterpart of ``coma_tpu/pipelines/mocap.py`` (reference:
``utils/prepare_bodymocap.py:Hand4Whole_Regressor:24-157``): the person box
square-expanded to the 512x384 aspect, the crop regressed, SMPL-X run with
the predicted parameters, and the camera-space mesh converted into image
space with the virtual-focal scaling (per-box focal f = 5000 / body shape x
box size, principal point at the box centre, x/y/z scaled by f / z_mean,
then shifted by (princpt, 500 − z̄)). One image at a time, as in
``coma_tpu``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from coma_tpu_torch.models.hand4whole import (
    FOCAL,
    INPUT_BODY_SHAPE,
    INPUT_IMG_SHAPE,
    Hand4Whole,
    crop_and_resize,
)
from coma_tpu_torch.models.keypoints import append_vertex_landmarks
from coma_tpu_torch.models.smplx import SMPLXModel, smplx_forward


def process_bbox(bbox_xywh, img_width: int, img_height: int, ratio: float = 1.25):
    """Square-expand a person box to the model's input aspect (Hand4Whole
    ``common/utils_hand4whole/preprocessing.py:process_bbox``); None when
    the box is empty."""
    x, y, w, h = bbox_xywh
    x1 = np.max((0, x))
    y1 = np.max((0, y))
    x2 = np.min((img_width - 1, x1 + np.max((0, w - 1))))
    y2 = np.min((img_height - 1, y1 + np.max((0, h - 1))))
    if w * h <= 0 or x2 < x1 or y2 < y1:
        return None
    w, h = x2 - x1, y2 - y1
    c_x, c_y = x1 + w / 2.0, y1 + h / 2.0
    aspect = INPUT_IMG_SHAPE[1] / INPUT_IMG_SHAPE[0]
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    w *= ratio
    h *= ratio
    return np.array([c_x - w / 2.0, c_y - h / 2.0, w, h], dtype=np.float32)


def crop_patch(image_rgb: np.ndarray, bbox_xywh: np.ndarray, device="cuda") -> torch.Tensor:
    """Bilinear crop of the box resized to 512x384 -> (1, 3, 512, 384) in
    [0, 1] on ``device``."""
    x, y, w, h = bbox_xywh
    box = torch.tensor([[x, y, x + w, y + h]], dtype=torch.float32, device=device)
    img = torch.as_tensor(np.ascontiguousarray(image_rgb), device=device).to(torch.float32)
    img = img.permute(2, 0, 1)[None] / 255.0
    return crop_and_resize(img, box, INPUT_IMG_SHAPE)


@dataclasses.dataclass
class MocapOutput:
    pred_vertices_img: np.ndarray   # (V, 3) pixel-space mesh
    pelvis_xyz: np.ndarray          # (3,)
    faces: np.ndarray               # (F, 3)
    smplx_data: Dict[str, np.ndarray]
    joints_proj: np.ndarray         # (J, 2) pixel-space joints
    joints_img: np.ndarray          # (J, 3) pixel-space joints with depth
    convert_data: Dict[str, Any]    # focals, princpt, z_mean


class Hand4WholeRegressor:
    """A Hand4Whole module (in eval mode, on the SMPL-X model's device) and
    the SMPL-X model it drives."""

    def __init__(self, model: Hand4Whole, smplx_model: SMPLXModel):
        self.model = model.eval()
        self.smplx_model = smplx_model
        self.device = smplx_model.device

    @torch.no_grad()
    def regress(self, image_rgb: np.ndarray, body_bbox_list) -> list:
        """image_rgb (H, W, 3) uint8; boxes xywh -> [MocapOutput]."""
        H, W = image_rgb.shape[:2]
        outputs = []
        for bbox in body_bbox_list:
            bbox = process_bbox(np.asarray(bbox, np.float32), W, H)
            if bbox is None:
                continue
            out = self.model(crop_patch(image_rgb, bbox, self.device))
            host = {k: v.cpu().numpy() for k, v in out.items()}
            smplx_data = dict(
                betas=host["shape"], global_orient=host["root_pose"], transl=host["cam_trans"],
                left_hand_pose=host["lhand_pose"], right_hand_pose=host["rhand_pose"],
                jaw_pose=host["jaw_pose"], body_pose=host["body_pose"], expression=host["expr"],
                leye_pose=np.zeros((1, 3), np.float32), reye_pose=np.zeros((1, 3), np.float32),
            )
            verts, joints = smplx_forward(
                self.smplx_model, betas=out["shape"], global_orient=out["root_pose"],
                body_pose=out["body_pose"], left_hand_pose=out["lhand_pose"],
                right_hand_pose=out["rhand_pose"], jaw_pose=out["jaw_pose"],
                expression=out["expr"])
            # the 21 vertex-picked landmarks (joint rows 55-75) that the
            # OpenPose permutations of optimize_depth index into
            joints = append_vertex_landmarks(verts, joints)
            cam_trans = host["cam_trans"][0]
            mesh_cam = verts[0].cpu().numpy() + cam_trans[None]
            joints_cam = joints[0].cpu().numpy() + cam_trans[None]
            outputs.append(convert_mesh_to_image_space(
                mesh_cam, joints_cam, bbox, self.smplx_model.faces_array, smplx_data))
        return outputs


def convert_mesh_to_image_space(
    mesh_cam: np.ndarray,     # (V, 3) camera-space mesh (with cam_trans)
    joints_cam: np.ndarray,   # (J, 3) camera-space joints
    bbox: np.ndarray,         # processed xywh box in the original image
    faces: np.ndarray,
    smplx_data: Dict[str, np.ndarray],
) -> MocapOutput:
    """The pixel-space conversion the downstream geometry depends on
    (``prepare_bodymocap.py:89-144``); numpy, as ``coma_tpu``'s."""
    focal = [
        FOCAL[0] / INPUT_BODY_SHAPE[1] * bbox[2],
        FOCAL[1] / INPUT_BODY_SHAPE[0] * bbox[3],
    ]
    princpt = [
        (INPUT_BODY_SHAPE[1] / 2) / INPUT_BODY_SHAPE[1] * bbox[2] + bbox[0],
        (INPUT_BODY_SHAPE[0] / 2) / INPUT_BODY_SHAPE[0] * bbox[3] + bbox[1],
    ]
    z_mean = float(mesh_cam[:, 2].mean())

    def to_img(pts):
        out = pts.copy()
        out[:, 0] *= focal[0] / z_mean
        out[:, 1] *= focal[1] / z_mean
        if out.shape[1] > 2:
            out[:, 2] *= ((focal[0] + focal[1]) / 2.0) / z_mean
        return out

    mesh_img = to_img(mesh_cam)
    joints_img = to_img(joints_cam)
    z_mean_img = mesh_img[:, 2].mean()
    for arr in (mesh_img, joints_img):
        arr[:, 0] += princpt[0]
        arr[:, 1] += princpt[1]
        arr[:, 2] += 500.0 - z_mean_img

    return MocapOutput(
        pred_vertices_img=mesh_img,
        pelvis_xyz=joints_img[0].copy(),
        faces=faces.astype(np.int64),
        smplx_data=smplx_data,
        joints_proj=joints_img[:, :2].copy(),
        joints_img=joints_img.copy(),
        convert_data=dict(focals=focal, princpt=princpt, z_mean=z_mean),
    )
