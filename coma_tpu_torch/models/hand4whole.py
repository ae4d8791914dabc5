"""Hand4Whole whole-body 3D human regressor (PyTorch, NCHW).

Counterpart of ``coma_tpu/models/hand4whole.py`` (reference:
``imports/hand4whole/main/model.py:14-394`` and ``common/nets/module.py``):
ResNet-50 body and hand towers and a ResNet-18 face tower, PositionNet
(soft-argmax 3D joint heat maps), BoxNet (hand and face boxes from the body
features), RotationNet (6D rotations from joint-sampled features),
FaceRegressor and the virtual-focal camera translation, at the published
widths (``main/config.py:19-30``: input 512x384, body 256x192, hand 256²,
face 192²). Submodules carry ``coma_tpu``'s Flax names, so
``models/flax_params.py`` carries its ``params`` and ``batch_stats``
across; :func:`hand4whole_state_dict` reads ``snapshot_6.pth.tar``'s
``network`` layout directly.

Where ``coma_tpu`` flips NHWC axis 2 (the left hand's crop and features),
the port flips NCHW axis 3. The bilinear sampling clamps to the edge with
the left corner clipped to W − 2 (``sample_joint_features``), a rule
neither ``grid_sample`` nor ``ops/sampling.py`` has.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.geometry.transforms import rot6d_to_rotmat
from coma_tpu_torch.models.layers import Dense
from coma_tpu_torch.models.resnet import BatchNorm, ResNet
from coma_tpu_torch.models.vposer import matrot_to_aa

# --- config (reference: main/config.py) ---
INPUT_IMG_SHAPE = (512, 384)     # (H, W)
INPUT_BODY_SHAPE = (256, 192)
OUTPUT_HM_SHAPE = (8, 8, 6)      # (D, H, W)
INPUT_HAND_SHAPE = (256, 256)
OUTPUT_HAND_HM_SHAPE = (8, 8, 8)
INPUT_FACE_SHAPE = (192, 192)
FOCAL = (5000.0, 5000.0)
PRINCPT = (INPUT_BODY_SHAPE[1] / 2, INPUT_BODY_SHAPE[0] / 2)
CAMERA_3D_SIZE = 2.5

NUM_BODY_POS_JOINTS = 25         # smpl_x.pos_joint_part['body']
NUM_HAND_POS_JOINTS = 20         # per hand
NUM_BODY_ROT_JOINTS = 21         # body joints minus the root
NUM_HAND_ROT_JOINTS = 15
SHAPE_PARAM_DIM = 10
EXPR_CODE_DIM = 10
# MCP joint indices within each hand's 20 position joints (human_models.py:496-506)
L_MCP = (4, 8, 12, 16)
R_MCP = (4, 8, 12, 16)
FEAT_BODY = FEAT_HAND = 2048
FEAT_FACE = 512


def rot6d_to_axis_angle(x6d: torch.Tensor) -> torch.Tensor:
    """(N, 6) -> (N, 3) axis-angle (reference: transforms.rot6d_to_axis_angle)."""
    return matrot_to_aa(rot6d_to_rotmat(x6d))


def soft_argmax_3d(hm: torch.Tensor):
    """(B, J, D, H, W) -> ((B, J, 3) expected (x, y, z), the probabilities)."""
    B, J, D, H, W = hm.shape
    p = torch.softmax(hm.reshape(B, J, -1), dim=2).reshape(B, J, D, H, W)
    idx = lambda n: torch.arange(n, dtype=hm.dtype, device=hm.device)
    x = torch.einsum("bjdhw,w->bj", p, idx(W))
    y = torch.einsum("bjdhw,h->bj", p, idx(H))
    z = torch.einsum("bjdhw,d->bj", p, idx(D))
    return torch.stack([x, y, z], dim=2), p


def soft_argmax_2d(hm: torch.Tensor) -> torch.Tensor:
    """(B, J, H, W) -> (B, J, 2) expected (x, y)."""
    B, J, H, W = hm.shape
    p = torch.softmax(hm.reshape(B, J, -1), dim=2).reshape(B, J, H, W)
    x = torch.einsum("bjhw,w->bj", p, torch.arange(W, dtype=hm.dtype, device=hm.device))
    y = torch.einsum("bjhw,h->bj", p, torch.arange(H, dtype=hm.dtype, device=hm.device))
    return torch.stack([x, y], dim=2)


def sample_joint_features(feat: torch.Tensor, joint_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of feat (B, C, H, W) at (B, J, 2) feature-map pixel
    coordinates (align_corners=True convention) -> (B, J, C). Coordinates
    clamp to the map; the left/top corner clamps to W − 2 / H − 2."""
    B, C, H, W = feat.shape
    x = torch.clamp(joint_xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(joint_xy[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = (x - x0)[:, :, None]
    fy = (y - y0)[:, :, None]
    flat = feat.reshape(B, C, H * W)

    def at(yy, xx):
        index = (yy * W + xx)[:, None, :].expand(B, C, -1)
        return torch.gather(flat, 2, index).transpose(1, 2)           # (B, J, C)

    return (at(y0, x0) * ((1 - fx) * (1 - fy)) + at(y0, x0 + 1) * (fx * (1 - fy))
            + at(y0 + 1, x0) * ((1 - fx) * fy) + at(y0 + 1, x0 + 1) * (fx * fy))


def crop_and_resize(images: torch.Tensor, boxes_xyxy: torch.Tensor,
                    out_shape: Tuple[int, int]) -> torch.Tensor:
    """Dense bilinear ROI crop of images (B, C, H, W) at boxes (B, 4) in
    pixel coordinates -> (B, C, oh, ow) (roi_align(aligned=False)'s
    approximation, as ``coma_tpu``)."""
    B, C = images.shape[:2]
    oh, ow = out_shape
    dt, dev = images.dtype, images.device
    x0, y0, x1, y1 = (boxes_xyxy[:, k:k + 1] for k in range(4))
    xs = x0 + (torch.arange(ow, dtype=dt, device=dev) + 0.5) / ow * (x1 - x0) - 0.5  # (B, ow)
    ys = y0 + (torch.arange(oh, dtype=dt, device=dev) + 0.5) / oh * (y1 - y0) - 0.5  # (B, oh)
    grid = torch.stack([xs[:, None, :].expand(B, oh, ow), ys[:, :, None].expand(B, oh, ow)],
                       dim=-1).reshape(B, oh * ow, 2)
    out = sample_joint_features(images, grid)                          # (B, oh*ow, C)
    return out.transpose(1, 2).reshape(B, C, oh, ow)


def restore_bbox(center: torch.Tensor, size: torch.Tensor, aspect: float,
                 extension: float) -> torch.Tensor:
    """Box centre and size -> aspect-corrected, extended xyxy
    (``main/model.py:restore_bbox``)."""
    w = size[:, 0:1]
    h = size[:, 1:2]
    w = torch.maximum(w, h * aspect)
    h = w / aspect
    w = w * extension
    h = h * extension
    return torch.cat([center[:, 0:1] - w / 2, center[:, 1:2] - h / 2,
                      center[:, 0:1] + w / 2, center[:, 1:2] + h / 2], dim=1)


def get_camera_trans(cam_param: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> translation (B, 3) with the virtual-focal k-value
    (``main/model.py:get_camera_trans:46-53``)."""
    gamma = torch.sigmoid(cam_param[:, 2])
    k = math.sqrt(FOCAL[0] * FOCAL[1] * CAMERA_3D_SIZE * CAMERA_3D_SIZE
                  / (INPUT_BODY_SHAPE[0] * INPUT_BODY_SHAPE[1]))
    return torch.cat([cam_param[:, :2], (k * gamma)[:, None]], dim=1)


class PositionNet(nn.Module):
    def __init__(self, joint_num: int, hm_shape: Tuple[int, int, int], feat_dim: int):
        super().__init__()
        self.joint_num, self.hm_shape = joint_num, hm_shape
        self.conv = nn.Conv2d(feat_dim, joint_num * hm_shape[0], 1)

    def forward(self, feat):                              # (B, 2048, h, w)
        D, H, W = self.hm_shape
        hm = self.conv(feat).reshape(feat.shape[0], self.joint_num, D, H, W)
        coord, prob = soft_argmax_3d(hm)
        return prob, coord


def _conv_bn_relu(conv: nn.Conv2d, bn: BatchNorm, x):
    return F.relu(bn(conv(x)))


class RotationNetBody(nn.Module):
    def __init__(self):
        super().__init__()
        self.shape_out = Dense(FEAT_BODY, SHAPE_PARAM_DIM)
        self.cam_out = Dense(FEAT_BODY, 3)
        for name, cin in (("body", FEAT_BODY), ("lhand", FEAT_HAND), ("rhand", FEAT_HAND)):
            self.add_module(f"{name}_conv", nn.Conv2d(cin, 512, 1, bias=False))
            self.add_module(f"{name}_bn", BatchNorm(512))
        n_in = (NUM_BODY_POS_JOINTS + len(L_MCP) + len(R_MCP)) * (512 + 3)
        self.root_pose_out = Dense(n_in, 6)
        self.body_pose_out = Dense(n_in, NUM_BODY_ROT_JOINTS * 6)

    def forward(self, img_feat, joint_img, lhand_feat, lhand_mcp, rhand_feat, rhand_mcp):
        pooled = img_feat.mean(dim=(2, 3))
        shape = self.shape_out(pooled)
        cam = self.cam_out(pooled)
        parts = []
        for name, feat, joints in (("body", img_feat, joint_img), ("lhand", lhand_feat, lhand_mcp),
                                   ("rhand", rhand_feat, rhand_mcp)):
            x = _conv_bn_relu(getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn"), feat)
            parts.append(torch.cat([sample_joint_features(x, joints[:, :, :2]), joints], dim=2))
        flat = torch.cat(parts, dim=1).flatten(1)
        return self.root_pose_out(flat), self.body_pose_out(flat), shape, cam


class RotationNetHand(nn.Module):
    def __init__(self):
        super().__init__()
        self.hand_conv = nn.Conv2d(FEAT_HAND, 512, 1, bias=False)
        self.hand_bn = BatchNorm(512)
        self.hand_pose_out = Dense(NUM_HAND_POS_JOINTS * (512 + 3), NUM_HAND_ROT_JOINTS * 6)

    def forward(self, img_feat, joint_img):
        x = _conv_bn_relu(self.hand_conv, self.hand_bn, img_feat)
        feat = torch.cat([sample_joint_features(x, joint_img[:, :, :2]), joint_img], dim=2)
        return self.hand_pose_out(feat.flatten(1))


class BoxNet(nn.Module):
    def __init__(self):
        super().__init__()
        cin = FEAT_BODY + NUM_BODY_POS_JOINTS * OUTPUT_HM_SHAPE[0]
        for i in range(3):
            # torch's (k 4, s 2, p 1) doubles H exactly: Flax's padding 'SAME'
            self.add_module(f"deconv_{i}", nn.ConvTranspose2d(cin, 256, 4, stride=2,
                                                              padding=1, bias=False))
            self.add_module(f"deconv_bn_{i}", BatchNorm(256))
            cin = 256
        self.bbox_center = nn.Conv2d(256, 3, 1)
        for head in ("lhand_size", "rhand_size", "face_size"):
            self.add_module(f"{head}_fc0", Dense(256, 256))
            self.add_module(f"{head}_fc1", Dense(256, 2))

    def forward(self, img_feat, joint_hm, joint_img):
        B = img_feat.shape[0]
        D, Hh, Wh = OUTPUT_HM_SHAPE
        x = torch.cat([img_feat, joint_hm.reshape(B, NUM_BODY_POS_JOINTS * D, Hh, Wh)], dim=1)
        for i in range(3):
            x = F.relu(getattr(self, f"deconv_bn_{i}")(getattr(self, f"deconv_{i}")(x)))
        center = soft_argmax_2d(self.bbox_center(x))                    # (B, 3, 2)

        def size_head(name, c):
            f = sample_joint_features(x, c[:, None, :])[:, 0]
            h = F.relu(getattr(self, f"{name}_fc0")(f))
            return getattr(self, f"{name}_fc1")(h)

        lc, rc, fc = center[:, 0], center[:, 1], center[:, 2]
        return (lc / 8, size_head("lhand_size", lc), rc / 8, size_head("rhand_size", rc),
                fc / 8, size_head("face_size", fc))


class FaceRegressor(nn.Module):
    def __init__(self):
        super().__init__()
        self.expr_out = Dense(FEAT_FACE, EXPR_CODE_DIM)
        self.jaw_pose_out = Dense(FEAT_FACE, 6)

    def forward(self, feat):
        pooled = feat.mean(dim=(2, 3))
        return self.expr_out(pooled), self.jaw_pose_out(pooled)


class Hand4Whole(nn.Module):
    """Image (B, 3, 512, 384), normalised to [0, 1] -> SMPL-X parameters:
    dict(root_pose, body_pose, lhand_pose, rhand_pose, jaw_pose (axis-angle),
    shape, expr, cam_trans, body_joint_img, lhand_bbox, rhand_bbox,
    face_bbox)."""

    def __init__(self):
        super().__init__()
        self.body_backbone = ResNet((3, 4, 6, 3), True)
        self.body_position_net = PositionNet(NUM_BODY_POS_JOINTS, OUTPUT_HM_SHAPE, FEAT_BODY)
        self.box_net = BoxNet()
        self.hand_backbone = ResNet((3, 4, 6, 3), True)
        self.hand_position_net = PositionNet(NUM_HAND_POS_JOINTS, OUTPUT_HAND_HM_SHAPE,
                                             FEAT_HAND)
        self.hand_rotation_net = RotationNetHand()
        self.body_rotation_net = RotationNetBody()
        self.face_backbone = ResNet((2, 2, 2, 2), False)
        self.face_regressor = FaceRegressor()

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = img.shape[0]
        # jax.image.resize's "bilinear" antialiases; the 2x reduction's taps
        # (1, 3, 3, 1)/8, renormalised at the border, are PyTorch's too
        body_img = F.interpolate(img, size=INPUT_BODY_SHAPE, mode="bilinear",
                                 align_corners=False, antialias=True)
        img_feat = self.body_backbone(body_img)                          # (B, 2048, 8, 6)
        joint_hm, joint_img = self.body_position_net(img_feat)

        lc, lsize, rc, rsize, fc, fsize = self.box_net(img_feat, joint_hm.detach(),
                                                       joint_img.detach())
        aspect_hand = INPUT_HAND_SHAPE[1] / INPUT_HAND_SHAPE[0]
        lhand_bbox = restore_bbox(lc, lsize, aspect_hand, 2.0).detach()
        rhand_bbox = restore_bbox(rc, rsize, aspect_hand, 2.0).detach()
        face_bbox = restore_bbox(fc, fsize, INPUT_FACE_SHAPE[1] / INPUT_FACE_SHAPE[0],
                                 1.5).detach()

        # box coordinates live in body-crop space; scale to full-image pixels
        scale = torch.tensor([INPUT_IMG_SHAPE[1] / INPUT_BODY_SHAPE[1],
                              INPUT_IMG_SHAPE[0] / INPUT_BODY_SHAPE[0]] * 2,
                             dtype=img.dtype, device=img.device)
        lhand_img = crop_and_resize(img, lhand_bbox * scale, INPUT_HAND_SHAPE).flip(3)
        rhand_img = crop_and_resize(img, rhand_bbox * scale, INPUT_HAND_SHAPE)
        hand_feat = self.hand_backbone(torch.cat([lhand_img, rhand_img], dim=0))

        _, hand_joint_img = self.hand_position_net(hand_feat)
        hand_pose6d = self.hand_rotation_net(hand_feat, hand_joint_img.detach())
        hand_pose = rot6d_to_axis_angle(hand_pose6d.reshape(-1, 6)).reshape(2 * B, -1)

        lhand_joint_img = hand_joint_img[:B]
        lhand_joint_img = torch.cat([OUTPUT_HAND_HM_SHAPE[2] - 1 - lhand_joint_img[:, :, 0:1],
                                     lhand_joint_img[:, :, 1:]], dim=2)
        rhand_joint_img = hand_joint_img[B:]
        lhand_pose = hand_pose[:B].reshape(B, NUM_HAND_ROT_JOINTS, 3)
        lhand_pose = torch.cat([lhand_pose[:, :, 0:1], -lhand_pose[:, :, 1:3]],
                               dim=2).reshape(B, -1)
        rhand_pose = hand_pose[B:]
        lhand_feat = hand_feat[:B].flip(3)
        rhand_feat = hand_feat[B:]

        root6d, body6d, shape, cam = self.body_rotation_net(
            img_feat, joint_img.detach(), lhand_feat, lhand_joint_img[:, list(L_MCP)].detach(),
            rhand_feat, rhand_joint_img[:, list(R_MCP)].detach())
        root_pose = rot6d_to_axis_angle(root6d)
        body_pose = rot6d_to_axis_angle(body6d.reshape(-1, 6)).reshape(B, -1)
        cam_trans = get_camera_trans(cam)

        face_img = crop_and_resize(img, face_bbox * scale, INPUT_FACE_SHAPE)
        expr, jaw6d = self.face_regressor(self.face_backbone(face_img))
        jaw_pose = rot6d_to_axis_angle(jaw6d)
        return dict(root_pose=root_pose, body_pose=body_pose, lhand_pose=lhand_pose,
                    rhand_pose=rhand_pose, jaw_pose=jaw_pose, shape=shape, expr=expr,
                    cam_trans=cam_trans, body_joint_img=joint_img, lhand_bbox=lhand_bbox,
                    rhand_bbox=rhand_bbox, face_bbox=face_bbox)


# ---------------------------------------------------------------------------
# The published checkpoint's layout (snapshot_6.pth.tar's ``network``)
# ---------------------------------------------------------------------------

_RESNET_RULES = (
    (r"^(conv1|bn1)\.", r"\1."),
    (r"^layer(\d)\.(\d+)\.downsample\.0\.", r"layer\1_\2.down_conv."),
    (r"^layer(\d)\.(\d+)\.downsample\.1\.", r"layer\1_\2.down_bn."),
    (r"^layer(\d)\.(\d+)\.", r"layer\1_\2."),
)
_TOWERS = (("backbone.", "body_backbone."), ("hand_roi_net.backbone.", "hand_backbone."),
           ("face_roi_net.backbone.", "face_backbone."))
_HEAD_RULES = (
    (r"^(body|hand)_position_net\.conv\.0\.", r"\1_position_net.conv."),
    (r"^body_rotation_net\.(body|lhand|rhand)_conv\.0\.", r"body_rotation_net.\1_conv."),
    (r"^body_rotation_net\.(body|lhand|rhand)_conv\.1\.", r"body_rotation_net.\1_bn."),
    (r"^body_rotation_net\.(root_pose_out|body_pose_out|shape_out|cam_out)\.0\.",
     r"body_rotation_net.\1."),
    (r"^hand_rotation_net\.hand_conv\.0\.", "hand_rotation_net.hand_conv."),
    (r"^hand_rotation_net\.hand_conv\.1\.", "hand_rotation_net.hand_bn."),
    (r"^hand_rotation_net\.hand_pose_out\.0\.", "hand_rotation_net.hand_pose_out."),
    (r"^box_net\.deconv\.0\.", "box_net.deconv_0."),
    (r"^box_net\.deconv\.1\.", "box_net.deconv_bn_0."),
    (r"^box_net\.deconv\.3\.", "box_net.deconv_1."),
    (r"^box_net\.deconv\.4\.", "box_net.deconv_bn_1."),
    (r"^box_net\.deconv\.6\.", "box_net.deconv_2."),
    (r"^box_net\.deconv\.7\.", "box_net.deconv_bn_2."),
    (r"^box_net\.bbox_center\.0\.", "box_net.bbox_center."),
    (r"^box_net\.(lhand_size|rhand_size|face_size)\.0\.", r"box_net.\1_fc0."),
    (r"^box_net\.(lhand_size|rhand_size|face_size)\.2\.", r"box_net.\1_fc1."),
    (r"^face_regressor\.(expr_out|jaw_pose_out)\.0\.", r"face_regressor.\1."),
)
# biased convs in front of a batch norm (nets/layer.py:make_conv_layers): the
# bias is folded into the norm's running mean, mean' = mean − b
_FOLDED = {f"body_rotation_net.{t}_conv.bias": f"body_rotation_net.{t}_bn.running_mean"
           for t in ("body", "lhand", "rhand")}
_FOLDED["hand_rotation_net.hand_conv.bias"] = "hand_rotation_net.hand_bn.running_mean"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def hand4whole_state_dict(network: Mapping) -> Dict[str, np.ndarray]:
    """``snapshot_6.pth.tar``'s ``network`` state dict (``module.``-prefixed
    names, or the whole snapshot holding it) -> the port's parameter names:
    the towers' torchvision names become ``layer{i}_{j}``/``down_*``, the
    ``Sequential`` indices their Flax names, and the RotationNets' conv
    biases are folded into the following norm's running mean (the port's
    convs there have no bias, as ``coma_tpu``'s). BatchNorm's
    ``num_batches_tracked`` is dropped."""
    if "network" in network:
        network = network["network"]
    src = {(k[len("module."):] if k.startswith("module.") else k): v
           for k, v in network.items() if not k.endswith("num_batches_tracked")}
    out, folded = {}, {}
    for key, value in src.items():
        arr = _np(value)
        name = None
        for prefix, target in _TOWERS:
            if key.startswith(prefix):
                rest = key[len(prefix):]
                for pattern, repl in _RESNET_RULES:
                    new, n = re.subn(pattern, repl, rest)
                    if n:
                        name = target + new
                        break
                break
        if name is None:
            name = key
            for pattern, repl in _HEAD_RULES:
                new, n = re.subn(pattern, repl, key)
                if n:
                    name = new
                    break
        if name in _FOLDED:
            folded[_FOLDED[name]] = arr
            continue
        out[name] = arr
    for mean_key, bias in folded.items():
        out[mean_key] = out[mean_key] - bias
    return out


def load_hand4whole_weights(model: Hand4Whole, path: str) -> Hand4Whole:
    """A Flax ``.npz`` params store (or pickled Flax tree) through
    ``models/flax_params.py``, or a torch checkpoint in the published
    ``network`` layout (``torch.load(weights_only=True)``)."""
    import pickle

    from coma_tpu_torch.models.flax_params import load_flax_params, load_state_strict
    from coma_tpu_torch.utils.checkpoint import load_params

    if path.endswith(".npz"):
        return load_flax_params(model, load_params(path))
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as fh:
            return load_flax_params(model, pickle.load(fh))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_state_strict(model, hand4whole_state_dict(sd))
