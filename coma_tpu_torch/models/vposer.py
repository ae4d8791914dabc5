"""VPoser body-pose prior (PyTorch).

Counterpart of ``coma_tpu/models/vposer.py`` (reference:
``imports/vposer/vposer_smpl.py:VPoser:59``, 512 neurons, latent 32, 21
joints; the continuous-6D rotation decoder ``:43``; the priors of
``imports/vposer/prior.py``). Submodules carry ``coma_tpu``'s Flax names
(``dec_fc1``, ``enc_bn1``, ...), so ``models/flax_params.py`` maps its
params across; :func:`load_vposer_snapshot` reads a torch VPoser snapshot
by its own keys (``bodyprior_dec_fc1.weight``, ...), with no converter.

One deliberate divergence: :func:`matrot_to_aa` has the value of
``coma_tpu``'s, and a finite gradient where the clipped cosine reaches 1
(the identity, and rotations within ~3e-4 rad of it in float32), where
``coma_tpu``'s gradient is NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_tpu_torch.models.layers import Dense


@dataclasses.dataclass(frozen=True)
class VPoserConfig:
    num_neurons: int = 512
    latent_dim: int = 32
    num_joints: int = 21


def rot6d_decode(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D -> rotation matrices (N, 3, 3), VPoser's column
    convention (reference: ``vposer_smpl.py:47-56``): (-1, 3, 2) columns,
    b1 = normalize(col0), b2 = normalize(col1 - (b1·col1) b1), b3 = b1 × b2.

    A degenerate column takes the unit axis as fallback with a zero (not
    NaN) gradient: the double-where of ``coma_tpu``."""
    m = x.reshape(-1, 3, 2)

    def safe_unit(v, fallback):
        n2 = torch.sum(v * v, dim=1, keepdim=True)
        ok = n2 > 1e-12
        unit = v / torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
        return torch.where(ok, unit, fallback)

    col0, col1 = m[:, :, 0], m[:, :, 1]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device).expand_as(col0)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device).expand_as(col0)
    b1 = safe_unit(col0, ex)
    dot = torch.sum(b1 * col1, dim=1, keepdim=True)
    b2 = safe_unit(col1 - dot * b1, ey)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrot_to_aa(rotmats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3).

    The value is ``coma_tpu``'s: angle arccos of the clipped (trace - 1)/2,
    axis the normalised skew part (zero where its squared norm is below
    eps²). Where the clipped cosine equals its upper bound (1 in float32),
    arccos' is infinite and ``coma_tpu``'s gradient NaN; there the value
    stays the same and the gradient is that of the log map's Taylor branch,
    aa ≈ v (1/2 + |v|²/48) with v the skew part (θ/(2 sin θ) = 1/2 + θ²/12
    + O(θ⁴)), which is finite at the identity. Elsewhere the gradient is
    ``coma_tpu``'s formula's.
    """
    trace = rotmats[..., 0, 0] + rotmats[..., 1, 1] + rotmats[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    near = cos >= torch.tensor(1.0 - eps, dtype=cos.dtype)
    # double-where: arccos never sees the clipped 1 on the gradient path
    angle = torch.where(near, torch.zeros_like(cos),
                        torch.arccos(torch.where(near, torch.zeros_like(cos), cos)))
    v = torch.stack(
        [
            rotmats[..., 2, 1] - rotmats[..., 1, 2],
            rotmats[..., 0, 2] - rotmats[..., 2, 0],
            rotmats[..., 1, 0] - rotmats[..., 0, 1],
        ],
        dim=-1,
    )
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    safe = n2 > eps * eps
    denom = torch.sqrt(torch.where(safe, n2, torch.ones_like(n2)))
    axis = torch.where(safe, v / denom, torch.zeros_like(v))
    aa = axis * angle[..., None]
    taylor = v * (0.5 + n2 / 48.0)
    # adds exactly 0 to the value; carries the Taylor branch's gradient
    return aa + torch.where(near[..., None], taylor - taylor.detach(), torch.zeros_like(v))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class VPoserDecoder(nn.Module):
    """Latent (B, 32) -> body pose (B, 63) axis-angle, or (B, 21, 3, 3)."""

    def __init__(self, config: VPoserConfig = VPoserConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        self.dec_fc1 = Dense(cfg.latent_dim, cfg.num_neurons, device=device)
        self.dec_fc2 = Dense(cfg.num_neurons, cfg.num_neurons, device=device)
        self.dec_out = Dense(cfg.num_neurons, cfg.num_joints * 6, device=device)

    def forward(self, z: torch.Tensor, output_type: str = "aa") -> torch.Tensor:
        cfg = self.config
        h = leaky_relu(self.dec_fc1(z))
        h = leaky_relu(self.dec_fc2(h))
        rotmats = rot6d_decode(self.dec_out(h)).reshape(-1, cfg.num_joints, 3, 3)
        if output_type == "aa":
            return matrot_to_aa(rotmats).reshape(-1, cfg.num_joints * 3)
        return rotmats


class RunningBatchNorm(nn.Module):
    """Batch norm with running statistics only (``flax.linen.BatchNorm(
    use_running_average=True)``, eps 1e-5), in Flax's order of operations."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class VPoserEncoder(nn.Module):
    """Pose (B, 63) -> (mean, std) of the latent Normal."""

    def __init__(self, config: VPoserConfig = VPoserConfig(), device=None):
        super().__init__()
        cfg = self.config = config
        n_in = cfg.num_joints * 3
        self.enc_bn1 = RunningBatchNorm(n_in, device=device)
        self.enc_fc1 = Dense(n_in, cfg.num_neurons, device=device)
        self.enc_bn2 = RunningBatchNorm(cfg.num_neurons, device=device)
        self.enc_fc2 = Dense(cfg.num_neurons, cfg.num_neurons, device=device)
        self.enc_mu = Dense(cfg.num_neurons, cfg.latent_dim, device=device)
        self.enc_logvar = Dense(cfg.num_neurons, cfg.latent_dim, device=device)

    def forward(self, pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = pose.reshape(pose.shape[0], -1)
        x = leaky_relu(self.enc_fc1(self.enc_bn1(x)))
        x = leaky_relu(self.enc_fc2(self.enc_bn2(x)))
        return self.enc_mu(x), F.softplus(self.enc_logvar(x))


# --- priors (reference: imports/vposer/prior.py) ---

ANGLE_PRIOR_IDXS = np.array([55, 58, 12, 15], dtype=np.int64) - 3  # no global pose
ANGLE_PRIOR_SIGNS = np.array([1.0, -1.0, -1.0, -1.0], dtype=np.float32)


def smplify_angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """exp(pose[elbows, knees] * sign)² (reference: ``prior.py:53-86``)."""
    idx = torch.as_tensor(ANGLE_PRIOR_IDXS, device=body_pose.device)
    signs = torch.as_tensor(ANGLE_PRIOR_SIGNS, dtype=body_pose.dtype, device=body_pose.device)
    return torch.exp(body_pose[:, idx] * signs) ** 2


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x)


SNAPSHOT_PREFIX = "bodyprior_"


def vposer_state_dict(snapshot: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A torch VPoser ``state_dict`` (or a dict holding one under
    ``"state_dict"``) -> float32 arrays by the decoder's and encoder's own
    names (``dec_*``, ``enc_*``: the ``bodyprior_`` prefix dropped, batch
    norm's ``num_batches_tracked`` too). Any other key raises."""
    sd = snapshot.get("state_dict", snapshot) if isinstance(snapshot, Mapping) else snapshot
    ours = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        name = key[len(SNAPSHOT_PREFIX):]
        if not key.startswith(SNAPSHOT_PREFIX) or name[:4] not in ("dec_", "enc_"):
            raise KeyError(f"VPoser snapshot: unused key {key}")
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
        ours[name] = np.asarray(value, dtype=np.float32)
    return ours


@torch.no_grad()
def load_vposer_snapshot(
    snapshot: Mapping[str, object],
    config: VPoserConfig = VPoserConfig(),
    device="cuda",
) -> Tuple[Optional[VPoserEncoder], VPoserDecoder]:
    """A torch VPoser ``state_dict`` (or a dict holding one under
    ``"state_dict"``) -> (encoder, decoder) in eval mode. The decoder's keys
    are required; the encoder is ``None`` when the snapshot has none of its
    keys. A key of either half that is missing or unused raises."""
    ours = {k: torch.as_tensor(v) for k, v in vposer_state_dict(snapshot).items()}

    def load(module, prefix):
        given = {k: v for k, v in ours.items() if k.startswith(prefix)}
        target = module.state_dict()
        missing, unused = sorted(set(target) - set(given)), sorted(set(given) - set(target))
        if missing or unused:
            raise KeyError(f"VPoser snapshot: missing {missing}, unused {unused}")
        for k, v in given.items():
            if tuple(v.shape) != tuple(target[k].shape):
                raise ValueError(f"VPoser snapshot {SNAPSHOT_PREFIX}{k}: shape "
                                 f"{tuple(v.shape)}, module has {tuple(target[k].shape)}")
        module.load_state_dict(given)
        return module.eval()

    dec = load(VPoserDecoder(config, device=device), "dec_")
    has_enc = any(k.startswith("enc_") for k in ours)
    enc = load(VPoserEncoder(config, device=device), "enc_") if has_enc else None
    return enc, dec
