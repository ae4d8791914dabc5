"""Training loop for the person segmenter (the PointRend replacement).

Counterpart of ``coma_tpu/models/segmentation_train.py``. The reference
depends on a pretrained detectron2 PointRend checkpoint
(``src/generation/segment_human.py:24``, weights external); the in-tree
:class:`~coma_tpu_torch.models.segmentation.PersonSegmenter` is a U-Net with
the same role, trained here under autograd with ``optax.adamw``'s arithmetic
(``optim.OptaxAdam`` with weight decay and a schedule). One process, one
device: ``coma_tpu``'s data-parallel step over a mesh is not ported.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
import torch.nn.functional as F

from coma_tpu_torch.models.segmentation import PersonSegmenter
from coma_tpu_torch.optim import OptaxAdam


def bce_dice_loss(logits: torch.Tensor, masks: torch.Tensor, dice_weight: float = 1.0):
    """Pixel BCE + soft-Dice (the standard binary-seg pair; Dice keeps small
    persons from washing out under class imbalance). masks in {0, 1}."""
    logits = logits.float()
    masks = masks.float()
    # optax.sigmoid_binary_cross_entropy
    bce = torch.mean(-masks * F.logsigmoid(logits) - (1.0 - masks) * F.logsigmoid(-logits))
    probs = torch.sigmoid(logits)
    inter = torch.sum(probs * masks, dim=(1, 2))
    denom = torch.sum(probs, dim=(1, 2)) + torch.sum(masks, dim=(1, 2))
    dice = 1.0 - torch.mean((2.0 * inter + 1.0) / (denom + 1.0))
    return bce + dice_weight * dice


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


class SegTrainer:
    """Train and evaluate a :class:`PersonSegmenter` in place.

    Usage::

        trainer = SegTrainer(PersonSegmenter(device="cuda"), lr=3e-4)
        for images, masks in loader:          # (B, H, W, 3), (B, H, W) on the card
            loss = trainer.step(images, masks)
    """

    def __init__(self, model: PersonSegmenter, lr: Union[float, Callable[[int], float]],
                 weight_decay: float = 1e-4):
        self.model = model
        self.params = dict(model.named_parameters())
        self.opt = OptaxAdam(self.params, lr, weight_decay=weight_decay)

    def loss_fn(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        return bce_dice_loss(self.model(_nchw(images)), masks)

    def step(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """One AdamW step on a batch; returns the loss before the update (on
        the device, not synchronised)."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss = self.loss_fn(images, masks)
        loss.backward()
        self.opt.step(self.params, {k: p.grad for k, p in self.params.items()})
        return loss.detach()

    @torch.no_grad()
    def iou(self, images: torch.Tensor, masks: torch.Tensor, threshold: float = 0.5):
        self.model.eval()
        probs = torch.sigmoid(self.model(_nchw(images)))
        pred = (probs >= threshold).float()
        inter = torch.sum(pred * masks, dim=(1, 2))
        union = torch.sum(torch.maximum(pred, masks), dim=(1, 2))
        return torch.mean(inter / torch.clamp(union, min=1.0))


def synthetic_person_batch(rng, batch: int, size: int = 64):
    """Procedural training pairs: a bright person-ish ellipse blob on a dark
    textured background (smoke-test data; real training uses COCO-person or
    rendered SMPL-X silhouettes)."""
    imgs = rng.uniform(0.0, 0.35, size=(batch, size, size, 3)).astype(np.float32)
    masks = np.zeros((batch, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(batch):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        ry = rng.integers(size // 8, size // 3)
        rx = max(2, int(ry * rng.uniform(0.35, 0.6)))  # person-ish aspect
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        masks[i][m] = 1.0
        tint = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
        imgs[i][m] = tint * rng.uniform(0.7, 1.0)
    return imgs, masks
