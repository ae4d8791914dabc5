"""Adam in optax's order of operations, shared by the fitting loops
(``pipelines/application.py``, ``lifting/depth_optimize.py``) and, as AdamW
on a warmup-cosine schedule, by the segmenter's training
(``models/segmentation_train.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Union

import numpy as np
import torch


class OptaxAdam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a dict
    of tensors of any shape, updated in place with optax's operations in
    optax's order: mu and nu, their bias corrections 1 − b**count computed
    in float32 on the host, mu_hat / (sqrt(nu_hat) + eps), times −lr.

    With ``weight_decay`` it is ``optax.adamw``: ``+ weight_decay · param``
    after Adam's direction and before the learning rate. ``lr`` may be a
    schedule, ``lr(count) -> float``, indexed as optax's
    ``scale_by_schedule`` indexes it (0 on the first step).

    The corrections reach the device by an asynchronous copy and divide as
    tensors (a host scalar as divisor would be turned into a multiplication
    by its reciprocal on the card), so a step neither waits for the device
    nor rounds otherwise than optax."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        p0 = next(iter(params.values()))
        corrections = torch.stack([1 - torch.tensor(b, dtype=p0.dtype) ** self.count
                                   for b in (self.b1, self.b2)])
        c1, c2 = corrections.to(p0.device, non_blocking=True)
        lr = self.lr(self.count - 1) if callable(self.lr) else self.lr
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            mu_hat = self.mu[k] / c1
            nu_hat = self.nu[k] / c2
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(-lr * update)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``, evaluated in float32 as optax
    evaluates it inside a jitted step: a linear ramp from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``."""
    f32 = np.float32
    alpha = f32(0.0 if peak_value == 0.0 else end_value / peak_value)
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return (f32(init_value) - f32(peak_value)) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = np.minimum(f32(count), f32(cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps)))
        return f32(peak_value) * ((f32(1) - alpha) * decay + alpha)

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps else cosine(count - warmup_steps))

    return schedule
