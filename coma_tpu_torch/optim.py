"""Adam in optax's order of operations, shared by the fitting loops
(``pipelines/application.py``, ``lifting/depth_optimize.py``)."""
from __future__ import annotations

from typing import Dict

import torch


class OptaxAdam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a dict
    of tensors of any shape, updated in place with optax's operations in
    optax's order: mu and nu, their bias corrections 1 − b**count computed
    in float32 on the host, mu_hat / (sqrt(nu_hat) + eps), times −lr.

    The corrections reach the device by an asynchronous copy and divide as
    tensors (a host scalar as divisor would be turned into a multiplication
    by its reciprocal on the card), so a step neither waits for the device
    nor rounds otherwise than optax."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
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
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            mu_hat = self.mu[k] / c1
            nu_hat = self.nu[k] / c2
            p.add_(-self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))
