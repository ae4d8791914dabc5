"""Distribution-comparison metrics for quantitative evaluation (PyTorch).

Counterpart of ``coma_tpu/affordance/evaluation.py``. Reference parity:
``utils/evaluation.py`` — normalized MAE and SIM (histogram intersection,
Σ min(p, q)) over affordance distributions, used for the paper's
quantitative tables against BEHAVE ground truth.
"""
from __future__ import annotations

from typing import Dict

import torch


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.sum(x, dim=-1, keepdim=True) + eps)


def mean_absolute_error(src: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalized MAE between two 1-D distributions (``utils/evaluation.py:4-25``).

    Batched inputs ``(B, N)`` return the mean over the batch.
    """
    src = _normalize(src, eps)
    tgt = _normalize(tgt, eps)
    return torch.mean(torch.abs(src - tgt))


def similarity(src: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """SIM = Σ min(p, q) after normalization (``utils/evaluation.py:28-49``).

    Batched inputs ``(B, N)`` return the mean per-row SIM.
    """
    src = _normalize(src, eps)
    tgt = _normalize(tgt, eps)
    return torch.mean(torch.sum(torch.minimum(src, tgt), dim=-1))


def quant_metrics(pred: torch.Tensor, test: torch.Tensor, eps: float = 1e-12) -> Dict[str, float]:
    """Both metrics with the reference's double-normalization
    (``quant_metrics_for_two_distributions:52-78``)."""
    pred = _normalize(pred, eps)
    test = _normalize(test, eps)
    return {
        "mae": float(mean_absolute_error(pred, test, eps)),
        "sim": float(similarity(pred, test, eps)),
    }
