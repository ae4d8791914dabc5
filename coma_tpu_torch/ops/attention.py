"""K3: scaled dot-product attention, softmax(QKᵀ/√D)·V, non-causal.

Replaces ``coma_tpu/ops/attention.py:41`` (``scaled_dot_attention``), which
runs the JAX library's Pallas flash attention on the TPU for lane-aligned
long sequences and XLA's einsum chain elsewhere, with the hand-written CUDA
kernel ``csrc/flash_attention.cu``. :func:`attention_reference` is the plain
version (``_xla_attention``, ``:17-21``). On a CPU tensor
:func:`scaled_dot_attention` runs the plain version; on a CUDA tensor every
call launches the kernel — the UNet's self- and cross-attention and the VAE's
mid block alike — or raises for a head dim or dtype the kernel does not take.
"""
from __future__ import annotations

import ctypes
import math

import torch

from coma_tpu_torch.ops import build

SOURCE = "flash_attention"
HEAD_DIMS = (16, 32, 40, 64, 80, 160, 512)   # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634

# Kernel launches since import; callers may reset it to 0.
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_F, _P]


def _kernel():
    lib = build.load(SOURCE)
    fn = lib.coma_flash_attention
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D) in the input dtype."""
    scale = 1.0 / torch.tensor(q.shape[-1], dtype=torch.float32).sqrt().to(q.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale.to(q.device)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Lq, D) x (B, H, Lk, D) -> (B, H, Lq, D), softmax(QKᵀ/√D)V.

    CPU: the plain version. CUDA: one launch of K3 over all B·H slices,
    fp32 softmax and accumulation, output in the input dtype.
    """
    global launches
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    for name, t, shape in (("k", k, (B, H, Lk, D)), ("v", v, (B, H, Lk, D))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention has no instance for head dim {D}; "
                         f"it takes {HEAD_DIMS}")
    if B * H > 65535 or Lq == 0 or Lk == 0:
        raise ValueError(f"unsupported attention shape B*H={B * H}, Lq={Lq}, Lk={Lk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, Lq, Lk, D,
                  DTYPES[q.dtype], LOG2E / math.sqrt(D), stream)
    build.check(lib, code, "flash_attention launch")
    launches += 1
    return out
