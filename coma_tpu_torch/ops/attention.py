"""K3: scaled dot-product attention, softmax(QKᵀ/√D)·V, non-causal.

Replaces ``coma_tpu/ops/attention.py:41`` (``scaled_dot_attention``), which
runs the JAX library's Pallas flash attention on the TPU for lane-aligned
long sequences and XLA's einsum chain elsewhere, with two hand-written CUDA
kernels chosen by dtype alone: bf16 goes to ``csrc/flash_attention_sm90.cu``
(tensor cores through ``wgmma``, TMA-fed shared-memory tiles) and float32 to
``csrc/flash_attention.cu`` (the FP32 pipes: register-tiled scores and P·V
fed by ``cp.async`` rings, one softmax reduction per key tile; FFMA, no TF32,
as the 67 TFLOP/s FP32 rate bounds it). :func:`attention_reference` is
the plain version (``_xla_attention``, ``:17-21``). On a CPU tensor
:func:`scaled_dot_attention` runs the plain version; on a CUDA tensor every
call launches a kernel — the UNet's self- and cross-attention and the VAE's
mid block alike — or raises for a head dim, dtype or alignment the kernels
do not take.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from coma_tpu_torch.ops import build

HEAD_DIMS = (16, 32, 40, 64, 80, 160, 512)   # the kernels' template instances
# dtype -> (source under csrc/, C entry point)
KERNELS = {
    torch.bfloat16: ("flash_attention_sm90", "coma_flash_attention_bf16"),
    torch.float32: ("flash_attention", "coma_flash_attention_f32"),
}
ALIGN = 16   # bytes: TMA's base-address alignment, and the f32 kernel's vector loads
LOG2E = 1.4426950408889634

# Kernel launches since import, both routes, per source, and per shape
# ((B, H, Lq, Lk, D, dtype name) -> launches); callers may reset them.
launches = 0
source_launches = {source: 0 for source, _ in KERNELS.values()}
shape_launches = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_F, _P]


def _kernel(dtype: torch.dtype):
    source, entry = KERNELS[dtype]
    lib = build.load(source)
    fn = getattr(lib, entry)
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

    CPU: the plain version; on the ``meta`` device too, where it has no
    data and only its shapes and operations count. CUDA: one launch over all B·H slices, routed by
    dtype alone — bf16 to the tensor-core kernel (``flash_attention_sm90.cu``:
    fp32 scores and softmax, P fed to the tensor cores as two bf16 terms),
    float32 to the FP32-pipe kernel (``flash_attention.cu``); output in the
    input dtype. Inputs must start on a 16-byte boundary: a tensor that does
    not raises, it is not copied.
    """
    global launches
    if q.device.type in ("cpu", "meta"):
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
    if q.dtype not in KERNELS:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention has no instance for head dim {D}; "
                         f"it takes {HEAD_DIMS}")
    if B * H > 65535 or Lq == 0 or Lk == 0:
        raise ValueError(f"unsupported attention shape B*H={B * H}, Lq={Lq}, Lk={Lk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} starts at {t.data_ptr():#x}, not on a {ALIGN}-byte "
                             "boundary; the attention kernels need aligned inputs")
    out = torch.empty_like(q)
    lib, fn = _kernel(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, Lq, Lk, D,
                  LOG2E / math.sqrt(D), stream)
    build.check(lib, code, "flash_attention launch")
    launches += 1
    source_launches[KERNELS[q.dtype][0]] += 1
    shape_launches[(B, H, Lq, Lk, D, str(q.dtype).split(".")[-1])] += 1
    return out


def shared_memory_bytes(head_dim: int) -> int:
    """Dynamic shared memory of the bf16 kernel's block at ``head_dim``."""
    fn = build.load(KERNELS[torch.bfloat16][0]).coma_flash_attention_bf16_smem
    fn.argtypes, fn.restype = [_I], ctypes.c_int
    return fn(head_dim)


def f32_tile(bh: int, lq: int, head_dim: int) -> tuple:
    """(query rows per block, dynamic shared memory in bytes, blocks per SM)
    of the float32 kernel's instance that a (B·H, Lq, D) call launches."""
    fn = build.load(KERNELS[torch.float32][0]).coma_flash_attention_f32_tile
    fn.argtypes, fn.restype = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
    rows, per_sm = _I(0), _I(0)
    smem = fn(bh, lq, head_dim, ctypes.byref(rows), ctypes.byref(per_sm))
    return rows.value, smem, per_sm.value
