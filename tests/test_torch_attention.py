"""K3's plain version against ``coma_tpu``'s XLA attention, on the CPU.

``coma_tpu_torch.ops.attention.attention_reference`` is held against
``coma_tpu.ops.attention._xla_attention`` (the route every CPU and every
non-lane-aligned TPU call takes) on the same numpy inputs, at the shapes of
the UNet (self and Lk = 77 cross), the VAE mid block (one head, D = 512)
and with scores scaled ×30, where the softmax's max subtraction matters:
atol 1e-5 in float32. The ×30 cases use key counts at which XLA's and
PyTorch's CPU products sum the scores in the same order; at Lk = 77 they
differ by up to 3e-4 in a score of about 240, which a softmax at that
sharpness passes on to the output. On a CPU tensor the wrapper runs the plain version and
counts no launch; the kernel itself is held against it on the card
(``tests/test_torch_cuda.py``).

The bf16 kernel's tolerance argument is held here before any card run: an
emulation of its rounding points (P split into two bf16 terms) stays within
5e-4 + 8e-3·|plain(fp32)| at the UNet's and the VAE's shapes and at ×30
logits, where one bf16 rounding of P would not.

The float32 kernel's algorithm is held here too: a model of its tile order
(keys in the kernel's tiles of BK, exp2 of pre-scaled scores, the online
rescale once per tile, keys past Lk masked in the last tile, one partial
sum per lane combined at the end) stays within the card's 1e-4 of
``_xla_attention``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.ops.attention import _xla_attention, scaled_dot_attention as j_attention
from coma_tpu_torch.ops import attention

CASES = [  # (B, H, Lq, Lk, D, logit scale)
    (2, 8, 256, 256, 40, 1.0),
    (2, 8, 256, 77, 40, 1.0),
    (2, 8, 64, 77, 80, 1.0),
    (2, 8, 64, 64, 160, 1.0),
    (2, 1, 256, 256, 512, 1.0),
    (2, 2, 64, 64, 64, 30.0),
    (1, 3, 50, 50, 40, 30.0),
]


def inputs(B, H, Lq, Lk, D, scale, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (np.float32(rng.normal(size=(B, H, n, D))) for n in (Lq, Lk, Lk))
    return q * np.float32(scale), k, v


@pytest.mark.parametrize("B,H,Lq,Lk,D,scale", CASES)
def test_reference_matches_xla_attention(B, H, Lq, Lk, D, scale):
    q, k, v = inputs(B, H, Lq, Lk, D, scale)
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention.attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = map(torch.from_numpy, inputs(1, 2, 64, 77, 40, 1.0, seed=1))
    before = attention.launches
    out = attention.scaled_dot_attention(q, k, v)
    assert attention.launches == before
    torch.testing.assert_close(out, attention.attention_reference(q, k, v), rtol=0, atol=0)
    # coma_tpu's dispatcher takes its XLA route on the CPU as well
    want = np.asarray(j_attention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy()))))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)


BF16_ATOL, BF16_RTOL = 5e-4, 8e-3   # the card kernel's bf16 limit against plain(fp32)


def emulate_bf16_kernel(q, k, v, split_p=True):
    """The rounding points of ``csrc/flash_attention_sm90.cu`` on bf16 inputs:
    Q·Kᵀ in fp32, the softmax in fp32 (exp2 of the scores scaled by
    log2(e)/√D, minus the scaled row max), P fed to the tensor cores as
    bf16 — two terms, P_hi = bf16(P) and P_lo = bf16(P − P_hi), or one when
    ``split_p`` is false — P·V accumulated in fp32, fp32 row sums of the
    unrounded P, and the output rounded to bf16 once. The kernel's online
    rescaling is exact up to fp32 rounding and is not modelled."""
    qf, kf, vf = q.float(), k.float(), v.float()
    c = attention.LOG2E / np.sqrt(q.shape[-1])
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    hi = p.bfloat16().float()
    pv = hi @ vf
    if split_p:
        pv = pv + (p - hi).bfloat16().float() @ vf
    return (pv / p.sum(-1, keepdim=True)).bfloat16()


def least_passing_atol(out, q, k, v):
    """The least atol with which ``out`` passes against plain(fp32) at rtol 8e-3."""
    want = attention.attention_reference(q.float(), k.float(), v.float())
    return float(((out.float() - want).abs() - BF16_RTOL * want.abs()).max())


EMULATED = [  # (B, H, Lq, Lk, D, logit scale): the UNet's self and cross, the VAE's, ×30
    (2, 8, 1024, 1024, 40, 1.0),
    (2, 8, 1024, 77, 40, 1.0),
    (1, 1, 1024, 1024, 512, 1.0),
    (2, 2, 256, 77, 64, 30.0),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D,scale", EMULATED)
def test_bf16_kernel_rounding_stays_within_the_limit(B, H, Lq, Lk, D, scale):
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inputs(B, H, Lq, Lk, D, scale, seed=3))
    out = emulate_bf16_kernel(q, k, v)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert least_passing_atol(out, q, k, v) <= BF16_ATOL


def test_one_bf16_rounding_of_p_would_exceed_the_limit():
    """Why the kernel splits P: rounded to bf16 once (2^-8 relative per
    weight), P·V at Lk = 77 misses the limit by more than 2x."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inputs(2, 8, 1024, 77, 40, 1.0, seed=3))
    assert least_passing_atol(emulate_bf16_kernel(q, k, v, split_p=False), q, k, v) > 2 * BF16_ATOL


def test_reference_in_bfloat16_stays_in_bfloat16():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inputs(1, 2, 32, 77, 40, 1.0, seed=2))
    out = attention.attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16
    want = np.asarray(_xla_attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                       for a in (q, k, v))).astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(out.float().numpy(), want, atol=3e-2 * scale, rtol=0)


# csrc/flash_attention.cu's split per head dim: (TR lanes per row, TN keys
# per lane); a key tile is BK = TR * TN keys, lane t holding keys t + TR i
F32_SPLIT = {16: (2, 16), 32: (2, 16), 40: (2, 16), 64: (4, 8), 80: (4, 8), 160: (8, 4),
             512: (16, 1)}
F32_ATOL = 1e-4   # the card kernel's float32 limit against the plain version


def emulate_f32_kernel(q, k, v):
    """The order of ``csrc/flash_attention.cu``'s float32 arithmetic, as a
    walk over key tiles: Q scaled once by the float32 qscale = log2(e)/√D,
    scores of a tile of BK keys (zero-filled past Lk, then masked to -inf),
    the row max once per tile, exp2 once per (row, key) against the new max,
    the accumulator and each lane's partial sum rescaled by exp2(m_old -
    m_new), and the TR partial sums of a row added at the end."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    TR, TN = F32_SPLIT[D]
    BK = TR * TN
    qs = q * torch.tensor(np.float32(attention.LOG2E / math.sqrt(D)))
    m = torch.full((B, H, Lq), -math.inf)
    part = torch.zeros(B, H, Lq, TR)            # lane t's sum over its keys
    acc = torch.zeros(B, H, Lq, D)
    for k0 in range(0, Lk, BK):
        kt, vt = (torch.zeros(B, H, BK, D) for _ in range(2))
        n = min(BK, Lk - k0)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = qs @ kt.transpose(-1, -2)
        s[..., n:] = -math.inf
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        part = part * corr[..., None] + p.reshape(B, H, Lq, TN, TR).sum(-2)
        acc = acc * corr[..., None] + p @ vt
        m = mn
    return acc / part.sum(-1, keepdim=True)


TILE_ORDER = CASES + [  # (B, H, Lq, Lk, D, logit scale): the tiny loop's Lk = 7, ×30 at D = 512
    (4, 2, 16, 7, 32, 1.0),
    (4, 2, 64, 7, 16, 1.0),
    (2, 8, 64, 7, 80, 1.0),
    (2, 4, 100, 77, 64, 1.0),
    (1, 2, 70, 77, 160, 1.0),
    (1, 1, 100, 40, 512, 30.0),
    (2, 3, 33, 1, 40, 1.0),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D,scale", TILE_ORDER)
def test_f32_kernel_tile_order_matches_xla_attention(B, H, Lq, Lk, D, scale):
    q, k, v = inputs(B, H, Lq, Lk, D, scale, seed=4)
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = emulate_f32_kernel(*map(torch.from_numpy, (q, k, v)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
