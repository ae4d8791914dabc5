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
"""
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


def test_reference_in_bfloat16_stays_in_bfloat16():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in inputs(1, 2, 32, 77, 40, 1.0, seed=2))
    out = attention.attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16
    want = np.asarray(_xla_attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                       for a in (q, k, v))).astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(out.float().numpy(), want, atol=3e-2 * scale, rtol=0)
