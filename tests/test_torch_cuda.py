"""The CUDA kernels (K1, K2, K3) against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``coma_tpu`` and uses no fixture of
``tests/conftest.py`` (which imports JAX), so a machine with a card and no
JAX runs it as::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from coma_tpu_torch.affordance import contact, occupancy, state
from coma_tpu_torch.ops import contact_kernel, occupancy_kernel

FIELDS = (
    "prob_grid_canon_human_wrt_obj",
    "prob_grid_canon_obj_wrt_human",
    "contact_dist_expectation_grid_nom",
    "contact_dist_expectation_grid_denom",
    "significant_contact_count",
    "used_count",
)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def cuda(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).cuda()


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.cuda
def test_k1_kernel_matches_plain():
    """A slab (4) that does not divide the batch (11), a padded slot holding
    NaN, a zero normal and the singular branch. The kernel may fuse
    multiply-adds in the canonicalization, so splats differ by a few ulps:
    rtol 1e-4 / atol 1e-5."""
    need_card()
    rng = np.random.default_rng(0)
    B, H, O, N = 11, 40, 37, 250
    hv, ov = rng.normal(size=(B, H, 3)) * 0.3, rng.normal(size=(B, O, 3)) * 0.3
    hn, on = unit(rng.normal(size=(B, H, 3))), unit(rng.normal(size=(B, O, 3)))
    hn[:, 0] = 0.0
    on[:, 1] = (0.0, 0.0, -1.0)
    hn[:, 2] = (0.0, 0.0, -1.0)
    valid = np.float32([1] * 9 + [0, 1])
    hv[9] = np.nan
    args = [cuda(a) for a in (hv, hn, ov, on)]
    k, p = (state.init_coma_state(H, O, N, 0.07, 0.24, 0.25, device="cuda") for _ in "kp")
    before = contact_kernel.launches
    contact_kernel.fused_contact_update_batch(k, *args, valid=cuda(valid), slab=4)
    assert contact_kernel.launches == before + 3
    contact.contact_update_batch(p, *args, valid=cuda(valid))
    torch.cuda.synchronize()
    for f in FIELDS:
        torch.testing.assert_close(getattr(k, f), getattr(p, f), rtol=1e-4, atol=1e-5)
        assert torch.isfinite(getattr(k, f)).all()


@pytest.mark.cuda
def test_k2_kernel_hits_equal_plain():
    need_card()
    rng = np.random.default_rng(1)
    B, H, O, R = 11, 300, 12, 30
    hv, ov = rng.normal(size=(B, H, 3)) * 0.6, rng.normal(size=(B, O, 3)) * 0.6
    valid = np.float32([1] * 8 + [0, 1, 0])
    hv[8] = np.nan
    k, p = (state.init_occupancy_state(H, O, R, 3.0, device="cuda") for _ in "kp")
    before = occupancy_kernel.launches
    occupancy_kernel.fused_occupancy_update_batch(k, cuda(hv), cuda(ov), valid=cuda(valid), slab=4)
    assert occupancy_kernel.launches == before + 3
    occupancy.occupancy_update_batch(p, cuda(hv), cuda(ov), valid=cuda(valid))
    torch.cuda.synchronize()
    assert k.spatial_occupancy_grids.sum() > 0
    assert torch.equal(k.spatial_occupancy_grids, p.spatial_occupancy_grids)
    assert torch.equal(k.anchor_vert, p.anchor_vert)
    assert float(k.used_count) == float(p.used_count) == 9.0


@pytest.mark.cuda
def test_wrappers_reject_mismatched_inputs():
    need_card()
    s = state.init_coma_state(4, 3, 8, 0.07, 0.24, device="cuda")
    good = [torch.zeros(2, n, 3, device="cuda") for n in (4, 4, 3, 3)]
    with pytest.raises(ValueError):
        contact_kernel.fused_contact_update_batch(s, good[0].cpu(), *good[1:])
    with pytest.raises(TypeError):
        contact_kernel.fused_contact_update_batch(s, good[0].double(), *good[1:])
    with pytest.raises(ValueError):
        contact_kernel.fused_contact_update_batch(s, *good, slab=65)


def k3_inputs(rng, B, H, Lq, Lk, D, dtype, logit_scale=1.0):
    q, k, v = (rng.normal(size=(B, H, n, D)) for n in (Lq, Lk, Lk))
    q *= logit_scale
    return [torch.from_numpy(np.float32(a)).cuda().to(dtype) for a in (q, k, v)]


K3_CASES = [  # (B, H, Lq, Lk, D, dtype, logit scale)
    (2, 3, 300, 300, 40, torch.bfloat16, 1.0),     # Lq not a multiple of the row tile
    (2, 3, 257, 77, 40, torch.bfloat16, 1.0),      # cross-attention, ragged key tile
    (1, 8, 1024, 1024, 80, torch.bfloat16, 1.0),
    (1, 8, 256, 77, 160, torch.bfloat16, 1.0),
    (1, 8, 64, 64, 160, torch.float32, 1.0),
    (1, 1, 4096, 4096, 512, torch.bfloat16, 1.0),  # the VAE mid block
    (1, 1, 200, 13, 512, torch.float32, 1.0),
    (2, 2, 129, 130, 64, torch.float32, 30.0),     # large logits: the running max
    (2, 2, 100, 77, 32, torch.float32, 1.0),
    (2, 2, 100, 9, 16, torch.bfloat16, 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,D,dtype,scale", K3_CASES)
def test_k3_kernel_matches_plain(B, H, Lq, Lk, D, dtype, scale):
    """K3 against its plain version computed in fp32 from the same inputs:
    bf16 within 5e-4 + 8e-3 |plain| (one rounding of the output to bf16,
    a relative error of at most 2^-8),
    f32 within 1e-4 (exp2 of pre-scaled scores, another summation order)."""
    need_card()
    from coma_tpu_torch.ops import attention

    q, k, v = k3_inputs(np.random.default_rng(D + Lk), B, H, Lq, Lk, D, dtype, scale)
    before = attention.launches
    out = attention.scaled_dot_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = attention.attention_reference(q.float(), k.float(), v.float())
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want, atol=5e-4, rtol=8e-3)
    else:
        torch.testing.assert_close(out, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_k3_wrapper_rejects_what_the_kernel_does_not_take():
    need_card()
    from coma_tpu_torch.ops import attention

    q = torch.zeros(1, 1, 8, 48, device="cuda")
    with pytest.raises(ValueError):
        attention.scaled_dot_attention(q, q, q)   # no instance for D = 48
    q = torch.zeros(1, 1, 8, 40, device="cuda")
    with pytest.raises(TypeError):
        attention.scaled_dot_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        attention.scaled_dot_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        attention.scaled_dot_attention(q, q.cpu(), q)
