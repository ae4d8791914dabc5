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
    NaN, a zero normal and the singular branch. At σ = 0.25 the kernel
    splats with the θ² polynomial (≤ ~3e-7 from the exact splat) and t from
    fused multiply-adds, so splats differ from the plain version's by a
    few 1e-7: rtol 1e-4 / atol 1e-5."""
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
@pytest.mark.parametrize("sigma,route", [(0.3, "polynomial"), (0.6, "exact"), (0.75, "exact")])
def test_k1_routes_match_plain(sigma, route):
    """The polynomial up to σ = 0.3; at σ = 0.6 the TPU kernel's fit exists
    but is 1.5e-2 off, and from σ ≈ 0.717 there is none: the kernel splats
    the exact arccos and exp. Both at the same limits."""
    need_card()
    assert (contact_kernel.polynomial_route(sigma) is None) == (route == "exact")
    rng = np.random.default_rng(2)
    B, H, O, N = 6, 30, 21, 250
    hv, ov = rng.normal(size=(B, H, 3)) * 0.3, rng.normal(size=(B, O, 3)) * 0.3
    hn, on = unit(rng.normal(size=(B, H, 3))), unit(rng.normal(size=(B, O, 3)))
    hn[:, 0] = 0.0
    on[:, 1] = (0.0, 0.0, -1.0)
    args = [cuda(a) for a in (hv, hn, ov, on)]
    k, p = (state.init_coma_state(H, O, N, 0.07, 0.24, sigma, device="cuda") for _ in "kp")
    contact_kernel.fused_contact_update_batch(k, *args, slab=4)
    contact.contact_update_batch(p, *args)
    torch.cuda.synchronize()
    for f in FIELDS:
        torch.testing.assert_close(getattr(k, f), getattr(p, f), rtol=1e-4, atol=1e-5)


def directions_at(grid, angle, rng):
    """One unit direction per grid point, at ``angle`` from it."""
    side = unit(np.cross(grid, unit(rng.normal(size=grid.shape))))
    return unit(np.cos(angle) * grid + np.sin(angle) * side)


@pytest.mark.cuda
def test_k1_on_grid_points_at_the_cutoff_and_nan():
    """Object normals on the principal axis make the human-wrt-object
    direction the human normal itself: sample 0 puts it on every grid
    point, samples 1-3 at the polynomial's cutoff angle (and just inside
    and outside it) from every grid point. Sample 4 is valid and holds a
    NaN human normal at vertex 7: the kernel adds 0 for it there, where the
    plain version's sums turn NaN, so row 7 of the grids is held against
    the plain version without sample 4."""
    need_card()
    rng = np.random.default_rng(3)
    H, O, N, sigma = 250, 5, 250, 0.25
    grid = np.float64(state.init_coma_state(1, 1, N, 0.07, 0.24, device="cpu")
                      .canon_normal_grid.numpy())
    theta = np.arccos(1.0 - contact_kernel.fit_geo2_poly(sigma)[1])
    hn = np.stack([grid] + [directions_at(grid, theta * f, rng)
                            for f in (1 - 1e-6, 1.0, 1 + 1e-6)] + [unit(rng.normal(size=(H, 3)))])
    B = len(hn)
    hn[4, 7] = np.nan
    on = np.zeros((B, O, 3))
    on[..., 2] = 1.0
    on[:, 3] = unit(rng.normal(size=(B, 3)))
    hv, ov = rng.normal(size=(B, H, 3)) * 0.3, rng.normal(size=(B, O, 3)) * 0.3
    args = [cuda(a) for a in (hv, hn, ov, on)]
    init = lambda: state.init_coma_state(H, O, N, 0.07, 0.24, sigma, device="cuda")
    k, p, p_drop = init(), init(), init()
    contact_kernel.fused_contact_update_batch(k, *args, slab=B)
    contact.contact_update_batch(p, *args)
    contact.contact_update_batch(p_drop, *args, valid=cuda([1, 1, 1, 1, 0]))
    torch.cuda.synchronize()
    rows = torch.arange(H, device="cuda") != 7
    for f in FIELDS:
        got, want = getattr(k, f), getattr(p, f)
        assert torch.isfinite(got).all()
        if f.startswith("prob_grid"):
            torch.testing.assert_close(got[rows], want[rows], rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(got[7], getattr(p_drop, f)[7], rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


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
def test_k2_hits_at_brick_edges_equal_plain():
    """Vertices at thres ± a few ulps from voxel centres on brick edges
    (R = 20: bricks of 4 slices by 6 rows, the last ones ragged), a NaN
    vertex in a valid sample and a padded sample of NaN: the cull drops no
    hit."""
    need_card()
    rng = np.random.default_rng(4)
    B, H, O, R = 7, 200, 3, 20
    k, p = (state.init_occupancy_state(H, O, R, 3.0, device="cuda") for _ in "kp")
    grid = k.spatial_grid.cpu().numpy()
    thres = np.float32(k.rel_dist_thres)
    hv = np.empty((B, H, 3), np.float32)
    for b in range(B):
        for h in range(H):
            idx = rng.integers(0, R, 3)
            idx[rng.integers(3)] = rng.choice([3, 4, 5, 6, 7, 8, 11, 12])
            x = grid[:, idx[0], idx[1], idx[2]].copy()
            axis = rng.integers(3)
            x[axis] = np.float32(x[axis] + rng.choice([-1.0, 1.0]) * thres)
            steps = int(rng.integers(-3, 4))
            for _ in range(abs(steps)):
                x[axis] = np.nextafter(x[axis], np.float32(np.sign(steps) * np.inf))
            hv[b, h] = x
    hv[1, 5] = np.nan
    hv[2] = np.nan
    ov = np.zeros((B, O, 3), np.float32)
    valid = cuda([1, 1, 0, 1, 1, 1, 1])
    occupancy_kernel.fused_occupancy_update_batch(k, cuda(hv), cuda(ov), valid=valid, slab=4)
    occupancy.occupancy_update_batch(p, cuda(hv), cuda(ov), valid=valid)
    torch.cuda.synchronize()
    assert k.spatial_occupancy_grids.sum() > 0
    assert torch.equal(k.spatial_occupancy_grids, p.spatial_occupancy_grids)


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
    # the bf16 (tensor-core) kernel's edges
    (2, 2, 100, 9, 40, torch.bfloat16, 1.0),       # fewer keys than one 128-key tile
    (1, 2, 257, 300, 80, torch.bfloat16, 1.0),     # partial query and key tiles, two chunks
    (1, 2, 300, 77, 160, torch.bfloat16, 1.0),     # three chunks, 64-key tiles
    (1, 2, 300, 200, 512, torch.bfloat16, 1.0),    # D = 512: split columns, 32-key tiles
    (2, 2, 129, 130, 64, torch.bfloat16, 30.0),    # large logits in bf16: the running max
    (2, 3, 257, 77, 40, torch.bfloat16, 30.0),
    (2, 2, 100, 77, 32, torch.bfloat16, 1.0),
    (1, 2, 200, 333, 64, torch.bfloat16, 1.0),
    # lengths at the tile edges: one query or key, whole tiles, one past,
    # an odd and an even count of key tiles after the first
    (1, 1, 1, 1, 40, torch.bfloat16, 1.0),
    (1, 2, 128, 128, 40, torch.bfloat16, 1.0),
    (1, 2, 129, 257, 40, torch.bfloat16, 1.0),
    (2, 2, 100, 200, 64, torch.bfloat16, 1.0),
    (1, 1, 64, 384, 80, torch.bfloat16, 1.0),
    (1, 1, 1, 65, 160, torch.bfloat16, 1.0),
    (1, 1, 64, 33, 512, torch.bfloat16, 1.0),
    (1, 1, 5, 96, 512, torch.bfloat16, 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,D,dtype,scale", K3_CASES)
def test_k3_kernel_matches_plain(B, H, Lq, Lk, D, dtype, scale):
    """K3 against its plain version computed in fp32 from the same inputs:
    bf16 within 5e-4 + 8e-3 |plain| (one rounding of the output to bf16,
    a relative error of at most 2^-8, and P fed to the tensor cores as two
    bf16 terms, ~2^-16), f32 within 1e-4 (exp2 of pre-scaled scores,
    another summation order)."""
    need_card()
    from coma_tpu_torch.ops import attention

    q, k, v = k3_inputs(np.random.default_rng(D + Lk), B, H, Lq, Lk, D, dtype, scale)
    before = attention.launches
    source = attention.KERNELS[dtype][0]
    before_source = attention.source_launches[source]
    out = attention.scaled_dot_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert attention.source_launches[source] == before_source + 1   # routed by dtype
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
    # TMA needs 16-byte aligned bases: a view that starts 2 bytes in raises
    # and is not copied
    n = 8 * 40
    odd = torch.zeros(n + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, 1, 8, 40)
    even = torch.zeros(1, 1, 8, 40, dtype=torch.bfloat16, device="cuda")
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        attention.scaled_dot_attention(odd, even, even)
    with pytest.raises(ValueError, match="16-byte"):
        attention.scaled_dot_attention(even, odd, even)
    assert attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,D", [(2, 4, 257, 77, 40), (1, 3, 100, 77, 512)])
def test_k3_reads_only_its_own_head(B, H, Lq, Lk, D):
    """Every head but the first holds K and V of 1e4: a key tile that read
    past its slice (Lk = 77 ends inside a tile) would pull them into the
    first head's output."""
    need_card()
    from coma_tpu_torch.ops import attention

    q, k, v = k3_inputs(np.random.default_rng(D), B, H, Lq, Lk, D, torch.bfloat16)
    k[:, 1:] = 1e4
    v[:, 1:] = 1e4
    out = attention.scaled_dot_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention.attention_reference(q[:, :1].float(), k[:, :1].float(), v[:, :1].float())
    torch.testing.assert_close(out[:, :1].float(), want, atol=5e-4, rtol=8e-3)

