"""The plans of kernels K1 and K2, emulated on the CPU.

K1 (``csrc/contact_splat.cu``) splats with the TPU kernel's θ² polynomial
where σ gives it one, and a warp skips the canonical directions that cannot
reach its patch of grid points; K2 (``csrc/occupancy_hits.cu``) tests only
the (vertex, sample) pairs that can come within the threshold of its brick
of voxels. Neither kernel runs here, so what they decide is repeated in
float32 on tensors (``coma_tpu_torch.ops.{contact,occupancy}_kernel``) and
held against ``coma_tpu``'s fit and splat, the port's exact splat, and the
plain versions: the fit equal to 1e-12, the splat within 1e-6 of the TPU
kernel's and 4e-7 of the exact value, the skip and the cull exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.ops import contact_kernel as j_kernel
from coma_tpu_torch.affordance import occupancy as t_occ
from coma_tpu_torch.affordance import state as t_state
from coma_tpu_torch.affordance.sphere import fibonacci_sphere, geodesic_gaussian
from coma_tpu_torch.ops import contact_kernel, occupancy_kernel

GRID = fibonacci_sphere(250).astype(np.float32)
PATCH = contact_kernel.PATCH
EPS = 1e-10


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def dots(d, g):
    """(D, N) float32 cosines, rounded as the plain version rounds them."""
    d, g = t(d), t(g)
    return d[:, None, 0] * g[:, 0] + d[:, None, 1] * g[:, 1] + d[:, None, 2] * g[:, 2]


def kernel_t(d, g):
    """(D, N) t = 1 − c·g as the kernel computes it: three fused
    multiply-adds, each emulated in float64 and rounded to float32."""
    d, g = np.float64(d)[:, None, :], np.float64(g)[None, :, :]
    acc = np.ones(d.shape[:1] + g.shape[1:2], np.float32)
    for k in range(3):
        acc = np.float32(-d[..., k] * g[..., k] + np.float64(acc))
    return acc


@pytest.mark.parametrize("sigma", [0.1, 0.2, 0.25, 0.5, 0.6, 0.7])
def test_fit_equals_the_tpu_kernels(sigma):
    got, want = contact_kernel.fit_geo2_poly(sigma), j_kernel._fit_geo2_poly(sigma)
    assert len(got[0]) == len(want[0]) == 7
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    assert got[1] == want[1]


@pytest.mark.parametrize("sigma", [0.75, 1.0])
def test_no_fit_where_the_cutoff_is_never_reached(sigma):
    """θ_max = σ·√(ln 1e8) ≥ 0.98π from σ ≈ 0.717: both take the exact route."""
    assert contact_kernel.fit_geo2_poly(sigma) is None
    assert j_kernel._fit_geo2_poly(sigma) is None
    assert contact_kernel.splat_plan(GRID, sigma).coef is None


@pytest.mark.parametrize("sigma,route", [(0.2, True), (0.25, True), (0.3, True),
                                         (0.35, False), (0.6, False)])
def test_polynomial_route_only_where_the_fit_is_accurate(sigma, route):
    """The fit exists up to σ ≈ 0.717, but its splat error grows with t_max
    (1.8e-7 at σ = 0.25, 1.3e-5 at 0.35, 1.5e-2 at 0.6): the kernel takes
    the polynomial only within 1e-5 of the exact splat."""
    assert contact_kernel.fit_geo2_poly(sigma) is not None
    assert (contact_kernel.polynomial_route(sigma) is not None) == route
    assert (contact_kernel.splat_plan(GRID, sigma).coef is not None) == route


@pytest.mark.parametrize("sigma", [0.2, 0.25])
def test_splat_emulation_matches_tpu_and_exact(rng, sigma):
    plan = contact_kernel.splat_plan(GRID, sigma)
    d = unit(rng.normal(size=(4000, 3))).astype(np.float32)
    d[:250] = GRID                        # on a grid point: cos at the clip
    cos = dots(d, GRID)
    got = contact_kernel.splat_from_cos(cos, plan, EPS)
    poly, t_max = j_kernel._fit_geo2_poly(sigma)
    tpu = np.asarray(j_kernel._geo2_gauss_fast(jnp.asarray(cos.numpy()), poly, t_max,
                                               1.0 / (sigma * sigma), EPS))
    np.testing.assert_allclose(got.numpy(), tpu, rtol=0, atol=1e-6)
    # the port's exact splat of the same cosine, in float64 (an (N=1) grid
    # along x, so its dot product is the cosine itself)
    c64 = cos.double().reshape(-1)
    axis = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    exact = geodesic_gaussian(axis, torch.stack([c64, 0 * c64, 0 * c64], -1), sigma, EPS)
    err = (got.double().reshape(-1) - exact[:, 0]).abs()
    assert float(err.max()) <= 4e-7
    assert float(got.max()) <= 1.0 and float(got.min()) >= 0.0


def test_zero_and_nan_directions_splat_nothing():
    plan = contact_kernel.splat_plan(GRID, 0.25)
    cos = torch.tensor([0.0, float("nan")])      # c = 0 gives t = 1 > t_max
    assert plan.t_max < 1.0
    assert torch.equal(contact_kernel.splat_from_cos(cos, plan, EPS), torch.zeros(2))
    c = torch.tensor([[0.0, 0.0, 0.0], [float("nan")] * 3, [0.5, 0.0, 0.0]])
    assert contact_kernel.reach_mask(c, plan).all()   # not unit: every patch


def test_patch_partition_is_compact_and_deterministic():
    plan = contact_kernel.splat_plan(GRID, 0.25)
    assert plan.patches == 8 and len(plan.slots) == 256
    present = plan.slots[plan.slots >= 0]
    np.testing.assert_array_equal(np.sort(present), np.arange(250))
    for w in range(plan.patches):
        members = plan.slots[w * PATCH:(w + 1) * PATCH]
        members = members[members >= 0]
        assert 1 <= len(members) <= PATCH
        angles = np.degrees(np.arccos(np.clip(GRID[members] @ plan.centres[w], -1, 1)))
        assert angles.max() < 60.0
    again = contact_kernel.splat_plan(GRID, 0.25)
    np.testing.assert_array_equal(again.slots, plan.slots)
    small = contact_kernel.splat_plan(fibonacci_sphere(8).astype(np.float32), 0.25)
    assert small.patches == 1 and sorted(small.slots[:8]) == list(range(8))


def boundary_directions(plan, theta):
    """For every grid point g, the direction at angle θ beyond g on the
    great circle from its patch centre: where the triangle inequality
    behind the reach threshold is tight."""
    out = []
    for w in range(plan.patches):
        u = plan.centres[w].astype(np.float64)
        for n in plan.slots[w * PATCH:(w + 1) * PATCH]:
            if n < 0:
                continue
            g = GRID[n].astype(np.float64)
            away = (u @ g) * g - u                 # tangent at g, away from u
            if np.linalg.norm(away) < 1e-9:
                continue
            away /= np.linalg.norm(away)
            for a in (theta * (1 - 1e-6), theta, theta * (1 + 1e-6)):
                out.append(np.cos(a) * g + np.sin(a) * away)
    return np.float32(unit(np.array(out)))


@pytest.mark.parametrize("sigma", [0.2, 0.25])
def test_reach_mask_is_conservative(rng, sigma):
    """Every (direction, grid point) the polynomial route splats (t ≤ t_max
    in the kernel's float32) has its patch's bit set: the warp skip drops
    only zeros."""
    plan = contact_kernel.splat_plan(GRID, sigma)
    theta = float(np.arccos(1.0 - plan.t_max))
    d = np.concatenate([
        unit(rng.normal(size=(12000, 3))).astype(np.float32),
        GRID, -GRID,
        boundary_directions(plan, theta),
    ])
    mask = contact_kernel.reach_mask(t(d), plan).numpy()          # (D, P)
    patch_of = np.empty(250, np.int64)
    for w in range(plan.patches):
        members = plan.slots[w * PATCH:(w + 1) * PATCH]
        patch_of[members[members >= 0]] = w
    splatted = kernel_t(d, GRID) <= np.float32(plan.t_max)         # (D, N)
    assert splatted.any()
    missed = splatted & ~mask[:, patch_of]
    assert not missed.any(), f"{missed.sum()} splats in skipped patches"
    # and the skip is worth having: under 80% of the (direction, patch) pairs kept
    assert mask[:12000].mean() < 0.8


def test_mask_keep_share_counts_both_directions(rng):
    H, O = 6, 5
    st = t_state.init_coma_state(H, O, 250, 0.07, 0.24, 0.25, device="cpu")
    hn, on = t(unit(rng.normal(size=(3, H, 3)))), t(unit(rng.normal(size=(3, O, 3))))
    share = contact_kernel.mask_keep_share(st, hn, on, t([1, 0, 1]))
    assert 0.3 < share < 0.9
    exact = t_state.init_coma_state(H, O, 250, 0.07, 0.24, 0.75, device="cpu")
    assert contact_kernel.mask_keep_share(exact, hn, on, t([1, 0, 1])) == 1.0


# ---------------------------------------------------------------------------
# K2: the brick cull
# ---------------------------------------------------------------------------

H2, O2, R2 = 48, 4, 20          # bricks of 4 × 6 × 20 voxels, the last ones ragged


def edge_points(state, rng, count):
    """Points at thres ± a few ulps from voxel centres on brick edges (slices
    3|4, 7|8, rows 5|6, 11|12), the offset along one axis, out of the brick
    and into it."""
    grid = state.spatial_grid.numpy()
    thres = np.float32(state.rel_dist_thres)
    edge = [3, 4, 5, 6, 7, 8, 11, 12]
    pts = []
    for _ in range(count):
        idx = rng.integers(0, R2, 3)
        idx[rng.integers(3)] = rng.choice(edge)
        g = grid[:, idx[0], idx[1], idx[2]]
        axis, sign = rng.integers(0, 3), rng.choice([-1.0, 1.0])
        x = g.copy()
        x[axis] = np.float32(g[axis] + sign * thres)
        steps = int(rng.integers(-3, 4))
        for _ in range(abs(steps)):
            x[axis] = np.nextafter(x[axis], np.float32(np.sign(steps) * np.inf))
        pts.append(x)
    return np.float32(pts)


@pytest.mark.parametrize("case", ["random", "brick_edges", "nan"])
def test_culled_hits_equal_plain(rng, case):
    st = t_state.init_occupancy_state(H2, O2, R2, scale_tolerance=3.0, device="cpu")
    B = 7
    hv = np.float32(rng.normal(size=(B, H2, 3)) * 0.6)
    ov = np.zeros((B, O2, 3), np.float32)           # the anchor at the origin
    valid = np.float32([1, 1, 0, 1, 1, 1, 1])
    if case == "brick_edges":
        hv = edge_points(st, rng, B * H2).reshape(B, H2, 3)
    if case == "nan":
        hv[1, 3] = np.nan                            # in a valid sample
        hv[2] = np.nan                               # a padded sample
    got = occupancy_kernel.culled_hits(st, t(hv), t(ov), t(valid))
    t_occ.occupancy_update_batch(st, t(hv), t(ov), valid=t(valid))
    assert float(st.spatial_occupancy_grids.sum()) > 0
    assert torch.equal(got, st.spatial_occupancy_grids)
    kept, dense, touched = occupancy_kernel.kept_work(st, t(hv), t(ov), t(valid))
    assert dense == 6 * H2 * R2 ** 3 and 0 < kept < dense
    assert kept / 6 <= touched <= min(kept, H2 * R2 ** 3)
    if case == "nan":                                # a NaN pair is kept
        x = t(hv) - t(ov)[:, :1]
        keep = occupancy_kernel.cull_keep(x, t_occ.point_sq_norms(x), t(valid),
                                          st.spatial_grid, occupancy_kernel._thres_sq(st))
        assert keep[1, 3].all() and not keep[2].any()


def test_brick_boxes_cover_their_voxels():
    """R = 20: bricks of 4 slices by 6 rows (6 · 20 voxels per slice for 128
    threads), 5 × 4 of them, the last rows' bricks ragged."""
    st = t_state.init_occupancy_state(2, 1, R2, scale_tolerance=3.0, device="cpu")
    assert occupancy_kernel.brick_rows(R2) == 6
    lo, hi, g2max, brick = occupancy_kernel.brick_boxes(st.spatial_grid)
    assert lo.shape == (20, 3) and torch.bincount(brick).tolist().count(4 * 6 * 20) == 15
    flat = st.spatial_grid.reshape(3, -1).T
    assert (flat >= lo[brick]).all() and (flat <= hi[brick]).all()
    assert (t_occ.voxel_sq_norms(flat.T) <= g2max[brick]).all()
    with pytest.raises(ValueError):
        occupancy_kernel.brick_rows(129)


def test_far_vertices_run_no_tests(rng):
    """Far vertices: no test runs and no accumulator row is touched."""
    st = t_state.init_occupancy_state(H2, O2, R2, scale_tolerance=3.0, device="cpu")
    hv = np.full((3, H2, 3), 50.0, np.float32)
    kept, dense, touched = occupancy_kernel.kept_work(st, t(hv), t(np.zeros((3, O2, 3))),
                                                      t([1, 1, 1]))
    assert kept == touched == 0 and dense == 3 * H2 * R2 ** 3


def test_touched_rows_count_each_vertex_and_brick_once(rng):
    """A vertex at a voxel centre, in the same place in every sample: its
    (vertex, brick) rows count once however many samples keep them, and
    its tests once per sample."""
    st = t_state.init_occupancy_state(2, 1, R2, scale_tolerance=3.0, device="cpu")
    centre = st.spatial_grid[:, 10, 10, 10].numpy()
    hv = np.stack([np.stack([centre, np.full(3, 50.0, np.float32)])] * 3)
    kept, _, touched = occupancy_kernel.kept_work(st, t(hv), t(np.zeros((3, 1, 3))),
                                                  t([1, 1, 1]))
    assert touched > 0 and kept == 3 * touched
