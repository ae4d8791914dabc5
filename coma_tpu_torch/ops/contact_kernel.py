"""K1: the contact splat (canonicalise + geodesic-Gaussian splat + accumulate).

Replaces the TPU kernel ``coma_tpu/ops/contact_kernel.py:405``
(``canon_splat_accumulate_padded``, driven by ``fused_contact_update_batch``
at ``:111``) with the hand-written CUDA kernel ``csrc/contact_splat.cu``.
:func:`fused_contact_update_batch` is a drop-in for
:func:`coma_tpu_torch.affordance.contact.contact_update_batch`, its plain
version: on a CPU state it runs that plain version; on a CUDA state it
launches the kernel once per slab of samples, or raises.

The splat plan (:func:`splat_plan`, plain numpy) is what the kernel needs
beyond the tensors:

- the route. Where the Gaussian falls below ``CUTOFF`` before the antipode
  (σ < 0.717), the TPU kernel fits θ²(t) = arccos(1 − t)² as a degree-6
  polynomial and splats ``exp(−poly(t)/σ²)`` for ``t = 1 − c·g ≤ t_max``,
  0 beyond. Where that fit's splat is within ``POLY_RTOL`` of the exact one
  (σ ≤ 0.3; the configurations use 0.2 and 0.25) the plan carries it with
  −log₂e/σ² folded in, so the kernel's Horner steps give the argument of
  one ``ex2``. Otherwise the kernel splats the exact
  ``exp(−arccos(c·g)²/σ²)``: the fit's error grows with the range of t,
  to 1.5e-2 at σ = 0.6, where the TPU kernel still uses it;
- the patches: the N grid points split into at most 8 patches of at most 32
  nearby points (lane l of every warp holds point l of each patch), each
  with a unit centre and a cosine threshold such that a direction ``c`` with
  ``c·u_w`` below it cannot reach any point of patch ``w`` inside the cutoff.
  The kernel computes, per canonical direction, a bit per patch, and a warp
  skips the patches whose bit is clear: every splat it skips is one the
  polynomial route sets to 0.

:func:`splat_from_cos` and :func:`reach_mask` repeat the kernel's float32
arithmetic on tensors, for the tests and for ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from coma_tpu_torch.affordance.canonicalize import canonicalize_pairwise
from coma_tpu_torch.affordance.contact import contact_update_batch
from coma_tpu_torch.affordance.sphere import clip_bounds
from coma_tpu_torch.affordance.state import ComAState
from coma_tpu_torch.geometry.transforms import normalize_vectors
from coma_tpu_torch.ops import build

SOURCE = "contact_splat"
MAX_SLAB = 64   # the kernel's shared memory: 18.8 KB at 64 samples
PATCH = 32      # grid points per patch: a point per lane of a warp
MAX_N = 256     # at most 8 patches: a lane holds a point of each
CUTOFF = 1e-8   # the polynomial route's splats below this are 0
POLY_DEGREE = 6
UNIT_TOL = 1e-5  # a direction with |c·c − 1| above this reaches every patch
POLY_RTOL = 1e-5  # the polynomial route's largest relative splat error

# Kernel launches since import; callers may reset it to 0.
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 6 + [_F] * 7 + [ctypes.POINTER(_F), _P]


def _kernel():
    lib = build.load(SOURCE)
    fn = lib.coma_contact_splat
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


# ---------------------------------------------------------------------------
# The splat plan
# ---------------------------------------------------------------------------

def _polyval(t: np.ndarray, coeffs) -> np.ndarray:
    """Horner, lowest coefficient first, as ``numpy.polynomial``'s polyval."""
    p = coeffs[-1] + t * 0
    for c in reversed(coeffs[:-1]):
        p = c + p * t
    return p


@functools.lru_cache(maxsize=None)
def fit_geo2_poly(sigma: float, cutoff: float = CUTOFF,
                  degree: int = POLY_DEGREE) -> Optional[Tuple[Tuple[float, ...], float]]:
    """θ²(t) = arccos(1 − t)² fitted by least squares on 2048 points of
    [0, t_max], the range of t where exp(−θ²/σ²) > ``cutoff``.

    Returns (coefficients ascending, t_max), or None where the cutoff is
    never reached before the antipode (θ_max ≥ 0.98π, σ ≥ 0.717). The same
    fit, with the same result, as the TPU kernel's ``_fit_geo2_poly``: the
    steps of ``numpy.polynomial``'s polyfit (columns scaled to unit norm,
    then ``lstsq``), without importing that package in every process.
    """
    theta_max = np.sqrt(-sigma * sigma * np.log(cutoff))
    if theta_max >= np.pi * 0.98:
        return None
    t_max = float(1.0 - np.cos(theta_max))
    t = np.linspace(0.0, t_max, 2048)
    theta2 = np.arccos(np.clip(1.0 - t, -1.0, 1.0)) ** 2
    powers = [np.ones_like(t)]
    for _ in range(degree):
        powers.append(powers[-1] * t)
    powers = np.stack(powers)                                      # (degree + 1, 2048)
    scale = np.sqrt(np.square(powers).sum(1))
    coeffs = np.linalg.lstsq(powers.T / scale, theta2, rcond=len(t) * np.finfo(t.dtype).eps)[0]
    return tuple(float(c) for c in coeffs / scale), t_max


@functools.lru_cache(maxsize=None)
def polynomial_route(sigma: float) -> Optional[Tuple[Tuple[float, ...], float]]:
    """The fit, where its splat exp(−poly(t)/σ²) is within ``POLY_RTOL``
    of exp(−θ²(t)/σ²) over [0, t_max] (checked in float64 on 20001
    points); else None, and the kernel splats the exact value."""
    fit = fit_geo2_poly(sigma)
    if fit is None:
        return None
    coeffs, t_max = fit
    t = np.linspace(0.0, t_max, 20001)
    exact = np.exp(-np.arccos(1.0 - t) ** 2 / (sigma * sigma))
    approx = np.exp(-_polyval(t, coeffs) / (sigma * sigma))
    return fit if np.max(np.abs(approx - exact) / exact) <= POLY_RTOL else None


def _unit_rows(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def patch_partition(grid: np.ndarray) -> np.ndarray:
    """(N,) patch of each grid point: ceil(N / 32) compact patches of at
    most 32 points. Farthest-point seeds, a greedy assignment under the
    capacity, then swaps of two points between patches while they lower
    the sum of squared angles to the patch centres. Deterministic."""
    g = _unit_rows(np.asarray(grid, np.float64))
    n, count = len(g), -(-len(g) // PATCH)
    seeds = [0]
    for _ in range(count - 1):
        seeds.append(int(np.argmin(np.max(g @ g[seeds].T, axis=1))))
    centres = g[seeds]
    assign, load = -np.ones(n, np.int64), np.zeros(count, np.int64)
    for k in np.argsort(-(g @ centres.T), axis=None, kind="stable"):
        i, w = divmod(int(k), count)
        if assign[i] < 0 and load[w] < PATCH:
            assign[i], load[w] = w, load[w] + 1
    rows = np.arange(n)
    for _ in range(100):
        centres = _unit_rows(np.stack([g[assign == w].mean(0) for w in range(count)]))
        cost = np.arccos(np.clip(g @ centres.T, -1.0, 1.0)) ** 2      # (N, P)
        swapped = False
        while True:
            now = cost[rows, assign]
            gain = now[:, None] + now[None, :] - cost[:, assign] - cost[:, assign].T
            i, j = np.unravel_index(np.argmax(gain), gain.shape)
            if gain[i, j] <= 1e-12:
                break
            assign[i], assign[j] = assign[j], assign[i]
            swapped = True
        if not swapped:
            break
    return assign


@dataclasses.dataclass(frozen=True)
class SplatPlan:
    """What the kernel needs of σ and the grid (see the module docstring)."""
    coef: Optional[np.ndarray]  # (7,) float32: the θ² fit × (−log₂e/σ²), ascending; None: exact route
    t_max: float                # float32 cutoff on t = 1 − c·g (polynomial route)
    slots: np.ndarray           # (P·32,) int32: the grid points of each patch, −1 where none
    centres: np.ndarray         # (P, 3) float32 unit patch centres
    cos_reach: np.ndarray       # (P,) float32: c can reach patch w only if c·u_w ≥ this

    @property
    def patches(self) -> int:
        return len(self.centres)


def splat_plan(grid: np.ndarray, sigma: float) -> SplatPlan:
    """The plan for the (N, 3) float32 ``grid`` at ``sigma``.

    The reach threshold is conservative against the kernel's float32 tests:
    a hit means fl(t) ≤ t_max, so ĉ·g ≥ 1 − t_max − δ with δ = 1e-5 covering
    the rounding of t and |c| = 1 ± UNIT_TOL; then angle(ĉ, g) ≤ Θ =
    arccos(1 − t_max − δ) and angle(ĉ, u_w) ≤ Θ + r_w, r_w the patch's
    largest angle to its float32 centre. The threshold is cos(Θ + r_w +
    1e-4) − 1e-5, the last terms covering the kernel's rounding of c·u_w.
    """
    grid = np.asarray(grid, np.float32)
    n = len(grid)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the kernel takes 1 to {MAX_N} grid points, got {n}")
    assign = patch_partition(grid)
    count = int(assign.max()) + 1
    slots = -np.ones(count * PATCH, np.int32)
    g64 = _unit_rows(grid.astype(np.float64))
    centres = np.zeros((count, 3), np.float32)
    radius = np.zeros(count)
    for w in range(count):
        members = np.flatnonzero(assign == w)
        slots[w * PATCH: w * PATCH + len(members)] = members
        centres[w] = _unit_rows(g64[members].mean(0))
        u = _unit_rows(centres[w].astype(np.float64))
        radius[w] = np.arccos(np.clip(g64[members] @ u, -1.0, 1.0)).max()
    fit = polynomial_route(float(sigma))
    if fit is None:
        return SplatPlan(None, 0.0, slots, centres, np.full(count, -2.0, np.float32))
    coeffs, t_max = fit
    scale = -math.log2(math.e) / (float(sigma) * float(sigma))
    coef = np.float32([c * scale for c in coeffs])
    t_max32 = float(np.float32(t_max))
    theta = math.acos(max(-1.0, 1.0 - t_max32 - 1e-5))
    reach = np.minimum(theta + radius + 1e-4, math.pi)
    return SplatPlan(coef, t_max32, slots, centres, np.float32(np.cos(reach) - 1e-5))


def splat_from_cos(cos: torch.Tensor, plan: SplatPlan, eps: float) -> torch.Tensor:
    """The polynomial route's splat of a float32 cosine, as the kernel
    computes it from t = 1 − cos: clamp at ``eps``, Horner (each step one
    fused multiply-add, emulated in float64 and rounded), ``exp2``, and 0
    where t > t_max or t is NaN."""
    t = (1.0 - cos).float()
    tc = torch.clamp(t, min=eps).double()
    coef = [float(c) for c in plan.coef]
    p = torch.full_like(tc, coef[-1])
    for c in reversed(coef[:-1]):
        p = (p * tc + c).float().double()
    return torch.where(t <= plan.t_max, torch.exp2(p.float()), 0.0)


def reach_mask(c: torch.Tensor, plan: SplatPlan) -> torch.Tensor:
    """(..., P) bool: the patches a (..., 3) float32 direction may reach,
    as the kernel decides (every patch for a direction that is not unit:
    zero, NaN)."""
    u = torch.as_tensor(plan.centres, device=c.device)
    dots = c[..., None, 0] * u[:, 0] + c[..., None, 1] * u[:, 1] + c[..., None, 2] * u[:, 2]
    hit = dots >= torch.as_tensor(plan.cos_reach, device=c.device)
    r2 = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]
    unit = (r2 - 1.0).abs() <= UNIT_TOL
    return hit | ~unit[..., None]


def mask_keep_share(state: ComAState, human_normals: torch.Tensor, obj_normals: torch.Tensor,
                    valid: torch.Tensor) -> float:
    """Share of the (h, o, sample, direction, patch) groups whose bit the
    kernel sets, over the valid samples, from the plain canonicalization of
    the same normals; 1.0 on the exact route."""
    plan = splat_plan(state.canon_normal_grid.cpu().numpy(), state.normal_gaussian_sigma)
    if plan.coef is None:
        return 1.0
    kept = total = 0
    for s in range(human_normals.shape[0]):
        if not float(valid[s]) > 0:
            continue
        for a, b, flip in ((human_normals[s], obj_normals[s], False),
                           (obj_normals[s], human_normals[s], True)):
            c = canonicalize_pairwise(a, b, state.principle_vec, state.sub_principle_vec,
                                      state.eps)
            m = reach_mask(c, plan)
            kept += int(m.sum())
            total += m.numel()
    return kept / total if total else 1.0


@functools.lru_cache(maxsize=8)
def _device_plan(sigma: float, grid: bytes, device: torch.device):
    """The plan for σ and the float32 grid's bytes, with its patches'
    points and centres as float4 rows on ``device``."""
    g = np.frombuffer(grid, np.float32).reshape(-1, 3)
    plan = splat_plan(g, sigma)
    slots = np.zeros((len(plan.slots), 4), np.float32)
    present = plan.slots >= 0
    slots[present, :3] = g[plan.slots[present]]
    slots[:, 3] = plan.slots.view(np.float32)       # the grid index, as int bits
    patches = np.concatenate([plan.centres, plan.cos_reach[:, None]], axis=1)
    return (plan, torch.from_numpy(slots).to(device),
            torch.from_numpy(np.ascontiguousarray(patches)).to(device))


def fused_contact_update_batch(
    state: ComAState,
    human_verts: torch.Tensor,    # (B, H, 3)
    human_normals: torch.Tensor,  # (B, H, 3)
    obj_verts: torch.Tensor,      # (B, O, 3)
    obj_normals: torch.Tensor,    # (B, O, 3)
    valid: Optional[torch.Tensor] = None,  # (B,)
    slab: int = 32,
) -> ComAState:
    """Aggregate a batch into ``state`` IN PLACE; returns ``state``.

    On CUDA, one kernel launch per ``slab`` samples reads and writes each
    (H, O, N) accumulator once and adds all the slab's splats; the (H, O)
    proximity, count and significance sums are fused into the same launch.
    """
    global launches
    device = state.device
    if device.type == "cpu":
        return contact_update_batch(state, human_verts, human_normals, obj_verts,
                                    obj_normals, valid=valid)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not 1 <= slab <= MAX_SLAB:
        raise ValueError(f"slab must be in [1, {MAX_SLAB}], got {slab}")
    B = human_verts.shape[0]
    H, O, N = state.human_res, state.obj_res, state.normal_res
    if valid is None:
        valid = torch.ones(B, dtype=torch.float32, device=device)
    for name, t, shape in (
        ("human_verts", human_verts, (B, H, 3)),
        ("human_normals", human_normals, (B, H, 3)),
        ("obj_verts", obj_verts, (B, O, 3)),
        ("obj_normals", obj_normals, (B, O, 3)),
        ("valid", valid, (B,)),
        ("canon_normal_grid", state.canon_normal_grid, (N, 3)),
        ("prob_grid_canon_human_wrt_obj", state.prob_grid_canon_human_wrt_obj, (H, O, N)),
        ("prob_grid_canon_obj_wrt_human", state.prob_grid_canon_obj_wrt_human, (H, O, N)),
        ("contact_dist_expectation_grid_nom", state.contact_dist_expectation_grid_nom, (H, O)),
        ("contact_dist_expectation_grid_denom", state.contact_dist_expectation_grid_denom, (H, O)),
        ("significant_contact_count", state.significant_contact_count, (H, O)),
    ):
        build.check_tensor(name, t, device, shape)
    if B == 0:
        return state

    lib, fn = _kernel()
    grid = state.canon_normal_grid.detach().cpu().numpy().astype(np.float32)
    plan, slots, patches = _device_plan(float(state.normal_gaussian_sigma), grid.tobytes(),
                                        device)
    # the polynomial route's coefficients and t_max; none: the exact route
    poly = None if plan.coef is None else (_F * 8)(*plan.coef, plan.t_max)
    eps = state.eps
    pq = torch.cat([
        normalize_vectors(state.principle_vec[None, :], eps)[0],
        normalize_vectors(state.sub_principle_vec[None, :], eps)[0],
    ]).contiguous()
    # reciprocals in float32, as PyTorch divides a CUDA tensor by a scalar
    inv = lambda x: float(np.float32(1.0) / np.float32(x))
    inv_s2 = inv(state.normal_gaussian_sigma * state.normal_gaussian_sigma)
    lo, hi = clip_bounds(eps)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for start in range(0, B, slab):
            stop = min(start + slab, B)
            ptr = lambda t: t[start:stop].data_ptr()
            code = fn(
                state.prob_grid_canon_human_wrt_obj.data_ptr(),
                state.prob_grid_canon_obj_wrt_human.data_ptr(),
                state.contact_dist_expectation_grid_nom.data_ptr(),
                state.contact_dist_expectation_grid_denom.data_ptr(),
                state.significant_contact_count.data_ptr(),
                ptr(human_verts), ptr(human_normals), ptr(obj_verts), ptr(obj_normals),
                ptr(valid), slots.data_ptr(), patches.data_ptr(), pq.data_ptr(),
                stop - start, H, O, N, plan.patches, PATCH,
                inv(state.spatial_grid_size), state.spatial_grid_thres, inv_s2, lo, hi, eps,
                UNIT_TOL, poly, stream,
            )
            build.check(lib, code, "contact_splat launch")
            launches += 1
    state.used_count.add_(valid.sum())
    return state
