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
from tests.torch_mesh_ranks import REPO, spawn_command

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



# ---------------------------------------------------------------------------
# the segmenters on the card against the CPU (no kernel of the repo: plain
# PyTorch; cuDNN's TF32 is switched off for the comparison)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


@pytest.mark.cuda
@pytest.mark.parametrize("img_size", [64, 256])
def test_sam_forward_on_the_card_matches_the_cpu(no_tf32, img_size):
    """The seeded ``--random_weights`` SAM (ViT-B widths at 256², the tiny
    config at 64²): mask logits and IoU within 1e-3 (float32 on both)."""
    need_card()
    from coma_tpu_torch.models import sam

    cfg = sam.tiny_sam_config() if img_size == 64 else sam.SAMConfig(img_size=256)
    model = sam.init_sam_random_(sam.SAM(cfg), torch.Generator().manual_seed(1)).eval()
    rng = np.random.default_rng(img_size)
    image = torch.from_numpy(np.float32(rng.normal(size=(2, 3, img_size, img_size))))
    boxes = torch.tensor([[4.0, 8.0, img_size * 0.6, img_size * 0.9], [0, 0, img_size - 1,
                                                                          img_size - 1]])
    with torch.no_grad():
        want = model(image, boxes)
        got = model.cuda()(image.cuda(), boxes.cuda())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=1e-3)


# The subdivision's picks, card against CPU on the same masks: a point that
# one side picks and the other does not lies at most PICK_GAP below the other
# side's cutoff uncertainty (the masks agree within ~6e-5, so a near-tie
# moves a point by about twice that), and at most PICK_DIFF of a ROI's 784
# points differ. Measured on an H100: the same picks in every round.
PICK_GAP = 1e-3
PICK_DIFF = 8


class SubdivisionPicks:
    """Within ``with``, each subdivision round of ``point_rend_masks`` logs
    its uncertainty map and its own picks; given ``replay`` (another run's
    log), the round refines that run's picks instead of its own. Patches
    ``pointrend.topk``, which ``point_rend_masks`` calls only to pick."""

    def __init__(self, replay=None):
        self.rounds, self.replay = [], replay

    def __enter__(self):
        from coma_tpu_torch.models import pointrend

        self.module, self.topk = pointrend, pointrend.topk

        def pick(x, k):
            vals, idx = self.topk(x, k)
            self.rounds.append((x.cpu(), idx.cpu()))
            if self.replay is not None:
                idx = self.replay.rounds[len(self.rounds) - 1][1].to(idx.device)
            return vals, idx

        pointrend.topk = pick
        return self

    def __exit__(self, *exc):
        self.module.topk = self.topk


@pytest.mark.cuda
def test_pointrend_forward_on_the_card_matches_the_cpu(no_tf32):
    """The seeded detector at the ``--tiny`` config on a 64x96 input: the
    same valid slots and classes, boxes within 1e-2 px; then the mask head
    on the card's detections, the CPU refining the card's points in each
    subdivision round: every point-head output and the mask logits within
    1e-2 + 1e-3·|x| (float32 through 50 layers on either side).

    The mask head is held on the card's boxes because the logits follow the
    box: the FPN maps agree to ~3e-6 of their size (up to 440 at this
    input), the seeded box regression's large deltas carry that to 0.019 px
    in the proposals and 0.0099 px in the detections, and the coarse logits
    then move by up to 0.055 (the maps' slope under the sampled points), so
    each device's own boxes give logits 0.17 apart (and picks that differ
    in one ROI: 4 of 784 points at 112², 21 at 224²). On the card's boxes,
    in each subdivision round the CPU picks its own points on its masks
    and then refines the card's: a point picked on one side only must lie
    within ``PICK_GAP`` of the other side's cutoff (its 784th largest
    uncertainty), and at most ``PICK_DIFF`` of a ROI's points may differ."""
    need_card()
    import copy

    from coma_tpu_torch.models import pointrend
    from coma_tpu_torch.models.layers import init_flax_default_

    cfg = pointrend.PointRendConfig(max_detections=4, test_size=64, pre_nms_topk=64,
                                    post_nms_topk=32, box_candidates=32, box_score_thresh=0.0)
    model = init_flax_default_(pointrend.PointRendModel(cfg), torch.Generator().manual_seed(2))
    model.eval()
    card = copy.deepcopy(model).cuda()
    image = torch.from_numpy(np.float32(np.random.default_rng(3).normal(size=(2, 3, 64, 96)) * 50))
    heads = {}
    for name, m in (("card", card), ("cpu", model)):
        heads[name] = []
        m.point_head.register_forward_hook(lambda mod, a, out, log=heads[name]:
                                           log.append(out.cpu()))
    with torch.no_grad():
        want = model(image)
        p2_cpu = pointrend._channels_last(model.features(image)["p2"])
        hw = tuple(image.shape[-2:])           # the card's forward, stage by stage
        fpn = card.features(image.cuda())
        det = card.detect(fpn, *card.rpn(fpn, hw), hw)
        with SubdivisionPicks() as card_picks:
            det["mask_logits"] = card.point_rend_masks(pointrend._channels_last(fpn["p2"]),
                                                       det["boxes"], det["classes"])
        got = {k: v.cpu() for k, v in det.items()}
        heads["cpu"].clear()
        with SubdivisionPicks(replay=card_picks) as cpu_picks:
            replayed = model.point_rend_masks(p2_cpu, got["boxes"], got["classes"])
    assert want["valid"].any()
    assert torch.equal(got["valid"], want["valid"]) and torch.equal(got["classes"],
                                                                   want["classes"])
    torch.testing.assert_close(got["boxes"], want["boxes"], atol=1e-2, rtol=0)
    assert len(heads["card"]) == len(heads["cpu"]) == 1 + cfg.subdivision_steps
    for c, p in zip(heads["card"], heads["cpu"]):
        torch.testing.assert_close(c, p, atol=1e-2, rtol=1e-3)
    torch.testing.assert_close(got["mask_logits"], replayed, atol=1e-2, rtol=1e-3)
    assert len(card_picks.rounds) == len(cpu_picks.rounds) == 3     # at 56², 112², 224²
    for side, card_round, cpu_round in zip((56, 112, 224), card_picks.rounds, cpu_picks.rounds):
        for (x, mine), (_, other) in ((card_round, cpu_round), (cpu_round, card_round)):
            chosen = lambda idx: torch.zeros_like(x, dtype=torch.bool).scatter(-1, idx, True)
            only = chosen(other) & ~chosen(mine)
            gap = x.gather(-1, mine[..., -1:]) - x      # below this side's cutoff
            worst = float(gap[only].max()) if only.any() else 0.0
            print(f"PointRend subdivision at {side}²: {int(only.sum(-1).max())} of "
                  f"{mine.shape[-1]} picks differ in a ROI, {worst:.3e} below the cutoff")
            assert int(only.sum(-1).max()) <= PICK_DIFF and worst <= PICK_GAP, (side, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("K,seed", [(1000, 0), (500, 1), (64, 2)])
def test_fixed_point_nms_equals_the_loop_on_the_card(K, seed):
    """The batched fixed-point NMS on the card against the sequential loop on
    the CPU, over (image, level) sets with overlapping chains, ties and
    -inf padding."""
    need_card()
    from coma_tpu_torch.models import pointrend

    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 200, size=(4, 5, K, 2))
    wh = rng.uniform(5, 60, size=(4, 5, K, 2))
    boxes = torch.from_numpy(np.float32(np.concatenate([c, c + wh], axis=-1)))
    boxes[0, 0, 1::2] = boxes[0, 0, ::2]                 # exact duplicates
    scores = torch.from_numpy(np.float32(-np.sort(-rng.uniform(size=(4, 5, K)), axis=-1)))
    scores[1, :, K // 2:] = -np.inf
    keep = pointrend.greedy_nms(boxes.cuda(), scores.cuda(), 0.7).cpu()
    for i in range(4):
        for j in range(5):
            assert torch.equal(keep[i, j], pointrend.greedy_nms_loop(boxes[i, j], scores[i, j],
                                                                     0.7)), (i, j)


# ---------------------------------------------------------------------------
# stage 2 (3D lifting) on the card against the CPU: plain PyTorch, no kernel
# ---------------------------------------------------------------------------

def uv_sphere(rings: int, around: int, radius: float):
    """A closed UV sphere: (rings * around + 2 vertices, faces)."""
    theta = np.linspace(0, np.pi, rings + 2)[1:-1]
    phi = np.linspace(0, 2 * np.pi, around, endpoint=False)
    verts = np.stack([np.outer(np.sin(theta), np.cos(phi)), np.outer(np.sin(theta), np.sin(phi)),
                      np.outer(np.cos(theta), np.ones(around))], -1).reshape(-1, 3) * radius
    verts = np.concatenate([verts, [[0, 0, radius], [0, 0, -radius]]])
    i, j = np.meshgrid(np.arange(rings - 1), np.arange(around), indexing="ij")
    a, b = i * around + j, i * around + (j + 1) % around
    faces = [np.stack([a, b, b + around], -1).reshape(-1, 3),
             np.stack([a, b + around, a + around], -1).reshape(-1, 3),
             np.stack([np.full(around, len(verts) - 2), np.arange(around),
                       (np.arange(around) + 1) % around], -1),
             np.stack([np.full(around, len(verts) - 1), (rings - 1) * around
                       + (np.arange(around) + 1) % around, (rings - 1) * around
                       + np.arange(around)], -1)]
    return np.float32(verts), np.concatenate(faces)


@pytest.mark.cuda
@pytest.mark.parametrize("res,rings,around", [(64, 8, 12), (512, 100, 100)])
def test_rasterizer_on_the_card_matches_the_cpu(res, rings, around):
    """A sphere (pixel-sized triangles at 512², the patch route) and a random
    occluder (large triangles, the dense route) at ``res``². On the same
    pixel-space triangles the card's masks equal the CPU's and its z-buffer
    is finite at the same pixels, within 1e-4 + 1e-6 |z| (the elementwise
    arithmetic is IEEE on both). Through the whole render of five occluded
    candidates (the projection is a matrix product, summed otherwise on the
    card) at most 1e-3 of the pixels may differ."""
    need_card()
    from coma_tpu_torch.lifting import cameras, rasterizer

    rng = np.random.default_rng(res)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    cam = {"R": R, "t": R[:, 2] * 3.0, "scale": 2.0, "resolution": (res, res)}
    verts, faces = uv_sphere(rings, around, 0.4)
    occ_v = np.float32(rng.normal(size=(60, 3)) * 0.5)
    occ_f = rng.integers(0, 60, size=(40, 3))
    tri = cameras.project_points(cameras.OrthoCamera.from_pickle(cam, "cpu"), torch.as_tensor(
        np.concatenate([verts, occ_v])))[torch.as_tensor(np.concatenate([faces,
                                                                         occ_f + len(verts)]))]
    for fn in (rasterizer.rasterize_depth, rasterizer.rasterize_silhouette):
        t = tri if fn is rasterizer.rasterize_depth else tri[..., :2]
        want, got = fn(t, res, res), fn(t.cuda(), res, res).cpu()
        if fn is rasterizer.rasterize_silhouette:
            assert want.any() and torch.equal(got, want)
            continue
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        torch.testing.assert_close(got[fin], want[fin], atol=1e-4, rtol=1e-6)
    cand = verts[None] + np.float32(rng.normal(size=(5, 1, 3)) * 0.2)
    out = {}
    for dev in ("cpu", "cuda"):
        c = cameras.OrthoCamera.from_pickle(cam, dev)
        out[dev] = rasterizer.render_silhouettes_batch(
            c, torch.as_tensor(cand, device=dev), torch.as_tensor(faces, device=dev),
            occluder_verts=torch.as_tensor(occ_v, device=dev),
            occluder_faces=torch.as_tensor(occ_f, device=dev)).cpu()
    assert out["cpu"].any()
    assert (out["cuda"] != out["cpu"]).float().mean() <= 1e-3


@pytest.mark.cuda
def test_hand4whole_regressor_on_the_card_matches_the_cpu(no_tf32):
    """The seeded Hand4Whole at the published widths, one 512x384 patch:
    every output within 1e-3 + 1e-3 |x| of the CPU's (float32 on both)."""
    need_card()
    from coma_tpu_torch.models.hand4whole import Hand4Whole
    from coma_tpu_torch.models.layers import init_flax_default_

    model = init_flax_default_(Hand4Whole(), torch.Generator().manual_seed(0)).eval()
    img = torch.from_numpy(np.float32(np.random.default_rng(5).uniform(size=(1, 3, 512, 384))))
    with torch.no_grad():
        want = model(img)
        got = model.cuda()(img.cuda())
    for k, w in want.items():
        torch.testing.assert_close(got[k].cpu(), w, atol=1e-3, rtol=1e-3, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("options", ["shadow_ao_sky_specular_tonemap", "soft_light_gi"])
def test_render_textured_on_the_card_matches_the_cpu(options):
    """A textured sphere (two materials, bilinear textures) over a ground
    quad at 128²: coverage and material equal, RGB within 1e-4 on at least
    99.9% of values and within 0.15 everywhere (the CPU tests' tolerance; the
    products with the light frame are multiply-adds on both devices, so a
    shadow-map tap flips only where their rounding does)."""
    need_card()
    from coma_tpu_torch.lifting import rasterizer

    rng = np.random.default_rng(11)
    verts, faces = uv_sphere(24, 32, 0.5)
    verts = verts + np.float32([0.0, 0.0, 0.7])
    ground = np.float32([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]])
    tri_w = np.concatenate([verts[faces], ground[[[0, 1, 2], [0, 2, 3]]]])
    n = np.cross(tri_w[:, 1] - tri_w[:, 0], tri_w[:, 2] - tri_w[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    res = 128
    tri_px = np.concatenate([(tri_w[..., :2] + 2.0) / 4.0 * res, -tri_w[..., 2:]], -1)
    T = len(tri_w)
    inputs = dict(tri_px=tri_px, tri_uv=rng.uniform(-1, 2, size=(T, 3, 2)),
                  tri_mat=np.arange(T) % 3, tri_n=n,
                  textures=rng.uniform(size=(3, 16, 16, 3)), tri_w=tri_w,
                  shadow_casters=tri_w[: len(faces)])
    if options == "shadow_ao_sky_specular_tonemap":
        kw = dict(ao_samples=8, specular=0.25, tonemap=True)
    else:
        kw = dict(light_samples=4, light_cone_deg=8.0, gi_samples=8)
    out = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.as_tensor(np.asarray(v, np.int64 if k == "tri_mat" else np.float32),
                                device=dev) for k, v in inputs.items()}
        env = {"env_map": rasterizer.make_sky_env(device=dev)} if "ao_samples" in kw else {}
        rgb, cov = rasterizer.render_textured(height=res, width=res, flip_y=False,
                                              light_dir=(0.4, 0.1, 1.0), **t, **kw, **env)
        attrs = rasterizer.rasterize_attributes(t["tri_px"], t["tri_uv"], t["tri_mat"],
                                                t["tri_n"], res, res, flip_y=False)
        out[dev] = [rgb.cpu(), cov.cpu(), attrs[2].cpu()]
    assert torch.equal(out["cuda"][1], out["cpu"][1]) and out["cpu"][1].any()
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    diff = (out["cuda"][0] - out["cpu"][0]).abs()
    assert (diff > 1e-4).float().mean() <= 1e-3 and diff.max() <= 0.15


@pytest.mark.cuda
def test_candidate_mask_fill_on_the_card_matches_the_cpu():
    """OpenCV's convex fill at 512² on 400 seeded quads that reach past the
    image on every side, and on degenerate hulls: the card's masks equal the
    CPU's (integer and double arithmetic on both)."""
    need_card()
    from coma_tpu_torch.geometry import polygon

    rng = np.random.default_rng(12)
    quads = rng.integers(-200, 712, size=(400, 4, 2))
    quads[:4] = [[[5, 5]] * 4, [[0, 0], [0, 0], [30, 30], [60, 60]],
                 [[-50, 100], [600, 100], [600, 100], [-50, 100]],
                 [[100, -9], [100, 900], [100, 900], [100, -9]]]
    want = polygon.fill_convex_hulls(quads, 512, 512, "cpu")
    got = polygon.fill_convex_hulls(quads, 512, 512, "cuda").cpu()
    assert want.any() and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the visualization and training slice on the card against the CPU (no
# kernel of the repo: plain PyTorch)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_volume_render_on_the_card_matches_the_cpu():
    """The occupancy volume render at 128², 48 steps, with a mesh pass:
    within 1e-4 on 99.9% of values and 1e-2 everywhere (the march's
    exponentials and the trilinear taps round differently on the card)."""
    need_card()
    from coma_tpu_torch.visualization.contact_viz import uv_sphere
    from coma_tpu_torch.visualization.volume import save_occupancy_volume_render

    rng = np.random.default_rng(13)
    field = rng.uniform(size=(20, 20, 20)).astype(np.float32) ** 4
    mesh = uv_sphere(np.array([1.0, -2.0, 0.5]), 5.0, 8, 12)
    kw = dict(mesh=mesh, resolution=128, num_steps=48)
    cpu = save_occupancy_volume_render(None, field, device="cpu", **kw)
    card = save_occupancy_volume_render(None, field, device="cuda", **kw)
    diff = np.abs(card - cpu)
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() <= 1e-2


@pytest.mark.cuda
def test_segmenter_training_step_on_the_card_matches_the_cpu(no_tf32):
    """One AdamW step of the person segmenter from the same seeded weights
    and batch (32², batch 2, lr 3e-4): the loss and every parameter whose
    CPU gradient is at least 1e-5 within 1e-4; the rest within 2.2 lr (Adam's
    first step divides a gradient by its own size, so a near-zero gradient
    may take either sign on the two devices)."""
    need_card()
    from coma_tpu_torch.models.layers import init_flax_default_
    from coma_tpu_torch.models.segmentation import PersonSegmenter
    from coma_tpu_torch.models.segmentation_train import SegTrainer
    from coma_tpu_torch.models.synthetic_person import person_batch

    lr = 3e-4
    imgs, masks = person_batch(np.random.default_rng(14), 2, 32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_flax_default_(PersonSegmenter(), torch.Generator().manual_seed(0)).to(dev)
        trainer = SegTrainer(model, lr, weight_decay=1e-4)
        loss = trainer.step(torch.as_tensor(imgs, device=dev), torch.as_tensor(masks, device=dev))
        out[dev] = (float(loss), {k: (p.detach().cpu(), p.grad.detach().cpu())
                                  for k, p in model.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for k, (p, g) in out["cpu"][1].items():
        err = (out["cuda"][1][k][0] - p).abs()
        assert float(torch.where(g.abs() >= 1e-5, err, torch.zeros_like(err)).max()) <= 1e-4, k
        assert float(err.max()) <= 2.2 * lr, k


# ---------------------------------------------------------------------------
# ranks sharing the card under gloo: --mesh inpainting (K3) and the 2-D
# aggregation (K1)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_mesh_inpaint_on_two_ranks_of_the_card_writes_the_one_process_pngs(tmp_path):
    """``--mesh 2 --dist_backend gloo`` with both ranks on card 0 against one
    process on the card (``--tiny --random_weights``, 4 items at
    ``--batch_size 2``): every PNG byte-equal."""
    need_card()
    import chip_smoke

    runs = {}
    for name, world, extra in (("one", 1, []), ("mesh", 2, ["--mesh", "2"])):
        root = tmp_path / name
        chip_smoke.write_inpaint_tree(str(root), np.random.default_rng(2))
        argv = ["-m", "coma_tpu_torch.cli.inpaint", "--tiny", "--random_weights",
                "--num_img_per_combination", "2", "--batch_size", "2",
                "--dist_backend", "gloo", *extra]
        spawn_command(world, argv, "torchrun" if world > 1 else None, cwd=root, timeout=300)
        base = root / "results" / "generation" / "inpaintings"
        runs[name] = {str(p.relative_to(base)): p.read_bytes() for p in base.rglob("*.png")}
    assert len(runs["one"]) == 4 and runs["mesh"] == runs["one"]


@pytest.mark.cuda
def test_aggregate_2d_on_four_ranks_of_the_card_matches_plain(tmp_path):
    """``sharded_contact_aggregate_2d`` on 4 gloo ranks on card 0 (2 data x 2
    model; 11 samples, one padded slot, a zero normal), K1 on every rank,
    gathered on rank 0, against the plain ``contact_update_batch`` of the
    samples on the card: K1's rtol 1e-4 / atol 1e-5."""
    need_card()
    rng = np.random.default_rng(5)
    B, H, O, N, params = 11, 40, 37, 250, (0.07, 0.24, 0.25)
    hv, ov = rng.normal(size=(B, H, 3)) * 0.3, rng.normal(size=(B, O, 3)) * 0.3
    hn, on = unit(rng.normal(size=(B, H, 3))), unit(rng.normal(size=(B, O, 3)))
    hn[:, 0] = 0.0
    valid = np.float32([1] * 9 + [0, 1])
    arrays = dict(hv=np.float32(hv), hn=np.float32(hn), ov=np.float32(ov), on=np.float32(on))
    np.savez(tmp_path / "in.npz", hon=np.int64([H, O, N]), params=np.float64(params),
             valid=valid, **arrays)
    ranks = f"{REPO}/tests/torch_mesh_ranks.py"
    reports = spawn_command(4, [ranks, "aggregate_2d", tmp_path / "in.npz", tmp_path / "out.npz",
                                2, 2, "cuda"], "torchrun", cwd=tmp_path, timeout=300)
    assert all(r[0]["rank"]["launches"] >= 1 for r in reports)
    plain = state.init_coma_state(H, O, N, *params, device="cuda")
    contact.contact_update_batch(plain, *(cuda(arrays[k]) for k in ("hv", "hn", "ov", "on")),
                                 valid=cuda(valid))
    with np.load(tmp_path / "out.npz") as got:
        for f in FIELDS:
            torch.testing.assert_close(torch.from_numpy(got[f]), getattr(plain, f).cpu(),
                                       rtol=1e-4, atol=1e-5)
        assert float(got["used_count"]) == 10.0
