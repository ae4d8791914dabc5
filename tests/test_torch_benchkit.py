"""Port parity: ``coma_tpu_torch.benchkit`` against ``coma_tpu.benchkit``.

Everything runs on the CPU at tiny sizes (JAX as the other tests run it, the
Pallas kernels in interpret mode): the seeded data are bit-equal; one K1 and
one K2 step on the bench's inputs leave the states ``coma_tpu``'s kernels
leave (K1 within 1e-5 + 1e-4·|x|, the JAX kernel tests' tolerance; K2's hits
equal); the production extraction writes products equal at the golden
tolerance (rtol 2e-5 / atol 1e-6) with the same breakdown keys, and
``run_affordance_extraction``'s ``timings`` and directory arguments behave as
``coma_tpu``'s; the suite emits the same keys for the same variants; the
meta-device FLOP count of the UNet is exact; the pipeline variants and the
dp curve run. The card's numbers come from ``chip_smoke.py`` phase 17.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from coma_tpu import benchkit as jb
from coma_tpu.affordance import state as j_state
from coma_tpu.ops.contact_kernel import fused_contact_update_batch as j_contact
from coma_tpu.ops.occupancy_kernel import fused_occupancy_update_batch as j_occupancy
from coma_tpu.pipelines.extract import run_affordance_extraction as j_extract
from coma_tpu_torch import benchkit as tb
from coma_tpu_torch.affordance.io import load_pickle
from coma_tpu_torch.models.diffusion.unet import UNet2DCondition, tiny_unet_config
from coma_tpu_torch.models.diffusion.vae import tiny_vae_config
from coma_tpu_torch.models.layers import init_flax_default_
from coma_tpu_torch.ops.contact_kernel import fused_contact_update_batch as t_contact
from coma_tpu_torch.ops.occupancy_kernel import fused_occupancy_update_batch as t_occupancy
from coma_tpu_torch.pipelines.extract import run_affordance_extraction as t_extract

TOL = dict(rtol=2e-5, atol=1e-6)
K1_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(num_samples=6, h=40, o=16, n=24)
BREAKDOWN = {"num_samples", "total_s", "compute_s", "aggregate_s", "export_s", "product_s",
             "samples_per_sec_incl_export", "fabricate_s", "products_saved"}
PHASES = {"aggregate_s", "export_s", "product_s"}
HYPER = dict(  # bench_extract_production's hyperparameters at TINY's o and n
    human_res="FULL", human_use_downsample_pcd_raw=False,
    object_res="16", object_use_downsample_pcd_raw=True,
    principle_vec=[0, 0, 1], sub_principle_vec=[0, 1, 0],
    rel_dist_method="dist", spatial_grid_size=tb.GRID_SIZE,
    spatial_grid_thres=0.5, normal_gaussian_sigma=tb.SIGMA,
    normal_res=24, spatial_res=0, eps=tb.EPS,
    significant_contact_ratio=0.1, enable_postfilter=False,
    standardize_human_scale=False, scaler_range=(0.75, 1.25),
    visualize_type="aggr-human-contact", vis_example_num=0,
    quant_mode=False, quant_keys=[],
)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: the test workers share the host's cores, and
    oversubscribed intra-op threads slow every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def assert_tree_close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "device":
                assert_tree_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=path, **TOL)
    else:
        assert a == b, path


def written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_outputs_close(got_root, want_root):
    """Same files under ``results/coma``; the state pickle and the products
    within TOL."""
    got, want = (written(os.path.join(r, "results", "coma")) for r in (got_root, want_root))
    assert got == want
    for rel in got:
        g, w = (os.path.join(r, "results", "coma", rel) for r in (got_root, want_root))
        if rel.endswith(".npy"):
            np.testing.assert_allclose(np.load(g), np.load(w), err_msg=rel, **TOL)
        elif rel.endswith(".pickle") and "extracted_coma" in rel:
            assert_tree_close(load_pickle(g), load_pickle(w), rel)


# ---------------------------------------------------------------- (a) data

def test_seeded_data_is_bit_equal():
    for got, want in zip(tb.make_samples(2), jb.make_samples(2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb._fibonacci(tb.N), jb._fibonacci(jb.N))
    for n_lat, n_lon in ((104, 101), (15, 14), (5, 4)):
        for got, want in zip(tb._uv_sphere(n_lat, n_lon), jb._uv_sphere(n_lat, n_lon)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert (tb.H, tb.O, tb.N, tb.SIGMA, tb.GRID_SIZE, tb.THRES, tb.EPS) == \
        (jb.H, jb.O, jb.N, jb.SIGMA, jb.GRID_SIZE, jb.THRES, jb.EPS)
    assert (tb.ITERS, tb.BASELINE_ITERS) == (jb.TPU_ITERS, jb.BASELINE_ITERS)
    assert (tb.RES, tb.LAT, tb.BATCH, tb.STEPS) == (jb.RES, jb.LAT, jb.BATCH, jb.STEPS)


# ------------------------------------------------------------ (c) K1 and K2

def test_one_coma_step_matches_coma_tpu():
    h, o, iters = 8, 6, 8   # one slab of coma_tpu's kernel
    state, samples = tb.coma_inputs(h, o, iters, "cpu")
    t_contact(state, *samples)
    with pltpu.force_tpu_interpret_mode():
        js = j_contact(j_state.init_coma_state(h, o, jb.N, jb.GRID_SIZE, jb.THRES, jb.SIGMA,
                                               eps=jb.EPS),
                       *(jnp.asarray(s.numpy()) for s in samples))
    for f in ("prob_grid_canon_human_wrt_obj", "prob_grid_canon_obj_wrt_human",
              "contact_dist_expectation_grid_nom", "contact_dist_expectation_grid_denom",
              "significant_contact_count", "used_count"):
        np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(js, f)),
                                   err_msg=f, **K1_TOL)
    assert float(state.prob_grid_canon_human_wrt_obj.sum()) > 0


def test_one_occupancy_step_matches_coma_tpu():
    h, o = 8, 6
    state, samples = tb.occupancy_inputs(h, o, tb.ITERS, "cpu")
    t_occupancy(state, *samples)
    with pltpu.force_tpu_interpret_mode():
        js = j_occupancy(j_state.init_occupancy_state(h, o, spatial_res=30,
                                                      scale_tolerance=1.5),
                         *(jnp.asarray(s.numpy()) for s in samples))
    np.testing.assert_array_equal(state.spatial_occupancy_grids.numpy(),
                                  np.asarray(js.spatial_occupancy_grids))
    assert float(state.spatial_occupancy_grids.sum()) > 0
    assert float(state.used_count) == float(js.used_count) == tb.ITERS
    np.testing.assert_array_equal(state.anchor_vert.numpy(), np.asarray(js.anchor_vert))


@pytest.mark.parametrize("bench", [tb.bench_coma, tb.bench_occupancy])
def test_sustained_rate_on_the_cpu(bench):
    rate, raw = bench(h=8, o=6, iters=4, device="cpu")
    assert rate > 0 and set(raw) == {"w1_s", "w2_s"}
    assert 0 < raw["w1_s"] and 0 < raw["w2_s"]


def test_coma_torch_cpu_baseline_runs_tiny():
    assert tb.bench_coma_torch_cpu(h=40, o=16) > 0


@pytest.mark.parametrize("call", [
    lambda: tb.bench_coma(), lambda: tb.bench_occupancy(),
    lambda: tb.bench_unet_step(), lambda: tb.bench_pipe_suite(print),
    lambda: tb._pipeline_rate(), lambda: tb.bench_dp_scaling(),
    lambda: tb.bench_extract_production(),
], ids=["coma", "occupancy", "unet_step", "pipe_suite", "pipeline_rate", "dp_scaling",
        "extract_production"])
def test_card_entry_points_raise_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()


# ------------------------------------- (b) extraction, and the timings repair

@pytest.fixture(scope="module")
def extract_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    cwd = os.getcwd()
    try:
        port = tb.bench_extract_production(workdir=str(root / "port"), device="cpu", **TINY)
        ref = jb.bench_extract_production(workdir=str(root / "jax"), **TINY)
    finally:
        os.chdir(cwd)
    return root, port, ref


def test_extract_production_matches_coma_tpu(extract_runs):
    root, (rate, breakdown), (j_rate, j_breakdown) = extract_runs
    assert rate > 0 and j_rate > 0
    assert set(breakdown) == set(j_breakdown) == BREAKDOWN
    assert breakdown["products_saved"] == j_breakdown["products_saved"] == 1
    assert breakdown["num_samples"] == TINY["num_samples"]
    assert_outputs_close(str(root / "port"), str(root / "jax"))


def test_timings_and_save_dirs_match_coma_tpu(extract_runs, tmp_path):
    """The repair: ``timings`` gets the three phases, the two directory
    arguments are taken and unused, the same files are written."""
    root = extract_runs[0]
    runs = {}
    for name, extract, extra in (("jax", j_extract, {}), ("port", t_extract, {"device": "cpu"})):
        d = tmp_path / name
        shutil.copytree(root / "jax", d)
        for sub in ("extracted_coma", "affordance"):
            shutil.rmtree(d / "results" / "coma" / sub)
        timings = {}
        saved = extract(
            HYPER, "qual:bench", supercategories=["behave"], categories=["backpack"],
            results_root=str(d / "results"), constants_mesh_dir=str(d / "constants" / "mesh"),
            coma_save_dir=str(d / "coma_save"), affordance_save_dir=str(d / "affordance_save"),
            verbose=False, timings=timings, **extra)
        assert len(saved) == 1 and set(timings) == PHASES, name
        assert all(v >= 0 for v in timings.values())
        assert not (d / "coma_save").exists() and not (d / "affordance_save").exists()
        runs[name] = d
    assert_outputs_close(str(runs["port"]), str(runs["jax"]))


# ----------------------------------------------------------------- (d) suite

def record_suite(mod, monkeypatch):
    calls, emitted = [], []

    def rate(**kw):
        calls.append({k: v for k, v in kw.items() if k not in ("shared", "device")})
        return 1.0

    monkeypatch.setattr(mod, "_pipeline_rate", rate)
    monkeypatch.setattr(mod, "bench_unet_step", lambda **kw: (0.01, 0.5))
    kwargs = {} if mod is jb else {"device": "cpu"}
    mod.bench_pipe_suite(emitted.append, **kwargs)
    return calls, emitted


def test_pipe_suite_emits_coma_tpus_keys_for_the_same_variants(monkeypatch):
    j_calls, j_emitted = record_suite(jb, monkeypatch)
    t_calls, t_emitted = record_suite(tb, monkeypatch)
    assert t_calls == j_calls
    assert [list(d) for d in t_emitted] == [list(d) for d in j_emitted]
    assert t_emitted == j_emitted   # the rates are the stubs'; the bucket is computed
    assert t_emitted[-1]["crop_mode_latent_bucket"] == 40


# ----------------------------------------------------------------- (e) FLOPs

def analytic_unet_flops(cfg, B, lat, L):
    """2·Cin·Cout·k²·HW per conv, 2·rows·Cin·Cout per dense layer and
    4·B·heads·Lq·Lk·D per attention, walked through the UNet's blocks."""
    conv = lambda cin, cout, k, hw: 2 * B * cin * cout * k * k * hw
    dense = lambda rows, cin, cout: 2 * rows * cin * cout
    attn = lambda heads, lq, lk, d: 4 * B * heads * lq * lk * d
    chs = cfg.block_out_channels
    temb = 4 * chs[0]

    def res(cin, cout, hw):
        f = conv(cin, cout, 3, hw) + dense(B, temb, cout) + conv(cout, cout, 3, hw)
        return f + (conv(cin, cout, 1, hw) if cin != cout else 0)

    def transformer(c, hw, heads):
        rows = B * hw
        f = 2 * conv(c, c, 1, hw)                                          # proj_in, proj_out
        f += 4 * dense(rows, c, c) + attn(heads, hw, hw, c // heads)       # self
        f += 2 * dense(rows, c, c) + 2 * dense(B * L, cfg.cross_attention_dim, c) \
            + attn(heads, hw, L, c // heads)                               # cross
        return f + dense(rows, c, 8 * c) + dense(rows, 4 * c, c)           # GEGLU

    s, ch = lat, chs[0]
    f = dense(B, chs[0], temb) + dense(B, temb, temb) + conv(cfg.in_channels, ch, 3, s * s)
    skips = [ch]
    for i, out in enumerate(chs):
        for _ in range(cfg.layers_per_block):
            f += res(ch, out, s * s)
            ch = out
            if cfg.cross_attn_blocks[i]:
                f += transformer(ch, s * s, cfg.heads_for(i))
            skips.append(ch)
        if i < len(chs) - 1:
            s //= 2
            f += conv(ch, ch, 3, s * s)
            skips.append(ch)
    f += res(ch, chs[-1], s * s) + transformer(chs[-1], s * s, cfg.heads_for(None)) \
        + res(chs[-1], chs[-1], s * s)
    ch = chs[-1]
    for i in reversed(range(len(chs))):
        for _ in range(cfg.layers_per_block + 1):
            f += res(ch + skips.pop(), chs[i], s * s)
            ch = chs[i]
            if cfg.cross_attn_blocks[i]:
                f += transformer(ch, s * s, cfg.heads_for(i))
        if i > 0:
            s *= 2
            f += conv(ch, ch, 3, s * s)
    return f + conv(ch, cfg.out_channels, 3, s * s)


def test_meta_flop_count_is_exact():
    from torch.utils.flop_counter import FlopCounterMode

    cfg, B, lat, L = tiny_unet_config(), 2, 8, 77
    meta = tb.unet_flops(cfg, B, lat, L)
    unet = init_flax_default_(UNet2DCondition(cfg), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(np.float32(rng.normal(size=(B, cfg.in_channels, lat, lat)))),
            torch.full((B,), 500.0),
            torch.from_numpy(np.float32(rng.normal(size=(B, L, cfg.cross_attention_dim)))))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        unet(*args)
    assert meta == counter.get_total_flops() == analytic_unet_flops(cfg, B, lat, L)


# ------------------------------------------------------- (f) the variants run

@pytest.mark.parametrize("kw", [
    dict(),
    dict(provoke_decode_factor=2),
    dict(mask_box=32, provoke_crop_latent=6),
], ids=["p", "fast_mode", "crop_mode"])
def test_pipeline_rate_runs_tiny_on_the_cpu(kw, monkeypatch):
    for name, value in (("RES", 64), ("LAT", 8), ("BATCH", 1), ("unet_config", tiny_unet_config),
                        ("vae_config", tiny_vae_config)):
        monkeypatch.setattr(tb, name, value)
    assert tb._pipeline_rate(iters=1, device="cpu", **kw) > 0


# --------------------------------------------------------------- (g) dp curve

def test_dp_scaling_curve_on_gloo_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    curve = tb.bench_dp_scaling(ranks=(1, 2), device="cpu")["flagship_dp_scaling"]
    assert list(curve) == ["1", "2"]
    for n, point in curve.items():
        assert set(point) >= {"batch", "step_s", "imgs_per_sec", "backend", "device"}
        assert point["batch"] == tb.DP_PER_RANK * int(n)
        assert point["step_s"] > 0 and point["imgs_per_sec"] > 0
        assert point["backend"] == "gloo" and point["device"] == ["cpu"] * int(n)
