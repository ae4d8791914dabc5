"""PointRend R50-FPN, the port against ``coma_tpu``, stage by stage and whole.

One seeded detectron2-layout state dict (``tests/torch_pointrend_mirror.py``
with randomized frozen batch-norm statistics) goes through ``coma_tpu``'s
``convert_pointrend`` on one side and the port's direct loader on the
other; the Flax tree loads into the port as well, to the same weights.
The network runs at the ``--tiny`` config of ``coma_tpu/cli/inpaint.py:235``
on a 64x96 input. Each stage gets the same inputs on both sides (the JAX
stage's outputs), so a difference cannot compound. Tolerances: the same
valid slots and classes, exactly; boxes within 1e-3 px; scores within 5e-5
(softmax of logits that passed 50 float32 layers summed in another order:
the largest seen is 1.2e-5 at 0.995); mask logits within 1e-3; FPN maps
within 1e-4 of their largest magnitude. NMS, top-K ties and the paste are
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models import pointrend as jpr
from coma_tpu.models.torch_weights_pointrend import convert_pointrend
from coma_tpu.utils.checkpoint import save_params
from coma_tpu_torch.models import pointrend as tpr
from coma_tpu_torch.models import segmenter_weights as sw
from tests import torch_pointrend_mirror as mirror

TINY = dict(max_detections=4, test_size=64, pre_nms_topk=64, post_nms_topk=32, box_candidates=32)
BOX_ATOL, SCORE_ATOL, MASK_ATOL = 1e-3, 5e-5, 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(7)
    m = mirror.PointRendRCNNMirror().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, mirror.FrozenBN):
                mod.running_mean.copy_(torch.randn_like(mod.running_mean) * 0.1)
                mod.running_var.copy_(torch.rand_like(mod.running_var) + 0.5)
                mod.weight.copy_(torch.rand_like(mod.weight) + 0.5)
                mod.bias.copy_(torch.randn_like(mod.bias) * 0.1)
    sd = {k: v for k, v in m.state_dict().items() if "._box." not in k}
    # the box regressions and classifier made constant (the seeded network's
    # activations reach 1e4 at pixel scale and push every box off the frame):
    # proposals are the anchors, which overlap in long NMS chains, and every
    # proposal is a person (the class the paste keeps) at one score, so ties
    # go to top-K
    for name in ("proposal_generator.rpn_head.anchor_deltas", "roi_heads.box_predictor.cls_score",
                 "roi_heads.box_predictor.bbox_pred"):
        sd[f"{name}.weight"].zero_()
        sd[f"{name}.bias"].zero_()
    sd["roi_heads.box_predictor.cls_score.bias"][0] = 10.0
    return sd, convert_pointrend(sd)


@pytest.fixture(scope="module")
def models(weights):
    sd, variables = weights
    cfg = tpr.PointRendConfig(**TINY)
    port = sw.load_state_strict(tpr.PointRendModel(cfg), sw.pointrend_state_dict(sd)).eval()
    return jpr.PointRendModel(jpr.PointRendConfig(**TINY)), variables, port


@pytest.fixture(scope="module")
def jax_run(models):
    """``coma_tpu``'s stages on one 64x96 preprocessed input."""
    jm, variables, _ = models
    img = np.float32(np.random.default_rng(1).normal(size=(64, 96, 3)) * 50)
    hw = img.shape[:2]
    ap = lambda *a, method: jax.tree.map(np.asarray, jm.apply(variables, *a, method=method))
    fpn = ap(jnp.asarray(img), method=jm.features)
    prop, prop_valid = ap(fpn, hw, method=jm.rpn)
    det = ap(fpn, prop, prop_valid, hw, method=jm.detect)
    masks = ap(fpn["p2"], det["boxes"], det["classes"], method=jm.point_rend_masks)
    return dict(img=img, fpn=fpn, prop=prop, prop_valid=prop_valid, det=det, masks=masks)


def nchw(fpn):
    return {k: t(v).permute(2, 0, 1)[None] for k, v in fpn.items()}


def test_weight_sources_load_the_same_parameters(weights, models, tmp_path):
    """The d2 state dict, its raw ``.pkl`` numpy form and ``coma_tpu``'s
    Flax ``.npz`` give the port the same parameters; a stray key raises."""
    import pickle

    sd, variables = weights
    _, _, port = models
    want = port.state_dict()
    save_params(variables, str(tmp_path / "pr.npz"))
    with open(tmp_path / "pr.pkl", "wb") as fh:
        pickle.dump({"model": {k: v.numpy() for k, v in sd.items()}}, fh)
    torch.save(sd, tmp_path / "pr.pth")
    for path in ("pr.npz", "pr.pkl", "pr.pth"):
        got = sw.load_pointrend_weights(tpr.PointRendModel(tpr.PointRendConfig(**TINY)),
                                        str(tmp_path / path)).state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    with pytest.raises(KeyError, match="unused"):
        sw.load_state_strict(tpr.PointRendModel(), dict(sw.pointrend_state_dict(sd), extra=np.ones(1)))
    bad = sw.pointrend_state_dict(sd)
    bad["box.fc1.weight"] = bad["box.fc1.weight"][:, :10]
    with pytest.raises(ValueError, match="box.fc1.weight"):
        sw.load_state_strict(tpr.PointRendModel(), bad)


def test_features_match(models, jax_run):
    _, _, port = models
    with torch.no_grad():
        got = port.features(t(jax_run["img"]).permute(2, 0, 1)[None])
    for k, want in jax_run["fpn"].items():
        g = got[k][0].permute(1, 2, 0).numpy()
        assert g.shape == want.shape, k
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_rpn_matches(models, jax_run):
    _, _, port = models
    with torch.no_grad():
        boxes, valid = port.rpn(nchw(jax_run["fpn"]), (64, 96))
    np.testing.assert_array_equal(valid[0].numpy(), jax_run["prop_valid"])
    np.testing.assert_allclose(boxes[0].numpy(), jax_run["prop"], rtol=0, atol=BOX_ATOL)


def test_detect_matches(models, jax_run):
    _, _, port = models
    with torch.no_grad():
        det = port.detect(nchw(jax_run["fpn"]), t(jax_run["prop"])[None],
                          t(jax_run["prop_valid"])[None], (64, 96))
    want = jax_run["det"]
    assert want["valid"].any()
    np.testing.assert_array_equal(det["valid"][0].numpy(), want["valid"])
    np.testing.assert_array_equal(det["classes"][0].numpy(), want["classes"])
    np.testing.assert_allclose(det["boxes"][0].numpy(), want["boxes"], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(det["scores"][0].numpy(), want["scores"], rtol=0, atol=SCORE_ATOL)


def test_point_rend_masks_match(models, jax_run):
    _, _, port = models
    det = jax_run["det"]
    p2 = t(jax_run["fpn"]["p2"])[None]
    with torch.no_grad():
        got = port.point_rend_masks(p2, t(det["boxes"])[None], t(det["classes"])[None])[0]
    assert got.shape == (4, 224, 224)
    np.testing.assert_allclose(got.numpy(), jax_run["masks"], rtol=0, atol=MASK_ATOL)


def test_whole_model_matches(models, jax_run):
    jm, variables, port = models
    want = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(jax_run["img"])))
    with torch.no_grad():
        got = {k: v[0].numpy() for k, v in port(t(jax_run["img"]).permute(2, 0, 1)[None]).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got["mask_logits"], want["mask_logits"], rtol=0, atol=MASK_ATOL)


# ------------------------------------------------------------------ NMS and top-K

def chain_boxes(n):
    """Each box overlaps its neighbour by IoU 0.6: under t = 0.5 greedy keeps
    every other box, a chain of n dependent decisions."""
    x = np.arange(n, dtype=np.float32) * 0.25
    return np.stack([x, np.zeros(n), x + 1, np.ones(n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["chain", "ties", "random", "padded"])
def test_greedy_nms_matches_coma_tpu(case):
    rng = np.random.default_rng(11)
    if case == "chain":
        boxes, scores = chain_boxes(40), np.linspace(1, 0, 40, dtype=np.float32)
    elif case == "ties":           # identical boxes and equal scores
        boxes = np.repeat(chain_boxes(6), 3, axis=0)
        scores = np.ones(18, np.float32)
    else:
        c = rng.uniform(0, 50, size=(120, 2))
        wh = rng.uniform(2, 20, size=(120, 2))
        boxes = np.float32(np.concatenate([c, c + wh], axis=1))
        scores = np.float32(np.sort(rng.uniform(size=120))[::-1])
        if case == "padded":
            scores[90:] = -np.inf
    want = np.asarray(jpr.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    tpr.reset_nms_stats()
    got = tpr.greedy_nms(t(boxes), t(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpr.greedy_nms_loop(t(boxes), t(scores), 0.5).numpy(), want)
    if case == "chain":
        np.testing.assert_array_equal(want, np.arange(40) % 2 == 0)
        assert tpr.NMS_STATS["max_rounds"] >= 20       # one round per link, as the docstring says
    # batched over a leading axis: each set as alone
    both = tpr.greedy_nms(t(np.stack([boxes, boxes[::-1]])), t(np.stack([scores, scores])), 0.5)
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(), np.asarray(jpr.greedy_nms(jnp.asarray(boxes[::-1].copy()),
                                                   jnp.asarray(scores), 0.5)))


def test_topk_breaks_ties_as_jax():
    x = np.float32([3, 1, 3, -np.inf, 2, -np.inf, 3, 0, -np.inf, 1])
    for k in (1, 4, 10):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tpr.topk(t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_box_helpers_match():
    rng = np.random.default_rng(12)
    anchors = np.float32(rng.uniform(0, 100, size=(30, 4)))
    anchors[:, 2:] += anchors[:, :2]
    deltas = np.float32(rng.normal(size=(30, 4)) * 2)
    deltas[0, 2:] = 20.0                                   # past the scale clamp
    np.testing.assert_allclose(
        tpr.decode_deltas(t(anchors), t(deltas), (10.0, 10.0, 5.0, 5.0)).numpy(),
        np.asarray(jpr.decode_deltas(jnp.asarray(anchors), jnp.asarray(deltas),
                                     (10.0, 10.0, 5.0, 5.0))), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tpr.pairwise_iou(t(anchors), t(anchors[::-1].copy())).numpy(),
                               np.asarray(jpr.pairwise_iou(jnp.asarray(anchors),
                                                           jnp.asarray(anchors[::-1]))),
                               rtol=1e-6, atol=1e-7)
    for hw in ((8, 8), (5, 7)):
        for a, b in zip(tpr.generate_anchors([hw] * 5), jpr.generate_anchors([hw] * 5)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpr.regular_grid_coords(7).numpy(),
                                  np.asarray(jpr.regular_grid_coords(7)))


# ------------------------------------------------------------------ pre/post processing

def test_preprocess_and_paste_match():
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, size=(50, 70, 3), dtype=np.uint8)
    cfg = jpr.PointRendConfig(test_size=80)
    want, want_scale = jpr.preprocess_image(img, cfg)
    got, got_scale = tpr.preprocess_image(img, tpr.PointRendConfig(test_size=80))
    assert got_scale == want_scale and got.shape == want.shape == (96, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    logits = np.float32(rng.normal(size=(3, 28, 28)))
    boxes = np.float32([[3.3, 4.1, 40.7, 30.2], [-5, -5, 20, 20], [60, 40, 90, 70]])
    np.testing.assert_array_equal(tpr.paste_masks(logits, boxes, (50, 70)),
                                  jpr.paste_masks(logits, boxes, (50, 70)))


@pytest.mark.parametrize("stride", [1, 4])
def test_merged_person_mask_matches(stride):
    rng = np.random.default_rng(14)
    det = dict(boxes=np.float32([[2, 3, 40, 50], [10, 0, 60, 30], [0, 0, 64, 64]]),
               scores=np.float32([0.9, 0.85, 0.95]), classes=np.int32([0, 0, 3]),
               valid=np.array([True, True, True]),
               mask_logits=np.float32(rng.normal(size=(3, 28, 28))))
    want = np.asarray(jpr.merged_person_mask(jax.tree.map(jnp.asarray, det), (64, 64),
                                             (1.25, 0.75), 0.8, paste_stride=stride))
    got = tpr.merged_person_mask({k: t(v)[None] for k, v in det.items()}, (64, 64),
                                 (1.25, 0.75), 0.8, paste_stride=stride, chunk=2)[0].numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def test_segment_fn_and_person_segmenter_match(models, weights):
    """The in-loop segment_fn on a batch of 2 (64², the ``--tiny`` scale)
    and the host adapter on a 96x80 image, against ``coma_tpu``'s; then the
    bf16 route of ``--pointrend_fast`` (stride-4 paste) against the float32
    masks, by pixel agreement."""
    jm, variables, port = models
    rng = np.random.default_rng(15)
    imgs = np.float32(rng.uniform(size=(2, 64, 64, 3)))
    # score threshold 0: the seeded weights' detections reach the paste
    want = np.asarray(jax.jit(jpr.make_pointrend_segment_fn(jm, score_thresh=0.0))(
        {"pointrend": variables}, jnp.asarray(imgs)))
    t_imgs = t(imgs).permute(0, 3, 1, 2)
    got = tpr.make_pointrend_segment_fn(port, score_thresh=0.0)(t_imgs).numpy()
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got, want)
    fast = tpr.make_pointrend_segment_fn(port, score_thresh=0.0, compute_dtype=torch.bfloat16,
                                         paste_stride=4)(t_imgs).numpy()
    assert fast.shape == got.shape and set(np.unique(fast)) <= {0.0, 1.0}
    assert (fast == got).mean() >= 0.9, (fast == got).mean()

    image = (rng.uniform(size=(96, 80, 3)) * 255).astype(np.uint8)
    j_inst = jpr.PointRendPersonSegmenter(variables, jpr.PointRendConfig(**TINY), 0.0)(image)
    t_inst = tpr.PointRendPersonSegmenter(port, 0.0)(image)
    assert len(t_inst) == len(j_inst)
    for a, b in zip(t_inst, j_inst):
        np.testing.assert_array_equal(a["mask"], b["mask"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=BOX_ATOL)
        assert abs(a["score"] - b["score"]) <= SCORE_ATOL and a["pred_class"] == 0
