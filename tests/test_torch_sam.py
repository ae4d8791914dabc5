"""SAM and the adaptive-mask predictors, the port against ``coma_tpu``.

One seeded state dict in the official ``sam_vit_b`` key layout (every
tensor drawn from the seed, the relative-position tables included, so
``add_decomposed_rel_pos`` is exercised; ``tests/test_sam.py`` writes it)
goes through ``coma_tpu``'s ``convert_sam`` on one side and the port's
direct loader on the other; the Flax tree loads into the port too, to the
same weights (the transposed convolutions' kernels flipped). The tiny
config (64² input) runs stage by stage, each stage fed the JAX stage's
outputs, and whole. Tolerance: logits and embeddings within atol 1e-4
(float32); boxes, masks of the predictors and the set-aside keys exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.models import mask_predictors as j_mp
from coma_tpu.models import sam as j_sam
from coma_tpu.models.torch_weights_sam import convert_sam
from coma_tpu.utils.checkpoint import save_params
from coma_tpu_torch.models import mask_predictors as t_mp
from coma_tpu_torch.models import sam as t_sam
from coma_tpu_torch.models import segmenter_weights as sw
from tests.test_sam import _official_tiny_state_dict

ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    cfg = j_sam.tiny_sam_config()
    sd = _official_tiny_state_dict(cfg, np.random.default_rng(21))
    # the upscaling's transposed convolutions x20, so the mask logits straddle
    # 0 (at the seed's std 0.05 they are all about +0.01) and masks are mixed
    for k in ("mask_decoder.output_upscaling.0.weight", "mask_decoder.output_upscaling.3.weight"):
        sd[k] = sd[k] * 20
    variables = convert_sam(sd, depth=cfg.depth)
    # tensors of the official file the box path never reads: set aside
    sd = dict(sd, **{"prompt_encoder.not_a_point_embed.weight": torch.zeros(1, 256),
                     "prompt_encoder.mask_downscaling.0.weight": torch.zeros(4, 1, 2, 2)})
    port = sw.load_state_strict(t_sam.SAM(t_sam.tiny_sam_config()), sw.sam_state_dict(sd)).eval()
    return j_sam.SAM(cfg), variables, port, sd


def test_weight_sources_load_the_same_parameters(models, tmp_path):
    _, variables, port, sd = models
    want = port.state_dict()
    save_params(variables, str(tmp_path / "sam.npz"))
    torch.save(sd, tmp_path / "sam.pth")
    for path in ("sam.npz", "sam.pth"):
        got = sw.load_sam_weights(t_sam.SAM(t_sam.tiny_sam_config()),
                                  str(tmp_path / path)).state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    with pytest.raises(KeyError, match="missing"):
        sw.load_state_strict(t_sam.SAM(), sw.sam_state_dict(sd))      # ViT-B widths


def test_rel_pos_and_windows_match():
    rng = np.random.default_rng(22)
    for q, k, rows in ((5, 5, 9), (4, 6, 11), (6, 3, 7), (5, 5, 13)):   # the last resized
        table = np.float32(rng.normal(size=(rows, 4)))
        np.testing.assert_allclose(t_sam.get_rel_pos(q, k, t(table)).numpy(),
                                   np.asarray(j_sam.get_rel_pos(q, k, jnp.asarray(table))),
                                   rtol=0, atol=1e-6)
    x = np.float32(rng.normal(size=(2, 7, 5, 3)))
    jw, jpad = j_sam.window_partition(jnp.asarray(x), 4)
    tw, tpad = t_sam.window_partition(t(x), 4)
    assert tpad == jpad
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(t_sam.window_unpartition(tw, 4, tpad, (7, 5)).numpy(), x)


@pytest.fixture(scope="module")
def jax_run(models):
    jm, variables, _, _ = models
    rng = np.random.default_rng(23)
    img = np.float32(rng.normal(size=(3, 64, 64, 3)))    # 3: the segment_fn test's batch
    boxes = np.float32([[8, 8, 40, 56], [0, 0, 63, 63], [30.5, 2, 33, 60]])
    ap = lambda m, *a: jax.tree.map(np.asarray, m.apply(
        {"params": variables["params"][m.name]}, *a))
    enc = j_sam.ImageEncoderViT(jm.config, name="image_encoder")
    pe = j_sam.PromptEncoder(jm.config, name="prompt_encoder")
    dec = j_sam.MaskDecoder(jm.config, name="mask_decoder")
    embed = ap(enc, jnp.asarray(img))
    sparse, dense, dense_pe = ap(pe, jnp.asarray(boxes))
    masks, iou = ap(dec, embed, dense_pe, sparse, dense)
    whole = jax.tree.map(np.asarray, jm.apply(variables, jnp.asarray(img), jnp.asarray(boxes)))
    return dict(img=img, boxes=boxes, embed=embed, sparse=sparse, dense=dense,
                dense_pe=dense_pe, masks=masks, iou=iou, whole=whole)


def test_image_encoder_matches(models, jax_run):
    port = models[2]
    with torch.no_grad():
        got = port.image_encoder(t(jax_run["img"]).permute(0, 3, 1, 2))
    assert got.shape == (3, 8, 8, 256)
    np.testing.assert_allclose(got.numpy(), jax_run["embed"], rtol=0, atol=ATOL)


def test_prompt_encoder_matches(models, jax_run):
    port = models[2]
    with torch.no_grad():
        sparse, dense, dense_pe = port.prompt_encoder(t(jax_run["boxes"]))
    np.testing.assert_allclose(sparse.numpy(), jax_run["sparse"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(dense.detach().numpy(), jax_run["dense"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(dense_pe.numpy(), jax_run["dense_pe"], rtol=0, atol=ATOL)


def test_mask_decoder_matches(models, jax_run):
    port = models[2]
    r = jax_run
    with torch.no_grad():
        masks, iou = port.mask_decoder(t(r["embed"]), t(r["dense_pe"]), t(r["sparse"]),
                                       t(r["dense"]))
    assert masks.shape == (3, 4, 32, 32)
    np.testing.assert_allclose(masks.numpy(), r["masks"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(iou.numpy(), r["iou"], rtol=0, atol=ATOL)


def test_whole_sam_matches(models, jax_run):
    port = models[2]
    with torch.no_grad():
        logits, iou = port(t(jax_run["img"]).permute(0, 3, 1, 2), t(jax_run["boxes"]))
    np.testing.assert_allclose(logits.numpy(), jax_run["whole"][0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(iou.numpy(), jax_run["whole"][1], rtol=0, atol=ATOL)


def test_predict_box_and_preprocess_match(models):
    jm, variables, port, _ = models
    rng = np.random.default_rng(24)
    image = (rng.random((48, 32, 3)) * 255).astype(np.uint8)           # non-square
    want = np.asarray(j_sam.preprocess_image(image, 64))
    got = t_sam.preprocess_image(image, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4)
    box = np.array([4, 4, 24, 40])
    j_mask = j_sam.sam_predict_box(jm, variables, image, box)
    t_mask = t_sam.sam_predict_box(port, image, box)
    assert t_mask.shape == (48, 32) and t_mask.dtype == np.uint8 and 0 < j_mask.mean() < 1
    np.testing.assert_array_equal(t_mask, j_mask)


def test_mask_to_bbox_matches():
    m = np.zeros((3, 10, 12), np.float32)
    m[0, 3:7, 4:9] = 1
    m[1, 9, 0] = 1                        # m[2] stays empty: the full-image box
    want = np.stack([np.asarray(j_sam.mask_to_bbox_traced(jnp.asarray(x))) for x in m])
    np.testing.assert_array_equal(t_sam.mask_to_bbox_traced(t(m)).numpy(), want)
    np.testing.assert_array_equal(want, [[4, 3, 8, 6], [0, 9, 0, 9], [0, 0, 11, 9]])


def test_sam_segment_fn_matches(models):
    """The in-loop 'ps' route at 64²: a fixed seed mask per image (one of
    them empty: the full-image box), SAM refining it; equal masks."""
    jm, variables, port, _ = models
    rng = np.random.default_rng(25)
    imgs = np.float32(rng.uniform(size=(3, 64, 64, 3)))
    seed = np.zeros((3, 64, 64), np.float32)
    seed[0, 10:50, 20:40] = 1
    seed[1, 0:20, 30:64] = 1
    j_fn = j_sam.make_sam_segment_fn(jm, lambda prm, x: jnp.asarray(seed))
    want = np.asarray(j_fn({"sam": variables}, jnp.asarray(imgs)))
    got = t_sam.make_sam_segment_fn(port, lambda x: t(seed))(t(imgs).permute(0, 3, 1, 2))
    assert got.shape == (3, 64, 64) and 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["p", "baseline", "ps", "ps_ae", "s_pdb_ae", "s_db_ae",
                                  "s_ab_ae"])
def test_predictors_match(models, mode):
    """Every ``--adaptive_mask_model_type`` predictor with SAM as the box
    model, over three calls (the accumulating one unions its boxes)."""
    jm, variables, port, _ = models
    rng = np.random.default_rng(26)
    person = np.zeros((64, 64), bool)
    person[10:50, 20:40] = True
    default = np.zeros((64, 64), np.float32)
    default[30:60, 5:45] = 1
    mask_model = lambda img: [{"mask": person, "score": 0.95}, {"mask": ~person, "score": 0.5}]
    j_pred = j_mp.build_predictor(mode, mask_model, j_sam.make_box_model(jm, variables))
    t_pred = t_mp.build_predictor(mode, mask_model, t_sam.make_box_model(port))
    for pred in (j_pred, t_pred):
        if hasattr(pred, "register_default_mask"):
            pred.register_default_mask(default)
    for _ in range(3):
        image = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        want, got = j_pred(image), t_pred(image)
        assert want.keys() == got.keys()
        for k in want:
            if want[k] is None:
                assert got[k] is None, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode == "s_ab_ae":
        assert len(t_pred.accumulated) == 3
