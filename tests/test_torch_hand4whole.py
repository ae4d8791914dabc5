"""Hand4Whole and the mocap adapter, the port against ``coma_tpu`` on the CPU.

Each submodule runs on the same seeded inputs with its Flax counterpart's
parameters carried across by ``models/flax_params.py`` (batch statistics
and biases perturbed so every mapping is exercised); then the whole model,
its towers cut to one block per stage (``coma_tpu.models.hand4whole.
ResNet`` monkeypatched in the test only), at batch 2; then the published
widths at batch 1; then ``Hand4WholeRegressor.regress``; then a seeded
state dict in ``snapshot_6.pth.tar``'s ``network`` layout, read by the
port's loader on one side and by ``convert_hand4whole`` on the other.

Tolerances: the helpers within 1e-5 (sampling, crops, boxes) and 1e-6
(soft-argmax); convolution towers rtol 1e-4 / atol 1e-4 of features of
order 1; the model's outputs atol 1e-4 + rtol 1e-4, axis-angle poses atol
1e-3 (near θ = π the axis is the normalised skew part, whose float32
rounding grows as 1/sin θ); the regressor's pixel-space mesh rtol 1e-4 /
atol 1e-2 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coma_tpu.models.hand4whole as JH
import coma_tpu.models.torch_weights as j_tw
from coma_tpu.models import resnet as j_resnet
from coma_tpu.models import smplx as j_smplx
from coma_tpu.pipelines import mocap as j_mocap
from coma_tpu_torch.models import hand4whole as TH
from coma_tpu_torch.models import resnet as t_resnet
from coma_tpu_torch.models import smplx as t_smplx
from coma_tpu_torch.models.flax_params import load_flax_params
from coma_tpu_torch.pipelines import mocap as t_mocap

SMALL = (1, 1, 1, 1)
POSES = ("root_pose", "body_pose", "lhand_pose", "rhand_pose", "jaw_pose")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def nchw(x):
    return t(np.asarray(x)).permute(0, 3, 1, 2)


def perturbed(variables, seed):
    """Biases, batch-norm scales and statistics drawn away from Flax's init."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = np.float32(rng.uniform(0.5, 1.5, size=v.shape))
            elif k in ("mean", "bias"):
                v = np.float32(v + rng.normal(size=v.shape) * 0.05)
            elif k == "scale":
                v = np.float32(rng.uniform(0.8, 1.2, size=v.shape))
            out[k] = v
        return out

    return walk({k: dict(v) for k, v in variables.items()})


def init_flax(module, *inputs, seed=0):
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)
    return perturbed(jax.tree_util.tree_map(np.asarray, dict(variables)), seed)


def small_towers(monkeypatch):
    """Both packages' Hand4Whole with one block per stage in every tower."""
    j_cls, t_cls = JH.ResNet, TH.ResNet
    monkeypatch.setattr(JH, "ResNet", lambda stages, bottleneck, dtype, name: j_cls(
        SMALL, bottleneck, dtype, name=name))
    monkeypatch.setattr(TH, "ResNet", lambda stages, bottleneck: t_cls(SMALL, bottleneck))


def small_variables(seed=0):
    """Flax variables of the cut Hand4Whole (call under ``small_towers``)."""
    return init_flax(JH.Hand4Whole(), jnp.zeros((1, 512, 384, 3)), seed=seed)


def port_model(variables):
    return load_flax_params(TH.Hand4Whole(), variables).eval()


def assert_outputs_match(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = 1e-3 if k in POSES else 1e-4
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=1e-4,
                                   atol=atol, err_msg=k)


# ----------------------------------------------------------------- helpers ----

def test_helpers_match():
    rng = np.random.default_rng(0)
    hm3 = np.float32(rng.normal(size=(2, 3, 8, 8, 6)) * 3)
    got, gp = TH.soft_argmax_3d(t(hm3))
    want, wp = JH.soft_argmax_3d(jnp.asarray(hm3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-6)
    hm2 = np.float32(rng.normal(size=(2, 3, 64, 48)) * 3)
    np.testing.assert_allclose(TH.soft_argmax_2d(t(hm2)).numpy(),
                               np.asarray(JH.soft_argmax_2d(jnp.asarray(hm2))), atol=1e-4)
    feat = np.float32(rng.normal(size=(2, 8, 6, 5)))                 # NHWC
    xy = np.float32(rng.uniform(-2, 9, size=(2, 7, 2)))               # some off the map
    xy[0, 0] = (4.0, 7.0)                                             # on the far corner
    np.testing.assert_allclose(
        TH.sample_joint_features(nchw(feat), t(xy)).numpy(),
        np.asarray(JH.sample_joint_features(jnp.asarray(feat), jnp.asarray(xy))), atol=1e-5)
    img = np.float32(rng.uniform(size=(2, 40, 30, 3)))
    boxes = np.float32([[3.0, 4.0, 25.0, 33.0], [-5.0, 10.0, 45.0, 50.0]])
    got = TH.crop_and_resize(nchw(img), t(boxes), (16, 12)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JH.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), (16, 12)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    c, s = np.float32(rng.normal(size=(3, 2)) * 5), np.float32(rng.uniform(1, 9, size=(3, 2)))
    np.testing.assert_allclose(TH.restore_bbox(t(c), t(s), 0.75, 1.5).numpy(),
                               np.asarray(JH.restore_bbox(jnp.asarray(c), jnp.asarray(s), 0.75,
                                                          1.5)), atol=1e-5)
    cam = np.float32(rng.normal(size=(4, 3)))
    np.testing.assert_allclose(TH.get_camera_trans(t(cam)).numpy(),
                               np.asarray(JH.get_camera_trans(jnp.asarray(cam))), rtol=1e-6)
    x6 = np.float32(rng.normal(size=(50, 6)))
    np.testing.assert_allclose(TH.rot6d_to_axis_angle(t(x6)).numpy(),
                               np.asarray(JH.rot6d_to_axis_angle(jnp.asarray(x6))), atol=1e-4)


def test_antialiased_resize_matches_jax():
    """The 512x384 -> 256x192 reduction: PyTorch's antialiased bilinear has
    the taps of ``jax.image.resize``'s, border renormalisation included."""
    img = np.float32(np.random.default_rng(1).uniform(size=(1, 512, 384, 3)))
    want = np.asarray(jax.image.resize(jnp.asarray(img), (1, 256, 192, 3), "bilinear"))
    got = torch.nn.functional.interpolate(nchw(img), size=(256, 192), mode="bilinear",
                                          align_corners=False, antialias=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6)


# --------------------------------------------------------------- submodules ----

@pytest.mark.parametrize("bottleneck,stages,size", [(True, (2, 1, 1, 1), 64),
                                                    (False, (2, 2, 1, 1), 48)])
def test_resnet_matches(bottleneck, stages, size):
    x = np.float32(np.random.default_rng(2).uniform(size=(2, size, size, 3)))
    jm = j_resnet.ResNet(stages, bottleneck)
    variables = init_flax(jm, jnp.asarray(x), seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = load_flax_params(t_resnet.ResNet(stages, bottleneck), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.shape[-1] == tm.feat_dim
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factory,size", [("resnet50", 64), ("resnet18", 48)])
def test_resnet_factories_match(factory, size):
    """``resnet50`` / ``resnet18`` at their published depths: Flax parameters
    carried across, features within 1e-4."""
    x = np.float32(np.random.default_rng(5).uniform(size=(1, size, size, 3)))
    jm = getattr(j_resnet, factory)()
    variables = init_flax(jm, jnp.asarray(x), seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = load_flax_params(getattr(t_resnet, factory)(), variables).eval()
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.shape[-1] == tm.feat_dim == jm.feat_dim
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_heads_match():
    """PositionNet, BoxNet (its deconvolutions double H exactly), both
    RotationNets and the FaceRegressor on the published feature shapes."""
    rng = np.random.default_rng(3)
    B = 2
    feat = np.float32(rng.normal(size=(B, 8, 6, 2048)) * 0.5)
    hand_feat = np.float32(rng.normal(size=(2 * B, 8, 8, 2048)) * 0.5)
    face_feat = np.float32(rng.normal(size=(B, 6, 6, 512)))

    pos = JH.PositionNet(25, JH.OUTPUT_HM_SHAPE)
    v = init_flax(pos, jnp.asarray(feat), seed=3)
    want_hm, want_img = pos.apply(v, jnp.asarray(feat))
    tpos = load_flax_params(TH.PositionNet(25, TH.OUTPUT_HM_SHAPE, 2048), v)
    with torch.no_grad():
        got_hm, got_img = tpos(nchw(feat))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_hm.numpy(), np.asarray(want_hm), atol=1e-5)

    box = JH.BoxNet()
    v = init_flax(box, jnp.asarray(feat), want_hm, want_img, seed=4)
    want = box.apply(v, jnp.asarray(feat), want_hm, want_img)
    tbox = load_flax_params(TH.BoxNet(), v).eval()
    with torch.no_grad():
        x = nchw(feat)
        up = torch.cat([x, got_hm.reshape(B, -1, 8, 6)], 1)
        for i in range(3):
            up = getattr(tbox, f"deconv_{i}")(up)
        assert up.shape[-2:] == (64, 48)      # 2H per deconvolution
        got = tbox(x, got_hm, got_img)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)

    mcp = np.float32(rng.uniform(0, 7, size=(B, 4, 3)))
    rot = JH.RotationNetBody()
    args = (jnp.asarray(feat), want_img, jnp.asarray(hand_feat[:B]), jnp.asarray(mcp),
            jnp.asarray(hand_feat[B:]), jnp.asarray(mcp[:, ::-1]))
    v = init_flax(rot, *args, seed=5)
    want = rot.apply(v, *args)
    trot = load_flax_params(TH.RotationNetBody(), v).eval()
    with torch.no_grad():
        got = trot(nchw(feat), got_img, nchw(hand_feat[:B]), t(mcp), nchw(hand_feat[B:]),
                   t(mcp[:, ::-1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)

    hjoint = np.float32(rng.uniform(0, 7, size=(2 * B, 20, 3)))
    hand = JH.RotationNetHand()
    v = init_flax(hand, jnp.asarray(hand_feat), jnp.asarray(hjoint), seed=6)
    thand = load_flax_params(TH.RotationNetHand(), v).eval()
    with torch.no_grad():
        got = thand(nchw(hand_feat), t(hjoint))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(hand.apply(v, jnp.asarray(hand_feat),
                                                     jnp.asarray(hjoint))), rtol=1e-4, atol=1e-4)

    face = JH.FaceRegressor()
    v = init_flax(face, jnp.asarray(face_feat), seed=7)
    tface = load_flax_params(TH.FaceRegressor(), v)
    with torch.no_grad():
        got = tface(nchw(face_feat))
    for g, w in zip(got, face.apply(v, jnp.asarray(face_feat))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ whole model ----

@pytest.fixture(scope="module")
def small(request):
    """(Flax variables, coma_tpu model, port model) with cut towers."""
    mp = pytest.MonkeyPatch()
    small_towers(mp)
    request.addfinalizer(mp.undo)
    variables = small_variables()
    return variables, JH.Hand4Whole(), port_model(variables)


def test_whole_model_matches(small):
    variables, jm, tm = small
    img = np.float32(np.random.default_rng(8).uniform(size=(2, 512, 384, 3)))
    want = jax.jit(jm.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(nchw(img))
    assert_outputs_match(got, want)


def test_regressor_matches(small):
    variables, _, tm = small
    j_model = j_smplx.random_model(num_verts=64, num_betas=10, num_expr=10)
    t_model = t_smplx.random_model(num_verts=64, num_betas=10, num_expr=10, device="cpu")
    rng = np.random.default_rng(9)
    image = (rng.uniform(size=(300, 400, 3)) * 255).astype(np.uint8)
    boxes = [[100, 50, 120, 200], [0, 0, 0, 10]]        # the second is empty
    want = j_mocap.Hand4WholeRegressor(variables, j_model).regress(image, boxes)
    got = t_mocap.Hand4WholeRegressor(tm, t_model).regress(image, boxes)
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    np.testing.assert_array_equal(g.faces, w.faces)
    for field in ("pred_vertices_img", "pelvis_xyz", "joints_proj", "joints_img"):
        np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=1e-4, atol=1e-2,
                                   err_msg=field)
    assert sorted(g.smplx_data) == sorted(w.smplx_data)
    for k, v in w.smplx_data.items():
        np.testing.assert_allclose(g.smplx_data[k], v, rtol=1e-4,
                                   atol=1e-3 if "pose" in k or k == "global_orient" else 1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(g.convert_data["z_mean"], w.convert_data["z_mean"], rtol=1e-5)
    np.testing.assert_allclose(g.convert_data["focals"], w.convert_data["focals"])
    np.testing.assert_allclose(g.convert_data["princpt"], w.convert_data["princpt"])
    patch = t_mocap.crop_patch(image, np.float32([10, 20, 150, 200]), device="cpu")
    np.testing.assert_allclose(patch[0].permute(1, 2, 0).numpy(),
                               j_mocap.crop_patch(image, np.float32([10, 20, 150, 200])),
                               atol=1e-5)
    for box in ([10, 20, 30, 90], [-5, 3, 500, 20], [5, 5, 0, 4]):
        want_box = j_mocap.process_bbox(np.float32(box), 400, 300)
        got_box = t_mocap.process_bbox(np.float32(box), 400, 300)
        assert (want_box is None) == (got_box is None)
        if want_box is not None:
            np.testing.assert_array_equal(got_box, want_box)


def test_published_widths_batch_one(monkeypatch):
    """The published towers (ResNet-50, -50, -18) at batch 1."""
    monkeypatch.setattr(JH, "ResNet", j_resnet.ResNet)   # whatever the module fixture cut
    monkeypatch.setattr(TH, "ResNet", t_resnet.ResNet)
    img = np.float32(np.random.default_rng(10).uniform(size=(1, 512, 384, 3)))
    jm = JH.Hand4Whole()
    variables = init_flax(jm, jnp.asarray(img), seed=10)
    want = jax.jit(jm.apply)(variables, jnp.asarray(img))
    tm = load_flax_params(TH.Hand4Whole(), variables).eval()
    assert sum(p.numel() for p in tm.parameters()) > 70e6
    with torch.no_grad():
        got = tm(nchw(img))
    assert_outputs_match(got, want)


# -------------------------------------------------- the published layout ----

def torch_layout(port: TH.Hand4Whole, rng) -> dict:
    """A ``snapshot_6.pth.tar`` ``network`` state dict whose weights are the
    port model's, ``module.``-prefixed, with biases on the RotationNets'
    convs (folded into the norms' means by both loaders) and BatchNorm's
    ``num_batches_tracked``."""
    towers = {"body_backbone.": "backbone.", "hand_backbone.": "hand_roi_net.backbone.",
              "face_backbone.": "face_roi_net.backbone."}
    heads = [(r"(body|hand)_position_net\.conv\.", r"\1_position_net.conv.0."),
             (r"body_rotation_net\.(body|lhand|rhand)_conv\.", r"body_rotation_net.\1_conv.0."),
             (r"body_rotation_net\.(body|lhand|rhand)_bn\.", r"body_rotation_net.\1_conv.1."),
             (r"body_rotation_net\.(\w+_out)\.", r"body_rotation_net.\1.0."),
             (r"hand_rotation_net\.hand_conv\.", "hand_rotation_net.hand_conv.0."),
             (r"hand_rotation_net\.hand_bn\.", "hand_rotation_net.hand_conv.1."),
             (r"hand_rotation_net\.hand_pose_out\.", "hand_rotation_net.hand_pose_out.0."),
             (r"box_net\.deconv_(\d)\.", lambda m: f"box_net.deconv.{3 * int(m[1])}."),
             (r"box_net\.deconv_bn_(\d)\.", lambda m: f"box_net.deconv.{3 * int(m[1]) + 1}."),
             (r"box_net\.bbox_center\.", "box_net.bbox_center.0."),
             (r"box_net\.(\w+_size)_fc0\.", r"box_net.\1.0."),
             (r"box_net\.(\w+_size)_fc1\.", r"box_net.\1.2."),
             (r"face_regressor\.(\w+_out)\.", r"face_regressor.\1.0.")]
    import re

    out = {}
    for name, value in port.state_dict().items():
        key = None
        for src, dst in towers.items():
            if name.startswith(src):
                rest = name[len(src):]
                rest = re.sub(r"^layer(\d)_(\d+)\.down_conv\.", r"layer\1.\2.downsample.0.", rest)
                rest = re.sub(r"^layer(\d)_(\d+)\.down_bn\.", r"layer\1.\2.downsample.1.", rest)
                key = dst + re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", rest)
        if key is None:
            key = name
            for pattern, repl in heads:
                new, n = re.subn("^" + pattern, repl, name)
                if n:
                    key = new
                    break
        out["module." + key] = value.clone()
        if key.endswith("running_var"):
            out["module." + key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    for conv, bn in (("body_rotation_net.body_conv.0", "body_rotation_net.body_conv.1"),
                     ("body_rotation_net.lhand_conv.0", "body_rotation_net.lhand_conv.1"),
                     ("body_rotation_net.rhand_conv.0", "body_rotation_net.rhand_conv.1"),
                     ("hand_rotation_net.hand_conv.0", "hand_rotation_net.hand_conv.1")):
        bias = torch.as_tensor(np.float32(rng.normal(size=512) * 0.1))
        out[f"module.{conv}.bias"] = bias
    return out


def test_published_checkpoint_layout(small, tmp_path, monkeypatch):
    """The port reads the torch layout directly; ``coma_tpu`` converts it
    (``convert_hand4whole``, its ResNet stage sizes cut to the test's
    towers) and both compute the same regression."""
    variables, jm, port = small
    rng = np.random.default_rng(11)
    sd = torch_layout(port, rng)
    torch.save({"network": sd, "epoch": 6}, tmp_path / "snapshot_6.pth.tar")
    loaded = TH.load_hand4whole_weights(TH.Hand4Whole(),
                                        str(tmp_path / "snapshot_6.pth.tar")).eval()
    convert = j_tw.convert_resnet
    monkeypatch.setattr(j_tw, "convert_resnet", lambda sd_, prefix, stages, bottleneck:
                        convert(sd_, prefix, SMALL, bottleneck))
    converted = j_tw.convert_hand4whole({k: v.numpy() for k, v in sd.items()})
    converted = jax.tree_util.tree_map(np.asarray, converted)
    img = np.float32(rng.uniform(size=(1, 512, 384, 3)))
    want = jax.jit(jm.apply)(converted, jnp.asarray(img))
    with torch.no_grad():
        got = loaded(nchw(img))
    assert_outputs_match(got, want)
    # the folded biases moved the rotation heads off the port model's own
    with torch.no_grad():
        before = port(nchw(img))
    assert not np.allclose(before["body_pose"].numpy(), got["body_pose"].numpy(), atol=1e-3)
