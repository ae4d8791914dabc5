"""COAP's published checkpoint in the port (``models/coap.py``
``load_coap_checkpoint``; ROADMAP item 16) against ``coma_tpu``'s converter
(``models/torch_weights.py:convert_coap``), on the CPU.

- A seeded stand-in in the published layout at ``COAPConfig()``'s widths
  (the three sub-trees, torch's (O, I) weights, a body model's buffer and a
  loss weight beside them): a Lightning-style ``.ckpt`` with its state dict
  under ``state_dict`` and the keys behind ``model.`` or ``coap.``, and bare
  state dicts with and without ``module.``. Loaded by the port and by
  ``coma_tpu``'s ``_torch_load`` + ``convert_coap``: occupancies within
  1e-5 (float32), the parts read from the file.
- ``cli/optimize_depth.load_coap`` takes the ``.ckpt`` and the Flax ``.npz``
  that ``coma_tpu``'s converter writes from it: the same parameters, and
  the same first step of the depth optimizer with the neural collision term.
- A file that ``torch.load(weights_only=True)`` refuses raises, naming it.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.cli.convert_weights import _torch_load as j_torch_load
from coma_tpu.models import coap as J
from coma_tpu.models.torch_weights import convert_coap
from coma_tpu.utils.checkpoint import save_params as j_save_params
from coma_tpu_torch.cli import optimize_depth as t_opt
from coma_tpu_torch.lifting import depth_optimize as TO
from coma_tpu_torch.models import coap as T
from coma_tpu_torch.models.coap_partition import build_partition
from coma_tpu_torch.models.layers import init_flax_default_
from coma_tpu_torch.models.smplx import SMPLXModel, smplx_forward
from tests.test_torch_lifting import optimizer_inputs
from tests.test_torch_smplx import write_official_npz

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def published_state(K, seed=0):
    """A seeded COAPOccupancy at the published widths, biases moved off 0,
    as the checkpoint's state dict (torch tensors)."""
    model = init_flax_default_(T.COAPOccupancy(T.COAPConfig(num_parts=K)),
                               torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            for k, v in model.state_dict().items()}


def write_checkpoint(path, K, layout, seed=0):
    """The stand-in in one of the layouts a published file may take;
    returns the prefix ``coma_tpu``'s ``convert_coap`` needs."""
    nest, prefix = layout
    sd = {prefix + k: v for k, v in published_state(K, seed).items()}
    sd[prefix + "smpl_body.v_template"] = torch.zeros(10, 3)     # not COAP's
    sd["loss_weight"] = torch.tensor(0.4)
    if nest:
        sd = {"epoch": 7, "global_step": 7000, "state_dict": sd,
              "hyper_parameters": {"lr": 1e-4, "num_parts": K}}
    torch.save(sd, path)
    return "" if prefix == "module." else prefix


def occupancy_inputs(K, seed):
    rng = np.random.default_rng(seed)
    return (np.float32(rng.normal(size=(K, 9, 3)) * 0.1),
            np.float32(rng.normal(size=(K, 13, 3)) * 0.1),
            np.float32(rng.uniform(size=(K, 13)) > 0.3))


@pytest.mark.parametrize("K,layout", [(20, (True, "model.")), (7, (True, "coap.")),
                                      (20, (False, "")), (5, (False, "module."))],
                         ids=["lightning-model", "lightning-coap", "bare", "module"])
def test_published_checkpoint_matches_coma_tpus_converter(tmp_path, K, layout):
    path = str(tmp_path / "coap.ckpt")
    prefix = write_checkpoint(path, K, layout)
    got_model = T.load_coap_checkpoint(path)
    assert got_model.config.num_parts == K
    params = convert_coap(j_torch_load(path), prefix=prefix)
    parts, q, inside = occupancy_inputs(K, K)
    want = np.asarray(J.COAPOccupancy(J.COAPConfig(num_parts=K)).apply(
        params, jnp.asarray(parts), jnp.asarray(q), jnp.asarray(inside)))
    with torch.no_grad():
        got = got_model(*(torch.from_numpy(a) for a in (parts, q, inside))).numpy()
    assert want.max() > 0 and (want < 1).any()
    np.testing.assert_allclose(got, want, **TOL)


def test_checkpoint_with_two_models_or_a_missing_key_raises(tmp_path):
    sd = published_state(3)
    torch.save({**{"a." + k: v for k, v in sd.items()}, **{"b." + k: v for k, v in sd.items()}},
               tmp_path / "two.pt")
    with pytest.raises(KeyError, match="2 keys end in query_encoder.lin0.weight"):
        T.load_coap_checkpoint(str(tmp_path / "two.pt"))
    sd.pop("decoder.lin2.bias")
    torch.save(sd, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="decoder.lin2.bias"):
        T.load_coap_checkpoint(str(tmp_path / "short.pt"))


def test_a_file_weights_only_refuses_raises(tmp_path):
    sd = {"state_dict": published_state(3), "hyper_parameters": argparse.Namespace(lr=1e-4)}
    torch.save(sd, tmp_path / "pickled.ckpt")
    with pytest.raises(ValueError, match="pickled.ckpt: torch.load\\(weights_only=True\\)"):
        T.load_coap_checkpoint(str(tmp_path / "pickled.ckpt"))


def test_optimize_depth_takes_the_ckpt_and_the_npz(tmp_path):
    npz = str(tmp_path / "smplx.npz")
    write_official_npz(npz, V=64, seed=1)
    body = SMPLXModel.from_npz(npz, device="cpu")
    K = build_partition(body.lbs_weights.numpy(), body.parents).num_parts
    ckpt = str(tmp_path / "coap.ckpt")
    write_checkpoint(ckpt, K, (True, "model."), seed=3)
    j_save_params(convert_coap(j_torch_load(ckpt), prefix="model."), str(tmp_path / "coap.npz"))
    args = lambda path: argparse.Namespace(coap_ckpt=path, smplx_model_path=npz)
    loaded = [t_opt.load_coap(args(p), torch.device("cpu"))
              for p in (ckpt, str(tmp_path / "coap.npz"))]
    (a, _, _), (b, _, _) = loaded
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        out = smplx_forward(body, betas=torch.from_numpy(np.float32(rng.normal(size=(3, 10)))),
                            return_rel_transforms=True)
    verts = out[0].numpy() * 0.3
    inputs = optimizer_inputs(rng, verts_world=np.float32(verts),
                              joints_world=np.float32(verts[:, :25]))
    arrays = {k: torch.from_numpy(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    rest = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    aux = dict(rest_joints=out[3] * 0.3, rel_transforms=out[2],
               translation=torch.zeros(3, 3), base_centroid=torch.from_numpy(verts.mean(1)),
               scene_points=torch.from_numpy(np.float32(verts[:, ::4] + 0.01)),
               scene_valid=torch.ones(3, verts[:, ::4].shape[1]))
    steps = []
    for occ, part, _ in loaded:
        fn = torch.func.vmap(T.make_coap_collision_aux_fn(occ, part))
        steps.append(TO.optimize_depth_batch(**arrays, **rest, collision_fn=fn,
                                             collision_aux=aux, num_epochs=1, lr=0.01))
    assert float(steps[0].losses.max()) > 0
    for f in ("displacement", "losses"):
        torch.testing.assert_close(getattr(steps[0], f), getattr(steps[1], f), rtol=0, atol=0)
