"""The port's segmenter training against ``coma_tpu``'s: the loss, AdamW in
optax's order on a warmup-cosine schedule, ``SegTrainer`` from the same Flax
parameters, the ``.npz`` store both ways, and ``cli/train_segmenter``.

Tolerances: ``bce_dice_loss`` within 1e-6; the schedule within 1e-9;
``OptaxAdam`` with weight decay against ``optax.adamw`` on fixed gradients
within 2e-7 (an ulp at these magnitudes). ``SegTrainer`` (32², batch 2, a
schedule above 0 from the first step): the losses within 1e-5 after 1 and 3
steps, and the parameters within 1e-4 on every element whose first gradient
has magnitude >= 1e-5 (measured: 1.2e-7 after 1 step, 6.1e-5 after 3). The
rest, 1.8% of the elements here, carry gradients that the two frameworks'
float32 convolutions give up to 8.9e-7 apart; Adam's first step divides each
gradient by its own magnitude, so there the updates may differ by up to
2·lr. They are held to that bound: within 2.2 × the summed learning rates.
``SegTrainer.make_step`` on 2 gloo ranks (``tests/torch_mesh_ranks.py``),
global batch 4, against ``coma_tpu``'s ``make_step(mesh)`` on a 2-device
mesh: the losses within 1e-5 at each of 3 steps, of ``coma_tpu`` and of
the port's one-process step on the whole batch (3.0e-6 apart after three
steps with 8 threads: the convolutions' float32 sums follow the thread
count); the parameters where the first gradient is >= 1e-5 within 1e-4
after the first step (measured: 1.4e-7) and within 1e-3 after the third
(measured: 1.855e-4), every parameter within 2.2 × the summed learning
rates after both. The third step's limit is wider than the one-process
case's 1e-4 because at this batch later gradients of some sure elements
come near 0, where Adam's division makes the step follow the frameworks'
float32 convolutions (the one-process port on the whole batch is 9.3e-4
from ``coma_tpu`` there with four threads; it is held on its losses only).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from coma_tpu.models.segmentation import PersonSegmenter as JSeg
from coma_tpu.models.segmentation_train import SegTrainer as JTrainer
from coma_tpu.models.segmentation_train import bce_dice_loss as j_loss
from coma_tpu.models.segmentation_train import synthetic_person_batch as j_synth
from coma_tpu.models.synthetic_person import person_batch
from coma_tpu.utils import checkpoint as j_ckpt
from coma_tpu_torch.cli import train_segmenter as t_cli
from coma_tpu_torch.models.flax_params import flax_tree, load_flax_params
from coma_tpu_torch.models.segmentation import PersonSegmenter as TSeg
from coma_tpu_torch.models.segmentation_train import SegTrainer as TTrainer
from coma_tpu_torch.models.segmentation_train import bce_dice_loss as t_loss
from coma_tpu_torch.models.segmentation_train import synthetic_person_batch as t_synth
from coma_tpu_torch.optim import OptaxAdam, warmup_cosine_decay_schedule
from coma_tpu_torch.parallel.distributed import DistContext
from coma_tpu_torch.utils import checkpoint as t_ckpt
from tests.torch_mesh_ranks import REPO, spawn_command

SCHEDULE = (1e-3, 3e-3, 2, 10, 1e-4)     # init, peak, warmup, decay, end: lr > 0 from step 1


@pytest.mark.parametrize("dice_weight", [1.0, 0.3])
def test_bce_dice_loss_matches(dice_weight):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 16, 16)) * 4).astype(np.float32)
    masks = (rng.uniform(size=(3, 16, 16)) > 0.6).astype(np.float32)
    want = float(j_loss(jnp.asarray(logits), jnp.asarray(masks), dice_weight))
    got = float(t_loss(torch.as_tensor(logits), torch.as_tensor(masks), dice_weight))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [SCHEDULE, (0.0, 3e-4, 4, 40, 6e-6), (0.0, 3e-4, 0, 40, 6e-6)])
def test_schedule_matches_optax(args):
    want = jax.jit(optax.warmup_cosine_decay_schedule(*args))
    got = warmup_cosine_decay_schedule(*args)
    for count in range(args[3] + 5):
        np.testing.assert_allclose(got(count), float(want(jnp.int32(count))), rtol=0, atol=1e-9)


def test_adamw_matches_optax():
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(*SCHEDULE), weight_decay=1e-4)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    opt = OptaxAdam(t_params, warmup_cosine_decay_schedule(*SCHEDULE), weight_decay=1e-4)
    for _ in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step(t_params, {k: torch.as_tensor(v) for k, v in grads.items()})
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                       rtol=0, atol=2e-7)


def test_adam_without_decay_is_unchanged():
    """A float ``lr`` and no weight decay: the update is ``-lr`` times Adam's
    direction, as the fitting loops have used it."""
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    opt = OptaxAdam(p, 0.1)
    opt.step(p, {"w": torch.tensor([0.5, -0.25, 0.0])})
    np.testing.assert_allclose(p["w"].numpy(), [0.9, -1.9, 3.0], atol=1e-6)


def test_seg_trainer_matches_after_1_and_3_steps():
    j_trainer = JTrainer(JSeg(), optax.adamw(optax.warmup_cosine_decay_schedule(*SCHEDULE),
                                             weight_decay=1e-4))
    state = j_trainer.init(jax.random.PRNGKey(0), (32, 32))
    model = load_flax_params(TSeg(), jax.tree.map(np.asarray, state["params"]))
    trainer = TTrainer(model, warmup_cosine_decay_schedule(*SCHEDULE), weight_decay=1e-4)
    step = j_trainer.make_step()
    rng = np.random.default_rng(2)
    batches = [person_batch(rng, 2, 32) for _ in range(3)]
    first_grad = jax.grad(j_trainer.loss_fn)(state["params"], *map(jnp.asarray, batches[0]))
    sure = [np.abs(np.asarray(g)) >= 1e-5 for g in jax.tree.leaves(first_grad)]
    assert np.mean(np.concatenate([s.ravel() for s in sure])) > 0.97
    lr_sum = 0.0
    for i, (imgs, masks) in enumerate(batches):
        state, j_l = step(state, jnp.asarray(imgs), jnp.asarray(masks))
        t_l = trainer.step(torch.as_tensor(imgs), torch.as_tensor(masks))
        lr_sum += warmup_cosine_decay_schedule(*SCHEDULE)(i)
        np.testing.assert_allclose(float(t_l), float(j_l), rtol=0, atol=1e-5)
        if i in (0, 2):
            got = jax.tree.leaves(flax_tree(model))
            want = jax.tree.leaves(jax.tree.map(np.asarray, state["params"]))
            for g, w, s in zip(got, want, sure):
                np.testing.assert_allclose(g[s], w[s], rtol=0, atol=1e-4)
                assert np.abs(g - w).max() <= 2.2 * lr_sum
    imgs, masks = batches[0]
    np.testing.assert_allclose(
        float(trainer.iou(torch.as_tensor(imgs), torch.as_tensor(masks))),
        float(j_trainer.iou(state["params"], jnp.asarray(imgs), jnp.asarray(masks))), atol=1e-3)


def test_make_step_over_two_ranks_matches_coma_tpus_mesh(tmp_path):
    j_trainer = JTrainer(JSeg(), optax.adamw(optax.warmup_cosine_decay_schedule(*SCHEDULE),
                                             weight_decay=1e-4))
    state = j_trainer.init(jax.random.PRNGKey(0), (32, 32))
    model = load_flax_params(TSeg(), jax.tree.map(np.asarray, state["params"]))
    rng = np.random.default_rng(5)
    batches = [person_batch(rng, 4, 32) for _ in range(3)]
    np.savez(tmp_path / "in.npz", images=np.stack([b[0] for b in batches]),
             masks=np.stack([b[1] for b in batches]),
             **{f"p.{k}": v.numpy() for k, v in model.state_dict().items()})
    ranks = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
    reports = spawn_command(2, [ranks, "seg_step", tmp_path / "in.npz", tmp_path / "out.npz"],
                            "torchrun")
    assert reports[0][0]["rank"]["losses"] == reports[1][0]["rank"]["losses"]
    first_grad = jax.grad(j_trainer.loss_fn)(state["params"], *map(jnp.asarray, batches[0]))
    sure = [np.abs(np.asarray(g)) >= 1e-5 for g in jax.tree.leaves(first_grad)]
    step = j_trainer.make_step(Mesh(np.array(jax.devices()[:2]), ("data",)))
    one = TTrainer(load_flax_params(TSeg(), jax.tree.map(np.asarray, state["params"])),
                   warmup_cosine_decay_schedule(*SCHEDULE), weight_decay=1e-4)
    lr_sum = 0.0
    with np.load(tmp_path / "out.npz") as got:
        for i, (imgs, masks) in enumerate(batches):
            state, j_l = step(state, jnp.asarray(imgs), jnp.asarray(masks))
            o_l = one.step(torch.as_tensor(imgs), torch.as_tensor(masks))
            lr_sum += warmup_cosine_decay_schedule(*SCHEDULE)(i)
            np.testing.assert_allclose(got["losses"][i], float(j_l), rtol=0, atol=1e-5)
            np.testing.assert_allclose(got["losses"][i], float(o_l), rtol=0, atol=1e-5)
            if i in (0, 2):
                model.load_state_dict({k: torch.from_numpy(got[f"step{i}.{k}"])
                                       for k in model.state_dict()})
                want = jax.tree.leaves(jax.tree.map(np.asarray, state["params"]))
                for g, w, s in zip(jax.tree.leaves(flax_tree(model)), want, sure):
                    np.testing.assert_allclose(g[s], w[s], rtol=0, atol=1e-4 if i == 0 else 1e-3)
                    assert np.abs(g - w).max() <= 2.2 * lr_sum


def test_make_step_refuses_a_batch_the_ranks_do_not_divide():
    trainer = TTrainer(TSeg(), 1e-3)
    assert trainer.make_step(None) == trainer.step
    step = trainer.make_step(DistContext(0, 2, 0, "gloo", torch.device("cpu")))
    imgs, masks = person_batch(np.random.default_rng(6), 3, 32)
    with pytest.raises(ValueError, match="a batch of 3 does not divide over 2 ranks"):
        step(torch.as_tensor(imgs), torch.as_tensor(masks))


def test_synthetic_person_batch_equal():
    for a, b in zip(t_synth(np.random.default_rng(3), 4, 32), j_synth(np.random.default_rng(3), 4, 32)):
        np.testing.assert_array_equal(a, b)


def test_flax_tree_round_trips():
    from coma_tpu_torch.models.layers import init_flax_default_

    model = init_flax_default_(TSeg(), torch.Generator().manual_seed(0))
    tree = flax_tree(model)
    again = load_flax_params(TSeg(), tree)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    assert tree["params"]["down_0"]["conv0"]["kernel"].shape == (3, 3, 3, 32)
    assert "scale" in tree["params"]["down_0"]["norm0"]


@pytest.mark.parametrize("bf16", [True, False])
def test_npz_store_both_ways(tmp_path, bf16):
    """The port's ``save_params`` file loads in ``coma_tpu``'s ``load_params``
    to equal arrays, and ``coma_tpu``'s in the port's; bf16 leaves by
    round-to-nearest-even as ``jnp.asarray(x, jnp.bfloat16)``."""
    rng = np.random.default_rng(4)
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
                       "b": rng.normal(size=(5,)).astype(np.float32)}}
    cast = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) if bf16 else (lambda x: x)
    t_ckpt.save_params(jax.tree.map(cast, tree), str(tmp_path / "t.npz"))
    j_tree = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32), tree)
    j_ckpt.save_params(j_tree, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    by_jax = j_ckpt.load_params(str(tmp_path / "t.npz"))
    by_port = t_ckpt.load_params(str(tmp_path / "j.npz"))
    for (_, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(by_jax),
                              jax.tree_util.tree_leaves_with_path(by_port)):
        np.testing.assert_array_equal(np.asarray(x, np.float32), y)


def test_train_segmenter_cli_on_the_cpu(tmp_path, monkeypatch):
    """The CLI at tiny widths: losses finite, the npz written where asked
    (never into ``coma_tpu/``), loadable by both packages' segmenters."""
    monkeypatch.chdir(tmp_path)
    assert t_cli.build_parser().parse_args([]).out == "output/person_segmenter.npz"
    summary = t_cli.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--size", "32",
                          "--bg_pool_size", "2", "--eval_batches", "1", "--log_every", "1"])
    assert len(summary["losses"]) == 3 and np.isfinite(summary["losses"]).all()
    assert summary["step_ms"] is None and len(summary["queue_wait_s"]) == 3
    assert 0.0 <= summary["iou"] <= 1.0 and 0.0 <= summary["cross_domain_iou"] <= 1.0
    path = tmp_path / "output" / "person_segmenter.npz"
    with np.load(path) as data:
        assert all(k.endswith("::bf16") for k in data.files) and len(data.files) == 74
    model = load_flax_params(TSeg(), t_ckpt.load_params(str(path)))
    imgs = torch.as_tensor(person_batch(np.random.default_rng(5), 2, 32)[0])
    with torch.no_grad():
        logits = model(imgs.permute(0, 3, 1, 2))
    want = JSeg().apply(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                                     j_ckpt.load_params(str(path))), jnp.asarray(imgs.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_train_segmenter_rejects_unknown_domains():
    with pytest.raises(SystemExit, match="--domains"):
        t_cli.main(["--device", "cpu", "--domains", "procedural,renderd"])


def test_train_segmenter_without_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--steps", "1"])
