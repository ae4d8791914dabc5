"""The port's person segmenter on the committed checkpoint, against ``coma_tpu``.

``coma_tpu/data/person_segmenter.npz`` is read by the port's numpy-only
``load_params`` and by ``coma_tpu``'s; the port's ``PersonSegmenter`` gets
it through ``models/flax_params.py``. Person probabilities agree within atol
1e-5 at the training scale (128²), and where the canonical-scale path
resizes up (64²) and down (256², antialiased) around it. The thresholded
masks are compared only where the probabilities stand clear of 0.5, and the
test asserts how many pixels do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.cli.segment_human import default_segmenter_checkpoint
from coma_tpu.models import segmentation as j_seg
from coma_tpu.models.synthetic_person import person_batch
from coma_tpu.utils.checkpoint import load_params as j_load_params
from coma_tpu_torch.cli.inpaint import SEGMENTER_CHECKPOINT, load_person_segmenter
from coma_tpu_torch.models import segmentation as t_seg
from coma_tpu_torch.models.flax_params import load_flax_params
from coma_tpu_torch.utils.checkpoint import load_params as t_load_params

MARGIN = 1e-4


@pytest.fixture(scope="module")
def checkpoint():
    j_params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                            j_load_params(default_segmenter_checkpoint()))
    t_params = t_load_params(str(SEGMENTER_CHECKPOINT))
    return j_params, t_params


def person_images(res, seed):
    """Two synthetic people on textured backgrounds, the segmenter's domain."""
    return person_batch(np.random.default_rng(seed), 2, size=res)[0]


def test_checkpoint_path_and_loaders_agree(checkpoint):
    j_params, t_params = checkpoint
    assert SEGMENTER_CHECKPOINT.samefile(default_segmenter_checkpoint())
    j_leaves = jax.tree_util.tree_leaves_with_path(j_params)
    t_leaves = jax.tree_util.tree_leaves_with_path(t_params)
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves]
    for (_, a), (_, b) in zip(j_leaves, t_leaves):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("res", [128, 64, 256])
def test_person_probs_match_on_the_committed_checkpoint(checkpoint, res):
    j_params, t_params = checkpoint
    images = person_images(res, seed=res)
    model = j_seg.PersonSegmenter()
    want = np.asarray(jax.jit(lambda p, x: j_seg.person_probs_canonical(model, p, x))(
        j_params, images))
    port = load_flax_params(t_seg.PersonSegmenter(), t_params).eval()
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = t_seg.person_probs_canonical(port, x).numpy()
        mask = t_seg.make_person_segment_fn(port)(x).numpy()
    assert got.shape == (2, res, res)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    want_mask = np.asarray(j_seg.make_person_segment_fn(model)(j_params, images))
    clear = np.abs(want - 0.5) > MARGIN
    assert clear.mean() > 0.99, f"only {clear.mean():.4f} of pixels clear of the threshold"
    assert 0 < want_mask[clear].mean() < 1, "the masks hold one value only"
    np.testing.assert_array_equal(mask[clear], want_mask[clear])


def test_logits_and_probs_to_mask_match(checkpoint):
    j_params, t_params = checkpoint
    images = person_images(128, seed=7)
    want = np.asarray(jax.jit(j_seg.PersonSegmenter().apply)(j_params, images))
    port = load_flax_params(t_seg.PersonSegmenter(), t_params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    # logits, not squashed by the sigmoid, are held at atol 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    logits = np.float32([[-1.0, -1e-3, 0.0, 2.0]])
    np.testing.assert_array_equal(t_seg.probs_to_mask(torch.from_numpy(logits)).numpy(),
                                  np.asarray(j_seg.probs_to_mask(jnp.asarray(logits))))


def test_cli_loader_takes_the_checkpoint_unless_random(checkpoint):
    _, t_params = checkpoint
    g = torch.Generator().manual_seed(0)
    loaded = load_person_segmenter(False, "cpu", g)
    want = load_flax_params(t_seg.PersonSegmenter(), t_params)
    for (name, a), b in zip(loaded.state_dict().items(), want.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    random = load_person_segmenter(True, "cpu", g)
    assert not torch.equal(random.head.weight, loaded.head.weight)
    assert torch.equal(random.down_0.norm0.weight, torch.ones(32))
