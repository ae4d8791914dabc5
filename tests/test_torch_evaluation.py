"""Port parity of the quantitative metrics (normalized MAE, SIM,
``quant_metrics``) against ``coma_tpu.affordance.evaluation`` at 1e-6, on
single and batched distributions, including an all-zero one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coma_tpu.affordance import evaluation as J
from coma_tpu_torch import affordance as T_affordance
from coma_tpu_torch.affordance import evaluation as T


def cases():
    rng = np.random.default_rng(0)
    single = [rng.uniform(size=40), rng.uniform(size=40) ** 3]
    batched = [rng.uniform(size=(5, 40)), rng.uniform(size=(5, 40))]
    batched[1][2] = 0.0   # an empty distribution: eps keeps it finite
    return {"single": single, "batched": batched}


@pytest.mark.parametrize("case", ["single", "batched"])
@pytest.mark.parametrize("fn", ["mean_absolute_error", "similarity"])
def test_metric_matches(case, fn):
    a, b = cases()[case]
    got = getattr(T, fn)(torch.as_tensor(np.float32(a)), torch.as_tensor(np.float32(b)))
    want = getattr(J, fn)(jnp.float32(a), jnp.float32(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["single", "batched"])
def test_quant_metrics_match(case):
    a, b = cases()[case]
    got = T.quant_metrics(torch.as_tensor(np.float32(a)), torch.as_tensor(np.float32(b)))
    want = J.quant_metrics(jnp.float32(a), jnp.float32(b))
    assert got.keys() == want.keys() == {"mae", "sim"}
    for k in got:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_exported_from_affordance():
    assert T_affordance.quant_metrics is T.quant_metrics
    assert T_affordance.similarity is T.similarity
    assert T_affordance.mean_absolute_error is T.mean_absolute_error
