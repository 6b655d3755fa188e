"""The port's training objectives and metrics against the JAX package's.

Gradients and hessians are compared on the same float32 scores. Where the
computation goes through `exp` or `log` the two frameworks' float32
implementations may round differently, so those are held to rtol 2e-6
(a few ULP) and atol 1e-6 (Poisson and Tweedie subtract the label from an
exponential of the score, which cancels: a one-ULP difference in the
exponential of a term near 10 is ~1e-6 absolute); pure arithmetic (L2, L1, Huber, quantile) must be exact.
`boost_from_score` is host float64 arithmetic on the same labels: exact.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metric
from lightgbm_tpu_torch.objectives import create_objective
from tests.test_torch_ref import jax_ref  # noqa: F401

N = 3000
TRANSCENDENTAL = {"binary", "poisson", "gamma", "tweedie"}

OBJECTIVES = [
    ("binary", {}),
    ("binary", {"is_unbalance": True}),
    ("binary", {"scale_pos_weight": 3.0, "sigmoid": 1.5}),
    ("regression", {}),
    ("regression", {"reg_sqrt": True}),
    ("regression_l1", {}),
    ("huber", {"alpha": 0.7}),
    ("fair", {"fair_c": 2.0}),
    ("poisson", {}),
    ("quantile", {"alpha": 0.3}),
    ("mape", {}),
    ("gamma", {}),
    ("tweedie", {}),
]


def _data(objective, weighted):
    rng = np.random.RandomState(len(objective) + weighted)
    if objective == "binary":
        label = (rng.rand(N) < 0.3).astype(np.float64)
    elif objective in ("poisson", "gamma", "tweedie"):
        label = rng.exponential(size=N) * 3 + (objective == "gamma")
    else:
        label = rng.normal(size=N) * 5
    score = (rng.normal(size=N) * 2).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=N) if weighted else None
    return label, score, weight


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", OBJECTIVES,
                         ids=[f"{o}-{'-'.join(p)}" for o, p in OBJECTIVES])
def test_gradients_match_jax(jax_ref, case, weighted):
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
    from lightgbm_tpu.objectives import create_objective as jax_objective

    name, params = case
    label, score, weight = _data(name, weighted)
    md, jmd = Metadata(N), JaxMetadata(N)
    for m in (md, jmd):
        m.set_label(label)
        if weight is not None:
            m.set_weights(weight)
    obj = create_objective(name, Config({"objective": name, **params}))
    ref = jax_objective(name, JaxConfig({"objective": name, **params}))
    obj.init(md, N, torch.device("cpu"))
    ref.init(jmd, N)
    grad, hess = obj.get_gradients(torch.from_numpy(score))
    rgrad, rhess = jax.jit(ref.get_gradients)(jnp.asarray(score))
    assert grad.dtype == hess.dtype == torch.float32
    if name in TRANSCENDENTAL:
        np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(hess.numpy(), np.asarray(rhess), rtol=2e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(grad.numpy(), np.asarray(rgrad))
        np.testing.assert_array_equal(hess.numpy(), np.asarray(rhess))
    assert obj.boost_from_score(0) == ref.boost_from_score(0)
    assert obj.to_string() == ref.to_string()
    raw = torch.from_numpy(score[:, None])
    np.testing.assert_allclose(obj.convert_output(raw).numpy(),
                               np.asarray(ref.convert_output(jnp.asarray(score[:, None]))),
                               rtol=2e-6)


METRICS = [("binary", "binary_logloss"), ("binary", "auc"), ("binary", "binary_error"),
           ("binary", "average_precision"), ("regression", "l2"), ("regression", "rmse"),
           ("regression", "l1"), ("regression", "huber"), ("poisson", "poisson")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", METRICS, ids=[m for _, m in METRICS])
def test_metrics_match_jax(jax_ref, case, weighted):
    """Metric values are float reductions in different orders on each
    side: held to rtol 1e-5."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
    from lightgbm_tpu.metrics import create_metric as jax_metric
    from lightgbm_tpu.objectives import create_objective as jax_objective

    objective, name = case
    label, score, weight = _data(objective, weighted)
    score = np.round(score, 1)  # ties in the ranking metrics
    md, jmd = Metadata(N), JaxMetadata(N)
    for m in (md, jmd):
        m.set_label(label)
        if weight is not None:
            m.set_weights(weight)
    cfg = {"objective": objective, "metric": name}
    metric, ref = create_metric(name, Config(cfg)), jax_metric(name, JaxConfig(cfg))
    metric.init(md, N, torch.device("cpu"))
    ref.init(jmd, N)
    obj = create_objective(objective, Config(cfg))
    robj = jax_objective(objective, JaxConfig(cfg))
    got = metric.eval(torch.from_numpy(score), obj)
    want = ref.eval(jnp.asarray(score), robj)
    assert metric.name == ref.name and metric.greater_is_better == ref.greater_is_better
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg", "xentropy"])
def test_untrainable_objective_is_refused(name):
    """Data these objectives cannot train on is refused: ranking without
    query groups, cross entropy with a negative label (each trains since
    its slice: tests/test_torch_rank.py, tests/test_torch_xentropy.py)."""
    from lightgbm_tpu_torch import Dataset, train
    from lightgbm_tpu_torch.utils.log import LightGBMError

    X = np.random.RandomState(0).normal(size=(200, 3))
    label = np.zeros(200)
    label[0] = -1.0
    what = "non-negative" if name == "xentropy" else "query information"
    with pytest.raises(LightGBMError, match=what):
        train({"objective": name, "device_type": "cpu", "verbosity": -1},
              Dataset(X, label=label), num_boost_round=1)
