"""The cross-entropy objectives and metrics in the port against the JAX
package, on the CPU.

Data: 2,000 rows, 6 features, labels probabilities in [0, 1] (a sigmoid of
a linear signal plus noise, some exactly 0 and 1); weights in [0.5, 2].

Contracts:

* cross_entropy and cross_entropy_lambda gradients and hessians on the
  same float32 scores, weighted and not: rtol 2e-6 / atol 1e-6 (float32
  `exp` and `log1p` on each side; the binary objective's tolerance in
  tests/test_torch_objectives.py), except weighted cross_entropy_lambda:
  its float32 formula (xentropy_objective.hpp:240-262) cancels in
  1 - exp(-w log1p(e^s)) and in 1 - y / z, so the two frameworks' last-bit
  `exp` differences grow to 1e-4 relative in the gradient and 5% in the
  hessian on this data; there each value is held to the same formula in
  float64: the port's error at most 8 times the JAX package's (which bits
  cancel away is set by each side's last-bit `exp`: 4% and 1% on the
  worst hessian here), plus rtol 2e-6 / atol 1e-6; `boost_from_score` exact (the float64
  label mean on the host); `convert_output` within rtol 1e-6; a negative
  label is fatal in both;
* the cross_entropy, cross_entropy_lambda and kullback_leibler metrics,
  with and without weights and an objective: within 1e-6;
* training (3 rounds, 15 leaves, weighted, with a validation set) split for
  split with the JAX package through the serial learner, for both
  objectives: features, thresholds, decision types and counts equal,
  values within rtol 1e-5 / atol 1e-6, gains rtol 1e-4; predictions within
  rtol 1e-5, the recorded metrics within 1e-5.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.metrics import create_metric
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split

CPU = torch.device("cpu")
N, F = 2000, 6
GRAD_RTOL, GRAD_ATOL = 2e-6, 1e-6
METRIC_ATOL = 1e-6
OBJECTIVES = ["cross_entropy", "cross_entropy_lambda"]


def xent_data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(N, F))
    y = 1.0 / (1.0 + np.exp(-(1.5 * X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=N))))
    y[rng.rand(N) < 0.05] = 0.0
    y[rng.rand(N) < 0.05] = 1.0
    return X, y


def _metadata(y, weight):
    from lightgbm_tpu.io.metadata import Metadata as JaxMetadata

    md, jmd = Metadata(len(y)), JaxMetadata(len(y))
    for m in (md, jmd):
        m.set_label(y)
        if weight is not None:
            m.set_weights(weight)
    return md, jmd


def _objectives(name, md, jmd):
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective

    obj = create_objective(name, Config({"objective": name}))
    ref = jax_objective(name, JaxConfig({"objective": name}))
    obj.init(md, md.num_data, CPU)
    ref.init(jmd, jmd.num_data)
    return obj, ref


def _xentlambda_float64(score, y, w):
    """Weighted cross_entropy_lambda's gradient and hessian, the objective's
    formula in float64 (K_EPS floors included)."""
    eps = 1e-15
    s = score.astype(np.float64)
    epf = np.exp(s)
    z = 1.0 - np.exp(-w * np.log1p(epf))
    grad = (1.0 - y / np.maximum(z, eps)) * w / (1.0 + 1.0 / epf)
    c = 1.0 / np.maximum(1.0 - z, eps)
    d = c - 1.0
    b = (c / np.maximum(d * d, eps)) * (1.0 + w * epf - c)
    return grad, w * epf / ((1.0 + epf) ** 2) * (1.0 + y * b)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_gradients_boost_and_output_match_jax(jax_ref, name, weighted):
    import jax
    import jax.numpy as jnp

    X, y = xent_data()
    rng = np.random.RandomState(1)
    weight = rng.uniform(0.5, 2.0, size=N) if weighted else None
    obj, ref = _objectives(name, *_metadata(y, weight))
    score = (rng.normal(size=N) * 3).astype(np.float32)
    grad, hess = obj.get_gradients(torch.from_numpy(score))
    rgrad, rhess = jax.jit(ref.get_gradients)(jnp.asarray(score))
    assert grad.dtype == hess.dtype == torch.float32
    if name == "cross_entropy_lambda" and weighted:
        for got, want, exact in zip((grad, hess), (rgrad, rhess),
                                    _xentlambda_float64(score, y, weight)):
            err, ref_err = np.abs(got.numpy() - exact), np.abs(np.asarray(want) - exact)
            assert (err <= 8 * ref_err + GRAD_RTOL * np.abs(exact) + GRAD_ATOL).all()
    else:
        np.testing.assert_allclose(grad.numpy(), np.asarray(rgrad), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(hess.numpy(), np.asarray(rhess), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert obj.boost_from_score(0) == ref.boost_from_score(0)
    np.testing.assert_allclose(obj.convert_output(torch.from_numpy(score)).numpy(),
                               np.asarray(ref.convert_output(jnp.asarray(score))), rtol=1e-6)
    assert obj.to_string() == ref.to_string() == name


@pytest.mark.parametrize("name", OBJECTIVES)
def test_negative_label_is_fatal(jax_ref, name):
    from lightgbm_tpu.utils.log import LightGBMError as JaxError

    y = xent_data()[1]
    y[3] = -0.5
    md, jmd = _metadata(y, None)
    with pytest.raises(LightGBMError, match="non-negative"):
        create_objective(name, Config({"objective": name})).init(md, N, CPU)
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.objectives import create_objective as jax_objective

    with pytest.raises(JaxError, match="non-negative"):
        jax_objective(name, JaxConfig({"objective": name})).init(jmd, N)


@pytest.mark.parametrize("with_objective", [False, True], ids=["raw", "objective"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("metric", ["cross_entropy", "cross_entropy_lambda",
                                    "kullback_leibler"])
def test_metrics_match_jax(jax_ref, metric, weighted, with_objective):
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu.metrics import create_metric as jax_metric

    _, y = xent_data(seed=2)
    rng = np.random.RandomState(2)
    weight = rng.uniform(0.5, 2.0, size=N) if weighted else None
    md, jmd = _metadata(y, weight)
    m, ref = create_metric(metric, Config({})), jax_metric(metric, JaxConfig({}))
    m.init(md, N, CPU)
    ref.init(jmd, N)
    obj = robj = None
    if with_objective:
        obj, robj = _objectives("cross_entropy", md, jmd)
    score = (rng.normal(size=N) * 2).astype(np.float32)
    got = m.eval(torch.from_numpy(score), obj)
    want = ref.eval(jnp.asarray(score), robj)
    assert m.name == ref.name and m.greater_is_better == ref.greater_is_better
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_training_split_for_split(jax_ref, name):
    X, y = xent_data(seed=3)
    params = {"objective": name, "num_leaves": 15, "min_data_in_leaf": 10, "verbosity": -1,
              "device_type": "cpu", "metric": [name, "kullback_leibler"]}
    weight = np.random.RandomState(3).uniform(0.5, 2.0, size=N)
    records = []
    boosters = []
    for pkg in (lt, jax_ref):
        evals = {}
        train = pkg.Dataset(X, label=y, weight=weight)
        boosters.append(pkg.train(dict(params), train, num_boost_round=3,
                                  valid_sets=[train.create_valid(X, label=y, weight=weight)],
                                  callbacks=[pkg.record_evaluation(evals)]))
        records.append(evals)
    port, ref = boosters
    _assert_split_for_split(port.model_to_string(), ref.model_to_string(),
                            value_rtol=1e-5, gain_rtol=1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-6)
    for key, values in records[0]["valid_0"].items():
        np.testing.assert_allclose(values, records[1]["valid_0"][key], rtol=0, atol=1e-5)
