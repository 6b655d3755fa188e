"""The numerical-health guardrails (`health_check_policy`) in the port
against the JAX package, on the CPU.

A custom objective gives grid-snapped binary logloss gradients and puts
NaN into 5% of the rows (every 20th) at iteration 5; the monitor checks
every 2 iterations (2,000 x 8 rows, 15 leaves, 7 rounds; the JAX split
search run op by op, as tests/test_torch_train.py runs it). Contracts:

* `fatal` raises at the same iteration as the JAX package (5; this run
  grows 4-leaf trees, which the check does not read);
* `rollback` goes back as many iterations as the JAX package (to the
  backup of the check at iteration 3) and re-boosts on the scrubbed,
  clipped gradients: the model text byte-equal to the JAX package's, the
  iteration and tree counts equal, every prediction finite;
* `warn` logs the failed check and does not raise;
* the monitor's device accumulator needs no synchronization between checks,
  and an unknown policy is refused.
"""
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.health import GRAD_CLIP, HealthMonitor, create_monitor
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _data, snapped_logloss

ROUNDS, NAN_AT, EVERY = 7, 5, 2
BASE = {"objective": "none", "num_leaves": 7, "device_type": "cpu", "verbosity": -1,
        "health_check_every": EVERY}


class NanAt:
    """snapped_logloss, with NaN in every 20th row's gradient at one
    iteration (its call count; both packages call it once an update)."""

    def __init__(self, at: int) -> None:
        self.at, self.calls = at, 0

    def __call__(self, preds, dataset):
        grad, hess = snapped_logloss(preds, dataset)
        if self.calls == self.at:
            grad = grad.copy()
            grad[::20] = np.nan
        self.calls += 1
        return grad, hess


def _run(pkg, policy, X, y, **extra):
    bst = pkg.Booster({**BASE, "health_check_policy": policy, **extra},
                      pkg.Dataset(X, label=y))
    fobj = NanAt(NAN_AT)
    for _ in range(ROUNDS):
        if bst.update(fobj=fobj):
            break
    return bst


@pytest.fixture(scope="module")
def data():
    return _data(seed=16)


def test_fatal_and_rollback_match_jax(jax_ref, monkeypatch, capsys, data):
    X, y = data
    with pytest.raises(LightGBMError) as port_err:
        _run(lt, "fatal", X, y, num_leaves=4)
    port = _run(lt, "rollback", X, y)
    port_log = capsys.readouterr().out
    _op_by_op(monkeypatch)
    with pytest.raises(Exception) as ref_err:
        _run(jax_ref, "fatal", X, y, num_leaves=4)
    ref = _run(jax_ref, "rollback", X, y)
    ref_log = capsys.readouterr().out

    def failed_at(err):
        return int(re.search(r"failed at iteration (\d+)", str(err.value)).group(1))

    assert failed_at(port_err) == failed_at(ref_err) == NAN_AT

    def rolled(log):
        return re.findall(r"rolled back (\d+) iteration\(s\) to (\d+)", log)

    assert rolled(port_log) == rolled(ref_log) == [("2", "3")]
    assert port.current_iteration() == ref.current_iteration()
    assert port.num_trees() == ref.num_trees() == ROUNDS - 2
    assert port._gbdt._health.clip_on and ref._gbdt._health.clip_on
    assert port.model_to_string() == ref.model_to_string()
    assert np.isfinite(port.predict(X)).all()


def test_warn_continues(capsys, data):
    X, y = data
    bst = _run(lt, "warn", X, y)
    assert "policy=warn: continuing" in capsys.readouterr().out
    assert bst.current_iteration() >= NAN_AT


def test_monitor_accumulates_on_device_and_clips():
    mon = HealthMonitor("rollback", check_every=3)
    mon.observe(torch.ones(4), None, torch.tensor([1.0, float("nan")]))
    assert mon._acc.dtype == torch.bool and not bool(mon._acc)
    g, h = HealthMonitor._sanitize(torch.tensor([float("nan"), float("inf"), -3e7, 0.5]),
                                   torch.tensor([float("nan"), float("inf"), -1.0, 0.25]))
    assert g.tolist() == [0.0, GRAD_CLIP, -GRAD_CLIP, 0.5]
    assert h.tolist() == [0.0, GRAD_CLIP, 0.0, 0.25]
    assert create_monitor(Config({})) is None
    with pytest.raises(LightGBMError, match="Unknown health_check_policy"):
        create_monitor(Config({"health_check_policy": "retry"}))
