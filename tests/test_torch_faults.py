"""Fault injection in the port (utils/faults.py) on the CPU: the mirror of
the JAX package's tests/test_faults.py, and the plans against the JAX
package's.

Contracts:

* a FaultPlan's fields equal the JAX package's for every training,
  checkpoint, serving and drift token; each distributed token is refused
  with a LightGBMError naming its ROADMAP item (8);
* ``kill@K`` after periodic checkpoints, then the same command resumed from
  the checkpoint: model text byte-equal to the uninterrupted run;
* ``nan_gh@K:frac`` under each health policy at the JAX package's
  iterations: fatal raises at the same check in both packages, warn goes
  on (its trees stop at the poisoned iteration, as the JAX package's), rollback
  rolls back as far as the JAX package and its model text is byte-equal to
  the JAX package's (snapped gradients, the JAX split search op by op);
* transient write failures are absorbed by the retrying writer, a
  corrupted sidecar is rejected, a truncated model text fails fast.
"""
import os
import re

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.checkpoint import (atomic_write_text, checkpoint_callback,
                                           load_checkpoint, save_checkpoint)
from lightgbm_tpu_torch.models.serialize import GBDTModel
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import InjectedFault
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _data as _snapped_data
from tests.test_torch_train import snapped_logloss

BASE = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()


def _data(seed=7, n=500, f=10):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.standard_normal(n) * 0.5 > 0)
    return X, y.astype(np.float64)


def _train(params, X, y, rounds, init_model=None, cbs=None):
    return lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds,
                    init_model=init_model, callbacks=cbs)


# ------------------------------------------------------------ the plans

TOKENS = ["kill@3", "nan_gh@2", "nan_gh@4:0.25", "ckpt_write_fail:2", "ckpt_corrupt",
          "ckpt_truncate", "slow_predict@3", "slow_predict@2:0.5", "predict_fail@4",
          "predict_fail@1:7", "model_corrupt_upload",
          "kill@1,nan_gh@2:0.1,ckpt_write_fail:1,predict_fail@2:2,model_corrupt_upload",
          "drift_shift@100:3", "bad_generation@2", "sketch_corrupt@5"]
FIELDS = ("kill_at", "nan_at", "nan_frac", "write_fails", "corrupt_sidecar",
          "truncate_model", "slow_predict_at", "slow_predict_s", "fail_predict_at",
          "fail_predict_count", "corrupt_upload", "drift_shift", "bad_generation",
          "sketch_corrupt", "seed", "spec")


@pytest.mark.parametrize("spec", TOKENS)
def test_plan_fields_equal_jax(jax_ref, spec):
    from lightgbm_tpu.utils import faults as jax_faults

    ours, theirs = faults.FaultPlan(spec, seed=5), jax_faults.FaultPlan(spec, seed=5)
    for field in FIELDS:
        assert getattr(ours, field) == getattr(theirs, field), field


REFUSED = [("worker_kill@1:3", 8), ("worker_hang@0:2", 8), ("coord_loss@4", 8),
           ("slow_worker@1:250", 8), ("vote_skew@0:1", 8)]


@pytest.mark.parametrize("spec,item", REFUSED)
def test_distributed_and_drift_tokens_refused_by_item(jax_ref, spec, item):
    """The distributed tokens (the drift tokens are armed now: TOKENS)."""
    from lightgbm_tpu.utils import faults as jax_faults

    jax_faults.FaultPlan(spec)  # the JAX package arms it
    with pytest.raises(LightGBMError, match=rf"ROADMAP Queue 1 item {item}\)"):
        faults.FaultPlan(spec)


def test_malformed_and_unknown_tokens_are_fatal():
    for spec in ("explode@3", "predict_slow@1", "worker_kill@x", "coord_loss@"):
        with pytest.raises(LightGBMError):
            faults.FaultPlan(spec)


def test_env_plan_read_once(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "kill@9")
    monkeypatch.setenv("LGBM_TPU_FAULT_SEED", "4")
    faults.clear()
    plan = faults._get()
    assert plan.kill_at == 9 and plan.seed == 4 and faults._get() is plan


# --------------------------------------------------------- kill-and-resume


def test_kill_at_iteration_then_resume_bit_identical(tmp_path):
    X, y = _data()
    params = {**BASE, "bagging_fraction": 0.7, "bagging_freq": 2}
    straight = _train(params, X, y, 6)
    p = str(tmp_path / "snap.txt")
    faults.install("kill@4")
    with pytest.raises(InjectedFault):
        _train(params, X, y, 6, cbs=[checkpoint_callback(p, period=2)])
    faults.clear()
    assert load_checkpoint(p).iteration == 4
    resumed = _train(params, X, y, 6, init_model=p)
    assert straight.model_to_string(num_iteration=-1) == resumed.model_to_string(
        num_iteration=-1)
    np.testing.assert_array_equal(straight.predict(X, raw_score=True),
                                  resumed.predict(X, raw_score=True))


def test_kill_fires_once_per_plan(tmp_path):
    X, y = _data()
    p = str(tmp_path / "snap.txt")
    faults.install("kill@2")
    with pytest.raises(InjectedFault):
        _train(BASE, X, y, 4, cbs=[checkpoint_callback(p, period=1)])
    resumed = _train(BASE, X, y, 4, init_model=p)  # plan still armed
    assert resumed.current_iteration() == 4


def test_kill_dumps_the_flight_recorder():
    from lightgbm_tpu_torch import tracing

    X, y = _data(n=200)
    faults.install("kill@1")
    with pytest.raises(InjectedFault):
        _train(BASE, X, y, 3)
    dump = tracing.last_dump()
    assert dump["reason"] == "train_exception"
    assert any(e["kind"] == "fault" and e["fault"] == "kill" for e in dump["events"])


# ------------------------------------------------ numerical-health policies

NAN_AT, ROUNDS, EVERY = 5, 7, 2
SNAPPED = {"objective": "none", "num_leaves": 7, "device_type": "cpu", "verbosity": -1,
           "health_check_every": EVERY}


def _poisoned_run(pkg, fault_mod, policy, X, y, **extra):
    fault_mod.install(f"nan_gh@{NAN_AT}:0.05", seed=3)
    try:
        bst = pkg.Booster({**SNAPPED, "health_check_policy": policy, **extra},
                          pkg.Dataset(X, label=y))
        for _ in range(ROUNDS):
            if bst.update(fobj=snapped_logloss):
                break
        return bst
    finally:
        fault_mod.clear()


def test_nan_gh_policies_match_jax(jax_ref, monkeypatch, capsys):
    from lightgbm_tpu.utils import faults as jax_faults

    X, y = _snapped_data(seed=16)
    with pytest.raises(LightGBMError) as port_err:
        _poisoned_run(lt, faults, "fatal", X, y)
    port = _poisoned_run(lt, faults, "rollback", X, y)
    port_log = capsys.readouterr().out
    warned = _poisoned_run(lt, faults, "warn", X, y)
    assert "policy=warn: continuing" in capsys.readouterr().out
    assert warned.current_iteration() >= NAN_AT
    _op_by_op(monkeypatch)
    with pytest.raises(Exception) as ref_err:
        _poisoned_run(jax_ref, jax_faults, "fatal", X, y)
    ref = _poisoned_run(jax_ref, jax_faults, "rollback", X, y)
    ref_log = capsys.readouterr().out

    def failed_at(err):
        return int(re.search(r"failed at iteration (\d+)", str(err.value)).group(1))

    assert failed_at(port_err) == failed_at(ref_err) >= NAN_AT

    def rolled(log):
        return re.findall(r"rolled back (\d+) iteration\(s\) to (\d+)", log)

    assert rolled(port_log) == rolled(ref_log) and rolled(port_log)
    assert port.current_iteration() == ref.current_iteration()
    assert port.model_to_string() == ref.model_to_string()
    assert np.isfinite(port.predict(X)).all()


def test_poison_rows_are_the_jax_packages(jax_ref):
    import jax.numpy as jnp
    import torch

    from lightgbm_tpu.utils import faults as jax_faults

    g = np.arange(40, dtype=np.float32).reshape(1, 40)
    faults.install("nan_gh@3:0.1", seed=2)
    jax_faults.install("nan_gh@3:0.1", seed=2)
    try:
        ours, _ = faults.maybe_poison_gh(torch.from_numpy(g), torch.from_numpy(g), 3)
        theirs, _ = jax_faults.maybe_poison_gh(jnp.asarray(g[0]), jnp.asarray(g[0]), 3)
    finally:
        jax_faults.clear()
    np.testing.assert_array_equal(np.isnan(ours.numpy()[0]), np.isnan(np.asarray(theirs)))
    assert not np.isnan(g).any()  # a copy is poisoned, never the caller's array


def test_unpoisoned_run_ignores_policy():
    X, y = _data()
    plain = _train(BASE, X, y, 4)
    guarded = _train({**BASE, "health_check_policy": "rollback", "health_check_every": 2},
                     X, y, 4)

    def strip(b):
        return b.model_to_string(num_iteration=-1).split("\nparameters")[0]

    assert strip(plain) == strip(guarded)


# ------------------------------------------------- transient write failures


def test_transient_write_failures_absorbed_by_retries(tmp_path):
    p = str(tmp_path / "out.txt")
    faults.install("ckpt_write_fail:2")
    atomic_write_text(p, "survived")  # retries=3 > 2 injected failures
    with open(p) as fh:
        assert fh.read() == "survived"


def test_write_failures_beyond_retries_raise(tmp_path):
    p = str(tmp_path / "out.txt")
    faults.install("ckpt_write_fail:5")
    with pytest.raises(OSError):
        atomic_write_text(p, "doomed")
    assert not os.path.exists(p)


# ----------------------------------------------------- damaged artifacts


def test_corrupted_sidecar_is_rejected_on_load(tmp_path):
    X, y = _data()
    half = _train(BASE, X, y, 3)
    p = str(tmp_path / "snap.txt")
    faults.install("ckpt_corrupt")
    save_checkpoint(half, p)
    assert load_checkpoint(p) is None
    resumed = _train(BASE, X, y, 2, init_model=p)
    assert resumed.current_iteration() == 2


def test_truncated_model_fails_fast_with_filename(tmp_path):
    X, y = _data()
    bst = _train(BASE, X, y, 3)
    p = str(tmp_path / "model.txt")
    faults.install("ckpt_truncate")
    bst.save_model(p)
    with pytest.raises(LightGBMError) as ei:
        GBDTModel.from_file(p)
    assert "model.txt" in str(ei.value) and "truncated or corrupt" in str(ei.value)


# ------------------------------------------------------------- serving


def test_on_serve_dispatch_window():
    faults.install("predict_fail@2:2")
    faults.on_serve_dispatch()
    for _ in range(2):
        with pytest.raises(InjectedFault):
            faults.on_serve_dispatch()
    faults.on_serve_dispatch()
    faults.clear()
    faults.on_serve_dispatch()
    assert faults._get()._dispatch_no == 0


def test_corrupt_upload_fires_once():
    faults.install("model_corrupt_upload")
    text = "x" * 4096
    first = faults.maybe_corrupt_upload(text)
    assert first != text and len(first) == len(text)
    assert faults.maybe_corrupt_upload(text) == text
