"""Checkpoints of the port: bit-identical resume, and what a damaged
checkpoint does. The non-sharded cases of the JAX package's
tests/test_checkpoint.py, on the CPU.

Contract: train 10 rounds straight with `checkpoint_callback` writing a
checkpoint after round 5, then a fresh `train(..., init_model=<that
checkpoint>)` with the same command (10 rounds: the resume finishes the
run): the resumed model text is byte-equal to the straight run's and the
final train scores bit-equal, with column sampling,
with bagging cut inside its bagging_freq window, quantized with stochastic
rounding, with early stopping's state, and with GOSS. A sidecar that fails
its checksum, or whose model text was edited, is dropped with a warning and
the run continues from the model text alone; a missing sidecar does the
same without a word; a checkpoint of another dataset is refused. DART and
RF checkpoints keep the model text only.

Against the JAX package: the same four cases on grid-snapped custom
gradients (`fobj`; 7 leaves, a checkpoint after round 5 of a 5-round run,
resumed to 10), the resumed model text byte-equal to the JAX package's
uninterrupted 10-round run and the train scores bit-equal (the JAX split
search run op by op, as tests/test_torch_train.py runs it; its GOSS on the
device path, as tests/test_torch_goss.py runs it). The early-stop case is
held against the port's own straight run only.
"""
import json
import os

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.checkpoint import (CKPT_MAGIC, SIDECAR_SUFFIX, checkpoint_callback,
                                           load_checkpoint, save_checkpoint)
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _data, snapped_logloss

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}
CASES = {
    "col_sampling": {"feature_fraction": 0.7},
    # cut at 5 with bagging_freq 2: the bag drawn at iteration 4 is reused
    # at 5, so it must come back with the resume
    "bagged_mid_window": {"bagging_fraction": 0.6, "bagging_freq": 2, "feature_fraction": 0.8},
    "quantized": {"use_quantized_grad": True, "stochastic_rounding": True,
                  "quant_train_renew_leaf": True},
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.5},
}


def _train(params, X, y, rounds, init_model=None, valid=None, callbacks=None):
    valid_sets = None if valid is None else [lt.Dataset(valid[0], label=valid[1])]
    return lt.train(dict(params), lt.Dataset(X, label=y), num_boost_round=rounds,
                    init_model=init_model, valid_sets=valid_sets, callbacks=callbacks)


def _assert_bit_identical(straight, resumed):
    assert straight.current_iteration() == resumed.current_iteration()
    assert (straight.model_to_string(num_iteration=-1)
            == resumed.model_to_string(num_iteration=-1))
    assert np.array_equal(straight._gbdt.score.numpy(), resumed._gbdt.score.numpy())


@pytest.fixture(scope="module")
def data():
    return _data(with_nan=False, seed=13)


def _checkpoints(tmp_path, period):
    """A checkpoint callback writing <tmp_path>/ckpt_<iteration>.txt."""
    return checkpoint_callback(lambda it: str(tmp_path / f"ckpt_{it}.txt"), period=period)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_bit_identical(tmp_path, data, case):
    X, y = data
    params = {**BASE, **CASES[case]}
    straight = _train(params, X, y, 10, callbacks=[_checkpoints(tmp_path, 5)])
    path = str(tmp_path / "ckpt_5.txt")
    state = load_checkpoint(path)
    assert state is not None and state.iteration == 5
    if case == "quantized":
        assert state.learner["quant_key"].dtype == np.uint32
    if case == "bagged_mid_window":
        assert state.bag is not None and len(state.bag) < len(y)
    _assert_bit_identical(straight, _train(params, X, y, 10, init_model=path))


@pytest.mark.parametrize("case", list(CASES))
def test_resume_matches_jax(jax_ref, monkeypatch, tmp_path, data, case):
    X, y = data
    params = {**BASE, **CASES[case], "objective": snapped_logloss, "num_leaves": 7}
    _train(params, X, y, 5, callbacks=[_checkpoints(tmp_path, 5)])
    resumed = _train(params, X, y, 10, init_model=str(tmp_path / "ckpt_5.txt"))
    _op_by_op(monkeypatch)
    monkeypatch.setenv("LGBM_TPU_GOSS_DEVICE", "1")
    ref = jax_ref.train(dict(params), jax_ref.Dataset(X, label=y), num_boost_round=10)
    assert resumed.current_iteration() == ref.current_iteration() == 10
    assert (resumed.model_to_string(num_iteration=-1)
            == ref.model_to_string(num_iteration=-1))
    np.testing.assert_array_equal(resumed._gbdt.score.numpy(), np.asarray(ref._gbdt.score))


def test_resume_restores_early_stop_state(tmp_path, data):
    X, y = data
    Xv, yv = _data(with_nan=False, seed=14)
    params = {**BASE, "metric": "auc", "early_stopping_round": 2, "learning_rate": 0.5,
              "num_leaves": 31, "min_data_in_leaf": 2}
    straight = _train(params, X, y, 30, valid=(Xv, yv), callbacks=[_checkpoints(tmp_path, 1)])
    assert straight.current_iteration() < 30
    # the checkpoint before the best round: early stopping's state after
    # round `cut` must come back for the resumed run to stop where this does
    cut = max(2, straight.best_iteration - 1)
    path = str(tmp_path / f"ckpt_{cut}.txt")
    state = load_checkpoint(path)
    assert state is not None and state.es is not None and state.es["enabled"]
    assert state.iteration == cut and max(state.es["best_iter"]) == cut - 1
    resumed = _train(params, X, y, 30, init_model=path, valid=(Xv, yv))
    assert resumed.best_iteration == straight.best_iteration
    assert resumed.best_score["valid_0"] == straight.best_score["valid_0"]
    _assert_bit_identical(straight, resumed)


def test_manifest_contents(tmp_path, data):
    X, y = data
    half = _train({**BASE, **CASES["bagged_mid_window"]}, X, y, 4)
    path = str(tmp_path / "ckpt.txt")
    save_checkpoint(half, path)
    with open(path + SIDECAR_SUFFIX, "rb") as fh:
        assert fh.read(len(CKPT_MAGIC)) == CKPT_MAGIC
    man = load_checkpoint(path).manifest
    assert man["iteration"] == 4 and man["boosting"] == "GBDT" and man["num_data"] == len(y)
    assert man["world"]["device_kinds"] == ["cpu"] and man["world"]["mesh_shape"] == [1]
    assert man["async_stub_stop"] is False
    assert json.dumps(man)
    assert load_checkpoint(path).learner["colsampler_keys"].shape == (624,)


def test_corrupt_sidecar_falls_back_to_continued_training(tmp_path, data, capsys):
    X, y = data
    path = str(tmp_path / "ckpt.txt")
    save_checkpoint(_train(BASE, X, y, 3), path)
    with open(path + SIDECAR_SUFFIX, "rb+") as fh:
        fh.seek(64)
        fh.write(b"\x00" * 16)
    assert load_checkpoint(path) is None
    assert "unusable" in capsys.readouterr().out
    # the model text seeds init_score and the new booster grows 3 trees of its own
    assert _train(BASE, X, y, 3, init_model=path).current_iteration() == 3


def test_model_edit_invalidates_sidecar(tmp_path, data):
    X, y = data
    path = str(tmp_path / "ckpt.txt")
    save_checkpoint(_train(BASE, X, y, 3), path)
    with open(path, "a") as fh:
        fh.write("\n")
    assert load_checkpoint(path) is None


def test_missing_sidecar_is_silent_continued_training(tmp_path, data, capsys):
    X, y = data
    path = str(tmp_path / "model.txt")
    _train(BASE, X, y, 3).save_model(path)
    assert not os.path.exists(path + SIDECAR_SUFFIX)
    capsys.readouterr()
    assert load_checkpoint(path) is None
    assert "Warning" not in capsys.readouterr().out
    assert _train(BASE, X, y, 2, init_model=path).current_iteration() == 2


def test_restore_refuses_dataset_mismatch(tmp_path, data):
    X, y = data
    path = str(tmp_path / "ckpt.txt")
    save_checkpoint(_train(BASE, X, y, 2), path)
    X2, y2 = _data(with_nan=False, seed=15)
    with pytest.raises(LightGBMError, match="refusing to resume"):
        _train(BASE, X2[:1500], y2[:1500], 4, init_model=path)


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_dart_and_rf_checkpoint_the_model_text_only(tmp_path, data, boosting):
    X, y = data
    params = {**BASE, "boosting": boosting, "bagging_fraction": 0.5, "bagging_freq": 1}
    bst = _train(params, X, y, 3)
    path = str(tmp_path / "ckpt.txt")
    save_checkpoint(bst, path)
    assert not os.path.exists(path + SIDECAR_SUFFIX)
    with open(path) as fh:
        assert fh.read() == bst.model_to_string(num_iteration=-1)
