"""The command line (`python -m lightgbm_tpu_torch.cli`) against the JAX
package's and against the port's own entry points, with device_type=cpu.

Contracts, on a TSV train file (1,500 x 6 rows from a seed, a `.weight`
side file) and a 400-row valid file:
* `task=train`: the model is split for split with the JAX CLI's (features,
  thresholds, decision types, children and counts equal; values within
  rtol 1e-5, gains 1e-4, as tests/test_torch_train.py holds the built-in
  objectives), and byte-equal to `engine.train` on the parsed arrays with
  the same parameters; `save_binary=true` writes `<data>.bin`, and training
  from it gives the same model text; `snapshot_freq` checkpoints, and
  `input_model=<snapshot>` resumes to the same model text;
* `task=predict` writes Booster.predict's values as `%.9g` (raw, leaf
  indices and SHAP contributions too); `task=refit` equals Booster.refit
  byte for byte; `task=convert_model` writes model_to_cpp's text (and the
  JSON dump with `convert_model_language=json`); `task=save_binary` writes
  the cache of the text file;
* `task=serve` loads the model into a PredictionService on the configured
  device and hands it to the HTTP front (patched here);
* `num_machines=2` in a process that joined no gang is refused, naming the
  launcher; `tree_learner=data` alone trains in a world of one rank, the
  serial learner's model (tests/test_torch_launch.py runs the gangs).
"""
import json

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import key_alias_transform, kv2map
from lightgbm_tpu_torch.io.parser import parse_file
from lightgbm_tpu_torch.models.codegen import model_to_cpp
from lightgbm_tpu_torch.models.serialize import GBDTModel
from lightgbm_tpu_torch.utils.log import LightGBMError
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import _assert_split_for_split


def _ref_cli():
    from lightgbm_tpu import cli as ref_cli  # inside a test that holds jax_ref

    return ref_cli


@pytest.fixture(autouse=True)
def _keep_log_verbosity():
    """cli.run sets the process's log verbosity (verbosity=-1 in these
    arguments): put it back, so the next file's tests log as by default."""
    from lightgbm_tpu_torch.utils import log

    before = log._verbosity
    yield
    log.set_verbosity(before)


@pytest.fixture
def files(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.normal(size=(1900, 6))
    X[rng.rand(1900, 6) < 0.03] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) * np.nan_to_num(X[:, 2])
         + 0.3 * rng.normal(size=1900) > 0).astype(float)
    train, valid = str(tmp_path / "train.tsv"), str(tmp_path / "valid.tsv")
    np.savetxt(train, np.column_stack([y[:1500], X[:1500]]), delimiter="\t", fmt="%.9g")
    np.savetxt(train + ".weight", rng.uniform(0.5, 2, 1500), fmt="%.6g")
    np.savetxt(valid, np.column_stack([y[1500:], X[1500:]]), delimiter="\t", fmt="%.9g")
    return tmp_path, train, valid


def _train_args(tmp, train, valid, out, **extra):
    args = ["task=train", "objective=binary", "num_leaves=15", "num_iterations=4",
            f"data={train}", f"valid={valid}", f"output_model={out}", "device_type=cpu",
            "verbosity=-1", "metric_freq=2"]
    return args + [f"{k}={v}" for k, v in extra.items()]


def test_train_split_for_split_with_jax_and_equal_to_engine(jax_ref, files):
    tmp, train, valid = files
    args = _train_args(tmp, train, valid, str(tmp / "port.txt"))
    assert cli.run(args) == 0
    port = (tmp / "port.txt").read_text()
    ref_args = [a.replace("port.txt", "ref.txt") for a in args]
    assert _ref_cli().run(ref_args) == 0
    ref = (tmp / "ref.txt").read_text()
    _assert_split_for_split(port.replace("port.txt", "ref.txt"), ref, value_rtol=1e-5,
                            gain_rtol=1e-4)

    params = key_alias_transform(kv2map(args))
    params.pop("task")
    X, y, _ = parse_file(train)
    Xv, yv, _ = parse_file(valid)
    w = np.loadtxt(train + ".weight")
    ds = lt.Dataset(X, label=y, weight=w)
    engine = lt.train(params, ds, num_boost_round=4,
                      valid_sets=[lt.Dataset(Xv, label=yv, reference=ds)],
                      valid_names=["valid_1"])
    assert engine.model_to_string() == port


def test_train_from_saved_binary_and_snapshots(files):
    tmp, train, valid = files
    out = str(tmp / "m.txt")
    assert cli.run(_train_args(tmp, train, valid, out, save_binary="true",
                               snapshot_freq=2)) == 0
    text = open(out).read()
    assert (tmp / "train.tsv.bin").exists()
    assert cli.run(_train_args(tmp, train + ".bin", valid, str(tmp / "bin.txt"))) == 0
    from_bin = (tmp / "bin.txt").read_text()
    assert from_bin == text.replace("train.tsv]", "train.tsv.bin]")
    snap = f"{out}.snapshot_iter_2"
    assert cli.run(_train_args(tmp, train, valid, str(tmp / "resumed.txt"),
                               input_model=snap)) == 0
    assert (tmp / "resumed.txt").read_text() == text


@pytest.mark.parametrize("mode", ["normal", "raw", "leaf", "contrib"])
def test_predict_writes_booster_predict(jax_ref, files, mode):
    tmp, train, valid = files
    model = str(tmp / "m.txt")
    assert cli.run(_train_args(tmp, train, valid, model)) == 0
    flag = {"normal": [], "raw": ["predict_raw_score=true"],
            "leaf": ["predict_leaf_index=true"], "contrib": ["predict_contrib=true"]}[mode]
    out = str(tmp / "pred.txt")
    args = ["task=predict", f"data={valid}", f"input_model={model}", f"output_result={out}",
            "device_type=cpu", "verbosity=-1", "num_iteration_predict=3"] + flag
    assert cli.run(args) == 0
    Xv, _, _ = parse_file(valid)
    bst = lt.Booster(model_file=model, params={"device_type": "cpu"})
    want = bst.predict(Xv, num_iteration=3, raw_score=mode == "raw",
                       pred_leaf=mode == "leaf", pred_contrib=mode == "contrib")
    ref_out = str(tmp / "want.txt")
    np.savetxt(ref_out, np.asarray(want), fmt="%.9g",
               delimiter="\t" if np.ndim(want) > 1 else "\n")
    assert open(out).read() == open(ref_out).read()
    jax_out = str(tmp / "jax.txt")
    assert _ref_cli().run([a.replace(out, jax_out) for a in args]) == 0
    np.testing.assert_allclose(np.loadtxt(out), np.loadtxt(jax_out), rtol=1e-6, atol=1e-7)


def test_refit_equals_booster_refit(files):
    tmp, train, valid = files
    model = str(tmp / "m.txt")
    assert cli.run(_train_args(tmp, train, valid, model)) == 0
    out = str(tmp / "refit.txt")
    args = ["task=refit", f"data={valid}", f"input_model={model}", f"output_model={out}",
            "device_type=cpu", "verbosity=-1", "refit_decay_rate=0.7"]
    assert cli.run(args) == 0
    params = key_alias_transform(kv2map(args))
    params.pop("task")
    Xv, yv, _ = parse_file(valid)
    want = lt.Booster(model_file=model, params=params).refit(Xv, yv, decay_rate=0.7,
                                                             params=params)
    assert open(out).read() == want.model_to_string()


@pytest.mark.parametrize("language", ["cpp", "json"])
def test_convert_model(jax_ref, files, language):
    tmp, train, valid = files
    model = str(tmp / "m.txt")
    assert cli.run(_train_args(tmp, train, valid, model)) == 0
    out = str(tmp / f"m.{language}")
    args = ["task=convert_model", f"input_model={model}", f"convert_model={out}",
            f"convert_model_language={language}", "device_type=cpu", "verbosity=-1"]
    assert cli.run(args) == 0
    parsed = GBDTModel.from_file(model)
    text = open(out).read()
    if language == "cpp":
        assert text == model_to_cpp(parsed)
        ref_out = str(tmp / "ref.cpp")
        assert _ref_cli().run([a.replace(out, ref_out) for a in args]) == 0
        assert open(ref_out).read() == text
    else:
        assert json.loads(text) == json.loads(parsed.dump_json())


def test_save_binary_task(files):
    tmp, train, _ = files
    assert cli.run(["task=save_binary", f"data={train}", "device_type=cpu",
                    "verbosity=-1"]) == 0
    cached = lt.Dataset(train + ".bin").construct()
    direct = lt.Dataset(train).construct()
    np.testing.assert_array_equal(cached._handle.bins, direct._handle.bins)
    np.testing.assert_array_equal(cached._handle.metadata.weights,
                                  direct._handle.metadata.weights)


def test_serve_loads_the_model_and_starts_http(files, monkeypatch):
    from lightgbm_tpu_torch.serving import http

    tmp, train, valid = files
    model = str(tmp / "m.txt")
    assert cli.run(_train_args(tmp, train, valid, model)) == 0
    started = {}

    class _Thread:
        def join(self):
            started["joined"] = True

    def fake_serve(service, host, port):
        started.update(service=service, host=host, port=port)
        return None, _Thread()

    monkeypatch.setattr(http, "serve", fake_serve)
    assert cli.run(["task=serve", f"input_model={model}", "device_type=cpu",
                    "serve_port=0", "serve_model_name=m1", "verbosity=-1",
                    "serve_max_batch_rows=512"]) == 0
    service = started["service"]
    try:
        assert started["port"] == 0 and started["joined"]
        assert str(service.device) == "cpu"
        Xv, _, _ = parse_file(valid)
        got = service.predict("m1", Xv[:16].astype(np.float32))
        want = lt.Booster(model_file=model, params={"device_type": "cpu"}).predict(
            Xv[:16].astype(np.float32))
        np.testing.assert_array_equal(np.asarray(got).ravel(), want.ravel())
    finally:
        service.close()


@pytest.mark.parametrize("arg", ["num_machines=2", "tree_learner=data"])
def test_distributed_runs_refused_by_item_8(files, arg):
    """Item 8's learners are ported: num_machines=2 with no gang joined is
    refused (the message names the launcher); tree_learner=data in a world
    of one rank trains the serial learner's model."""
    tmp, train, valid = files
    args = _train_args(tmp, train, valid, str(tmp / "m.txt"))
    if arg == "num_machines=2":
        with pytest.raises(LightGBMError, match="lightgbm_tpu_torch.launch"):
            cli.run(args + [arg])
        return
    assert cli.run(args + [arg]) == 0
    assert cli.run(_train_args(tmp, train, valid, str(tmp / "serial.txt"))) == 0
    got = (tmp / "m.txt").read_text().split("end of trees")[0]
    assert got == (tmp / "serial.txt").read_text().split("end of trees")[0]
