"""The GBDT's async per-tree pipeline (models/gbdt.py `_async_enabled`,
`_flush_pending`, `_train_one_iter_async`) and the score update from the
split log (ops/score.py `apply_split_log_to_score`), on the CPU with the
port's wave learner swapped into the GBDT (the CPU's factory picks the
serial learner), against the synchronous path and the JAX package.

Contracts:

* the gate: on at a float32-exact learning rate (0.125) from the second
  iteration, off at 0.1, under bagging, with custom gradients, on the first
  iteration, with the serial learner and with `_async_pipeline` False;
* scores and model text bit-identical to the synchronous path, with a
  predict mid-stream (it flushes the pending tree and answers as the
  synchronous booster does);
* the no-gain stop reported at most one iteration late, the surviving
  trees equal;
* the split log's score update bit-equal to the host tree's update (the
  leaf values gathered by each row's leaf id) on trees of 1, 2 and 255
  leaves;
* the model text byte-equal to the JAX package's async run (its pipeline
  forced on with LGBM_TPU_ASYNC for the JAX side only) but split_gain,
  within 4 ULP of the un-shifted gain (the JAX grower is jitted: ROADMAP
  Queue 3), and the train scores bit-equal, on data whose gradients stay
  on a 2**-k grid so that every sum is exact;
* every reader flushes: eval, predict, leaf predict, export;
* two trees pending in one learner keep their own results: tree t is
  enqueued before tree t-1 is finalized, and t-1's tree is its own log; a
  third is refused.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Dataset as CoreDataset
from lightgbm_tpu_torch.models.gbdt import GBDT, _pack_gh
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops.score import apply_split_log_to_score
from lightgbm_tpu_torch.treelearner.device import DeviceTreeLearner
from tests.test_torch_multiclass import _assert_text_equal_but_gain
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

CPU = torch.device("cpu")
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.125,
          "min_data_in_leaf": 5, "metric": "None", "verbosity": -1}


def _data(seed=0, n=900, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] - 0.7 * X[:, 1] + rng.randn(n) * 0.3 > 0).astype(float)
    return X, y


def _booster(X, y, params, asyn=True, wave=True, valid=None):
    """A Booster whose GBDT grows with the port's wave learner on the CPU."""
    ds = lt.Dataset(X, label=y)
    bst = lt.Booster(dict(params, device_type="cpu"), ds)
    gbdt = bst._gbdt
    if wave:
        gbdt.tree_learner = DeviceTreeLearner(gbdt.config, ds._handle, CPU)
    gbdt._async_pipeline = asyn
    if valid is not None:
        bst.add_valid(ds.create_valid(*valid), "valid")
    return bst


def _run(bst, rounds, probe=None):
    """Update `rounds` times; returns the iteration that reported the stop
    (or None). `probe(bst, it)` runs after each update."""
    for it in range(rounds):
        if bst.update():
            return it
        if probe is not None:
            probe(bst, it)
    return None


def _assert_same_models(a, b):
    assert len(a.models) == len(b.models)
    for ta, tb in zip(a.models, b.models):
        for k, va in ta.__dict__.items():
            vb = tb.__dict__[k]
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=k)
            else:
                assert va == vb, k


GATE = [("rate 0.125", {}, True), ("rate 0.1", {"learning_rate": 0.1}, False),
        ("rate 0.375", {"learning_rate": 0.375}, True),
        ("bagging", {"bagging_fraction": 0.7, "bagging_freq": 1}, False),
        ("serial learner", {}, False), ("switched off", {}, False),
        ("custom gradients", {"objective": "none"}, False)]


@pytest.mark.parametrize("name,extra,on", GATE, ids=[g[0] for g in GATE])
def test_gate(name, extra, on):
    """`_async_enabled` and whether an iteration after the first really
    leaves a tree pending; the first iteration never does."""
    X, y = _data()
    bst = _booster(X, y, {**PARAMS, **extra}, asyn=name != "switched off",
                   wave=name != "serial learner")
    fobj = snapped_logloss if name == "custom gradients" else None
    bst.update(fobj=fobj)
    assert bst._gbdt._pending is None  # the first iteration is synchronous
    bst.update(fobj=fobj)
    gate = bst._gbdt._async_enabled() if bst._gbdt.objective is not None else False
    assert gate is (on or name in ("bagging",))  # bagging is the caller's exclusion
    assert (bst._gbdt._pending is not None) is on


def test_bit_identical_to_sync_with_a_predict_mid_stream():
    X, y = _data(1)
    sync = _booster(X, y, PARAMS, asyn=False)
    _run(sync, 6)
    answers = {}

    def probe(bst, it):
        if it == 2:
            assert bst._gbdt._pending is not None
            answers["mid"] = bst.predict(X[:64], raw_score=True)
            assert bst._gbdt._pending is None

    asy = _booster(X, y, PARAMS)
    _run(asy, 6, probe)
    mid = _booster(X, y, PARAMS, asyn=False)
    _run(mid, 3)
    np.testing.assert_array_equal(answers["mid"], mid.predict(X[:64], raw_score=True))
    assert asy._gbdt._pending is not None
    assert torch.equal(sync._gbdt.score, asy._gbdt.score)
    assert sync.model_to_string() == asy.model_to_string()
    _assert_same_models(sync._gbdt, asy._gbdt)
    np.testing.assert_array_equal(sync.predict(X, raw_score=True),
                                  asy.predict(X, raw_score=True))


NO_GAIN = {
    # the JAX package's test data (tests/test_device_learner.py): constant
    # labels, so the first iteration already stops
    "constant": (lambda rng: (rng.randn(400, 4), np.ones(400)),
                 {"objective": "regression", "num_leaves": 31, "learning_rate": 0.5,
                  "boost_from_average": False}),
    # one exact split fits the labels: the second tree, the first async
    # one, finds no gain above min_gain_to_split and is a stub
    "fitted": (lambda rng: (np.repeat([[-1.0, 0.0], [1.0, 0.0]], 200, axis=0)
                            + [0, 1] * rng.randn(400, 2),
                            np.repeat([0.0, 1.0], 200)),
               {"objective": "regression", "num_leaves": 4, "learning_rate": 1.0,
                "min_gain_to_split": 1e-3, "min_data_in_leaf": 5}),
}


@pytest.mark.parametrize("case", sorted(NO_GAIN))
def test_stops_on_no_gain_at_most_one_iteration_late(case):
    make, params = NO_GAIN[case]
    X, y = make(np.random.RandomState(7))
    params = {**params, "metric": "None", "verbosity": -1}
    sync = _booster(X, y, params, asyn=False)
    stop_sync = _run(sync, 6)
    asy = _booster(X, y, params)
    stop_async = _run(asy, 6)
    assert stop_sync is not None and stop_async is not None
    assert stop_sync <= stop_async <= stop_sync + 1
    if case == "fitted":
        assert (stop_sync, stop_async) == (1, 2)  # the pipeline's stub path ran
    assert asy._gbdt._pending is None
    _assert_same_models(sync._gbdt, asy._gbdt)
    assert sync._gbdt.iter_ == asy._gbdt.iter_
    assert torch.equal(sync._gbdt.score, asy._gbdt.score)
    assert sync.model_to_string() == asy.model_to_string()


@pytest.mark.parametrize("num_leaves", [1, 2, 255])
def test_split_log_update_equals_host_tree_update(num_leaves):
    """A tree of 1 leaf (the root cannot split), 2 and 255 leaves: the
    score from the device split log equals the score from the replayed
    tree's leaf values, bit for bit; a tree with no split adds zero."""
    n = 2000
    rng = np.random.RandomState(num_leaves)
    X = rng.randn(n, 6)
    y = X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(n)
    params = {"objective": "regression", "num_leaves": max(num_leaves, 2),
              "min_data_in_leaf": 2 if num_leaves == 255 else 20, "verbosity": -1}
    if num_leaves == 1:
        params["min_gain_to_split"] = 1e9
    cfg = Config({**params, "device_type": "cpu"})
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    learner = DeviceTreeLearner(cfg, ds, CPU)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    score = torch.from_numpy(rng.randn(n).astype(np.float32))
    rate = 0.125
    pending = learner.train_async(_pack_gh(grad, hess))
    from_log = score.clone()
    apply_split_log_to_score(from_log, pending.grown.rec_store_dev, pending.grown.leaf_id,
                             rate, cfg.num_leaves)
    tree = learner.finalize(pending)
    assert tree.num_leaves == num_leaves
    tree.shrink(rate)
    lv = torch.as_tensor(tree.leaf_value[:tree.num_leaves], dtype=torch.float32)
    ids = pending.grown.leaf_id.to(torch.int64)
    host = score + lv[ids]
    if num_leaves == 1:
        assert torch.equal(from_log, score + 0.0)
    assert torch.equal(from_log.view(torch.int32), host.view(torch.int32))


def test_model_text_byte_equal_to_jax_async(jax_ref, monkeypatch):
    """L2 regression on labels 0..3 set by two binary features: each tree's
    leaves are pure, so every gradient, sum and leaf value stays on a 2**-k
    grid and both packages compute them exactly. The JAX package's
    pipeline is forced on (LGBM_TPU_ASYNC=1, the JAX side's switch); the
    port's runs by its own gate."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Dataset as JDataset
    from lightgbm_tpu.models.gbdt import GBDT as JGBDT
    from lightgbm_tpu.objectives import create_objective as jobjective
    from lightgbm_tpu.treelearner.device import DeviceTreeLearner as JLearner

    monkeypatch.setenv("LGBM_TPU_ADAPTIVE_WAVE", "0")
    monkeypatch.setenv("LGBM_TPU_ASYNC", "1")
    rng = np.random.RandomState(3)
    n = 256
    b = rng.randint(0, 2, size=(n, 2)).astype(np.float64)
    X = np.concatenate([b, rng.randn(n, 2)], axis=1)
    y = b[:, 0] + 2 * b[:, 1]
    # min_gain_to_split: a pure leaf's splits have zero gain but for the
    # gain arithmetic's rounding, which the two packages round apart
    params = {"objective": "regression", "num_leaves": 7, "learning_rate": 0.125,
              "boost_from_average": False, "min_data_in_leaf": 5,
              "min_gain_to_split": 1e-3, "verbosity": -1}
    port_cfg = Config({**params, "device_type": "cpu"})
    port_ds = CoreDataset.from_matrix(X, label=y, config=port_cfg)
    port = GBDT(port_cfg, port_ds, create_objective("regression", port_cfg), CPU)
    port.tree_learner = DeviceTreeLearner(port_cfg, port_ds, CPU)
    port.tree_learner._adaptive_wave = False
    jcfg = JConfig(params)
    jds = JDataset.from_matrix(X, label=y, config=jcfg)
    ref = JGBDT(jcfg, jds, jobjective("regression", jcfg))
    ref.tree_learner = JLearner(jcfg, jds)
    pending_seen = []
    for _ in range(5):
        assert not port.train_one_iter() and not ref.train_one_iter()
        pending_seen.append((port._pending is not None, ref._pending is not None))
    assert pending_seen[1:] == [(True, True)] * 4
    _assert_text_equal_but_gain(port.to_model().to_string(), ref.to_model().to_string(),
                                0.125)
    np.testing.assert_array_equal(port.score.numpy(), np.asarray(ref.score))


READERS = {
    "eval_train": lambda bst, X: bst.eval_train(),
    "eval_valid": lambda bst, X: bst.eval_valid(),
    "predict": lambda bst, X: bst.predict(X[:32]),
    "pred_leaf": lambda bst, X: bst.predict(X[:32], pred_leaf=True),
    "model_to_string": lambda bst, X: bst.model_to_string(),
    "save_model": lambda bst, X: bst.save_model(bst._path),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_every_reader_flushes(reader, tmp_path):
    """A reader in the middle of training finalizes the pending tree
    first: its answer is the synchronous booster's, and training goes on
    equal to it."""
    X, y = _data(2)
    valid = (X[:200], y[:200])
    params = {**PARAMS, "metric": "binary_logloss"}
    out = []
    for asyn in (True, False):
        bst = _booster(X, y, params, asyn=asyn, valid=valid)
        bst._path = str(tmp_path / f"model_{asyn}.txt")
        _run(bst, 3)
        assert (bst._gbdt._pending is not None) is asyn
        got = READERS[reader](bst, X)
        assert bst._gbdt._pending is None
        if reader == "save_model":
            got = open(bst._path).read()
        _run(bst, 2)
        out.append((got, bst.model_to_string(), bst._gbdt.score.clone()))
    (a, text_a, score_a), (b, text_b, score_b) = out
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b
    assert text_a == text_b and torch.equal(score_a, score_b)


def test_pending_trees_keep_their_own_results():
    """Tree t enqueued before tree t-1 is finalized: each finalizes to the
    tree grown alone from its gradients (its own split log and leaf ids,
    not the later tree's); a third pending tree is refused."""
    X, y = _data(3)
    cfg = Config({**PARAMS, "device_type": "cpu"})
    ds = CoreDataset.from_matrix(X, label=y, config=cfg)
    rng = np.random.RandomState(4)
    ghs = [_pack_gh(torch.from_numpy(rng.randn(len(y)).astype(np.float32)),
                    torch.from_numpy(rng.uniform(0.5, 1.5, len(y)).astype(np.float32)))
           for _ in range(2)]
    alone = []
    for gh in ghs:
        learner = DeviceTreeLearner(cfg, ds, CPU)
        tree = learner.train(gh)
        alone.append((tree.to_string(), learner.partition.leaf_ids_dev().clone()))
    learner = DeviceTreeLearner(cfg, ds, CPU)
    first = learner.train_async(ghs[0])
    second = learner.train_async(ghs[1])
    with pytest.raises(RuntimeError, match="not finalized"):
        learner.train_async(ghs[0])
    for pending, (text, ids) in zip((first, second), alone):
        tree = learner.finalize(pending)
        assert tree.to_string() == text
        assert torch.equal(learner.partition.leaf_ids_dev(), ids)
    assert alone[0][0] != alone[1][0]
    learner.finalize(learner.train_async(ghs[0]))  # the slots are free again
