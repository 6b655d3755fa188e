"""The host-driven distributed learners (lightgbm_tpu_torch/parallel/
learners.py) on gloo gangs of 2 and 4 CPU ranks, against the JAX package's
parallel learners at the same world size (``LGBM_TPU_FORCE_MESH_DEVICES``
set to it, on the 8 virtual CPU devices of tests/conftest.py) and against
the port's own serial learner.

Contracts, on grid-snapped gradients (the CPU's float32 sums are exact in
any order there, the JAX package's contract): data-, feature- and
voting-parallel (top_k >= F: every feature elected; top_k=2 of 7: four
elected a leaf, so the nomination, the election, the reduction of the
elected slices and the rescan decide the splits), and with a categorical
feature, give model texts equal to the JAX package's line for line but
split_gain, which is within 4 ULP (the JAX scan runs jitted inside its
shard_map, the port's op by op); every rank holds the same model; each
but the narrow vote is the port's serial model exactly, bagging and
per-node sampling included (the JAX package's host-driven learners sample
per tree only, and its data-parallel one fails to score a bagged tree).
One gang a world size runs every configuration.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import data, run_gang, snapped_logloss

ROUNDS = 4
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5}
# (params, snapped fobj, categorical), each also run by the JAX package
JAX_CONFIGS = [
    (dict(BASE, tree_learner="data"), True, False),
    (dict(BASE, tree_learner="feature"), True, False),
    (dict(BASE, tree_learner="voting", top_k=20), True, False),
    (dict(BASE, tree_learner="data"), True, True),
    (dict(BASE, tree_learner="feature"), True, True),
    (dict(BASE, tree_learner="voting", top_k=2), True, False),
]
# the port's own, held to the serial learner / to every rank agreeing:
# bagging (the JAX package's host-driven data-parallel learner fails to
# score a bagged tree: its scatter-add meets row-sharded bins), per-node
# sampling
PORT_CONFIGS = [
    (dict(BASE, tree_learner="data", bagging_fraction=0.7, bagging_freq=1), True, False),
    (dict(BASE, tree_learner="data", feature_fraction_bynode=0.6), True, False),
]
LEARNERS = {"data": "DataParallelTreeLearner", "feature": "FeatureParallelTreeLearner",
            "voting": "VotingParallelTreeLearner"}


def _trees(text):
    return text.split("end of trees")[0].splitlines()


def _tree_fields(lines):
    """The trees' lines -> [{key: value}] a tree."""
    out = []
    for line in lines:
        if line.startswith("Tree="):
            out.append({})
        elif out and "=" in line:
            key, value = line.split("=", 1)
            out[-1][key] = value
    return out


def _assert_equal_but_gain(port, ref, rate=0.1):
    """Line for line equal, split_gain within 4 ULP of the un-shifted gain
    (the gain plus the parent's leaf gain out**2 * sum_h, out the parent's
    output before the learning rate; lambda_l1 = lambda_l2 = 0), at which
    magnitude the split search rounds."""
    a, b = _trees(port), _trees(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x == y or x.startswith("tree_sizes="):
            continue
        assert x.startswith("split_gain=") and y.startswith("split_gain="), (x, y)
    for ta, tb in zip(_tree_fields(a), _tree_fields(b)):
        if "split_gain" not in ta:
            continue
        gx, gy = (np.array(t["split_gain"].split(), np.float32) for t in (ta, tb))
        out = np.array(ta["internal_value"].split(), np.float32) / np.float32(rate)
        sum_h = np.array(ta["internal_weight"].split(), np.float32)
        ulp = np.spacing(np.abs(gy) + out * out * sum_h)
        assert (np.abs(gx - gy) <= 4 * ulp).all(), (gx, gy)


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def gang(request, tmp_path_factory):
    size = request.param
    out = run_gang("train_models", size, tmp_path_factory.mktemp(f"gang{size}"),
                   JAX_CONFIGS + PORT_CONFIGS, ROUNDS)
    return size, out


def _jax_model(jax_ref, monkeypatch, size, params, categorical):
    monkeypatch.setenv("LGBM_TPU_FORCE_MESH_DEVICES", str(size))
    X, y = data(0, categorical=categorical)
    p = dict(params, device_type="cpu", verbosity=-1, objective=snapped_logloss)
    ds = jax_ref.Dataset(X, label=y, categorical_feature=[0] if categorical else "auto")
    return jax_ref.train(p, ds, num_boost_round=ROUNDS).model_to_string()


def test_every_rank_holds_the_same_model_and_learner(gang):
    size, out = gang
    for i, (params, _, _) in enumerate(JAX_CONFIGS + PORT_CONFIGS):
        assert {r[i]["learner"] for r in out} == {LEARNERS[params["tree_learner"]]}
        assert len({r[i]["model"] for r in out}) == 1
        assert all(np.array_equal(r[i]["score"], out[0][i]["score"]) for r in out)


@pytest.mark.parametrize("i", range(len(JAX_CONFIGS)),
                         ids=["data", "feature", "voting", "data-categorical",
                              "feature-categorical", "voting-top2"])
def test_model_text_matches_jax(jax_ref, monkeypatch, gang, i):
    size, out = gang
    params, _, categorical = JAX_CONFIGS[i]
    _assert_equal_but_gain(out[0][i]["model"],
                           _jax_model(jax_ref, monkeypatch, size, params, categorical))


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4, 6, 7], ids=[
    "data", "feature", "voting", "data-categorical", "feature-categorical", "data-bagged",
    "data-bynode"])
def test_model_text_equals_the_serial_learner(gang, i):
    size, out = gang
    params, _, categorical = (JAX_CONFIGS + PORT_CONFIGS)[i]
    X, y = data(0, categorical=categorical)
    serial = {k: v for k, v in params.items() if k not in ("tree_learner", "top_k")}
    bst = lt.train(dict(serial, device_type="cpu", verbosity=-1, objective=snapped_logloss),
                   lt.Dataset(X, label=y, categorical_feature=[0] if categorical else "auto"),
                   num_boost_round=ROUNDS)
    got = [ln for ln in out[0][i]["model"].split("end of trees")[0].splitlines()]
    want = [ln for ln in bst.model_to_string().split("end of trees")[0].splitlines()]
    assert got == want


def test_narrow_vote_still_trains(gang):
    """top_k=2 of 7 features: each child elects 4, the trees still grow to
    their leaves on every rank alike, and the election bites (the model is
    not the exact data-parallel one)."""
    size, out = gang
    i = len(JAX_CONFIGS) - 1
    text = out[0][i]["model"]
    assert text.count("Tree=") == ROUNDS
    assert "num_leaves=15" in text
    assert _trees(text) != _trees(out[0][0]["model"])
