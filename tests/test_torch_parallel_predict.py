"""Row-sharded prediction (lightgbm_tpu_torch/parallel/predict.py) and the
service's shard_rows, on gloo gangs of 2 and 4 CPU ranks.

Contracts: on every rank Booster.predict with pred_shard_rows returns the
whole predict's bits, the ranks traverse disjoint row blocks covering every
row once, and a PredictionService loaded with shard_rows answers with
Booster.predict's bits (its batches split over the ranks); the raw scores
equal the JAX package's `predict_raw_sharded` on a mesh of the same size
and its unsharded predict. Out of a gang (a world of one) nothing shards,
whatever the threshold.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.synthetic import random_model
from lightgbm_tpu_torch.parallel import predict as ppredict
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.torch_gang import N_FEATURES, run_gang

N_ROWS, SHARD_ROWS = 6000, 1000


@pytest.fixture(scope="module")
def model_text():
    return random_model(np.random.RandomState(0), N_FEATURES, 12, 31).to_string()


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def gang(request, model_text, tmp_path_factory):
    size = request.param
    return size, run_gang("predict_sharded", size, tmp_path_factory.mktemp(f"pred{size}"),
                          model_text, N_ROWS, SHARD_ROWS)


def test_sharded_predict_bit_equal_on_every_rank(gang):
    size, out = gang
    for r in out:
        assert r["whole"].dtype == r["sharded"].dtype
        assert r["whole"].tobytes() == r["sharded"].tobytes()
        assert r["whole"].tobytes() == out[0]["whole"].tobytes()
    # disjoint row blocks, every row once
    rows = [r["rows"] for r in out]
    assert sum(rows) == N_ROWS and max(rows) - min(rows) <= 1


def test_shard_rows_service_answers_like_booster_predict(gang):
    size, out = gang
    for r in out:
        assert r["served"].ravel().tobytes() == r["whole"][:1024].ravel().tobytes()
    assert sum(r["served_rows"] for r in out) == 1024  # the service's batch was split


def test_raw_scores_match_jax_sharded_predict(jax_ref, monkeypatch, gang, model_text):
    from lightgbm_tpu.models.serialize import GBDTModel
    from lightgbm_tpu.ops.predict import pack_ensemble
    from lightgbm_tpu.parallel.mesh import data_mesh
    from lightgbm_tpu.parallel.predict import predict_raw_sharded

    size, out = gang
    monkeypatch.setenv("LGBM_TPU_FORCE_MESH_DEVICES", str(size))
    X = np.random.RandomState(5).normal(size=(N_ROWS, N_FEATURES)).astype(np.float32)
    model = GBDTModel.from_string(model_text)
    packed = pack_ensemble(model.trees)
    ref = predict_raw_sharded(packed, X, 1, mesh=data_mesh())[:, 0]
    port = lt.Booster(model_str=model_text, params={"device_type": "cpu"})
    raw = port.predict(X, raw_score=True)
    np.testing.assert_array_equal(raw, ref)
    # the gang's (converted) predictions are this raw score's
    np.testing.assert_array_equal(out[0]["whole"], port.predict(X))


def test_no_sharding_out_of_a_gang():
    assert not ppredict.sharded_predict_enabled(10 ** 7)
    assert not ppredict.sharded_predict_enabled(10, min_rows=1)  # one process: nothing to split
    assert not ppredict.sharded_predict_enabled(10 ** 7, min_rows=10)
