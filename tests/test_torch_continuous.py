"""The continuous-training flywheel (streaming/continuous.py) on the CPU.

Contracts, each the JAX package's (tests/test_streaming.py) in the port:

* a kill mid-refit, rows still landing, then a retried step: the pinned
  watermark's rows train from the generation checkpoint to a model text
  byte-equal to the uninterrupted run, and to the JAX trainer's on snapped
  gradients;
* no refit below `min_new_rows`;
* generations hot-swap into a PredictionService under concurrent predicts
  with no failed request; the refit event's generation is the sidecar's;
* a poisoned generation is rejected by the holdout gate and never answers;
* a canaried generation promotes after its window and rolls back under
  breaker pressure;
* a bin refresh, then a kill, then the resume: byte-equal to the clean run,
  the sidecar's `bin_mapper_generation` 1;
* a lost worker rolls the generation back and keeps serving.

Every thread is joined with a timeout that fails the test.
"""
import threading

import numpy as np
import pytest

from lightgbm_tpu_torch import telemetry
from lightgbm_tpu_torch.checkpoint import read_sidecar_manifest
from lightgbm_tpu_torch.parallel import WorkerLostError
from lightgbm_tpu_torch.serving import PredictionService
from lightgbm_tpu_torch.streaming import ContinuousTrainer, RowBlockStore
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.faults import InjectedFault
from lightgbm_tpu_torch.utils.timer import global_timer
from tests.test_torch_dart_rf import _op_by_op
from tests.test_torch_ref import jax_ref  # noqa: F401
from tests.test_torch_train import snapped_logloss

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "verbosity": -1,
        "min_data_in_leaf": 5, "device_type": "cpu"}
JOIN_S = 120


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()


def _data(seed=3, n=800, f=12):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.standard_normal(n) * 0.3 > 0)
    return X, y.astype(np.float64)


def _chunks(seed=3, n=2048, f=8, shift_from=None):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float64)
    if shift_from is not None:
        X[shift_from:, 0] = X[shift_from:, 0] * 3.0 + 10.0
    return X, y


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def _service():
    return PredictionService(device="cpu", max_batch_rows=512, batch_window_s=0.0005)


def _kill_and_resume(store_cls, trainer_cls, faults_mod, params, tmp_path, tag):
    X, y = _data()

    def filled():
        s = store_cls(params=params)
        for lo in range(0, 600, 200):
            s.push_rows(X[lo:lo + 200], label=y[lo:lo + 200])
        return s

    straight = trainer_cls(params, filled(), num_boost_round=6,
                           checkpoint_dir=str(tmp_path / f"{tag}_clean")).refit()
    store = filled()
    crashy = trainer_cls(params, store, num_boost_round=6,
                         checkpoint_dir=str(tmp_path / f"{tag}_crashy"))
    faults_mod.install("kill@3")
    with pytest.raises(Exception, match="kill at iteration 3"):
        crashy.step()
    faults_mod.clear()
    assert crashy.generation == 0
    store.push_rows(X[600:], label=y[600:])  # rows land while the refit is down
    resumed = crashy.step()
    assert crashy.generation == 1
    second = crashy.step()  # the next generation takes the new rows
    assert second is not None and crashy.generation == 2
    return straight, resumed, second


def test_kill_and_resume_byte_equal_while_pushes_land(tmp_path):
    straight, resumed, second = _kill_and_resume(RowBlockStore, ContinuousTrainer, faults,
                                                 dict(BASE), tmp_path, "port")
    assert resumed.model_to_string() == straight.model_to_string()
    assert second.model_to_string() != straight.model_to_string()


def test_kill_and_resume_byte_equal_to_jax(jax_ref, monkeypatch, tmp_path):
    from lightgbm_tpu.streaming import ContinuousTrainer as JaxTrainer
    from lightgbm_tpu.streaming import RowBlockStore as JaxStore
    from lightgbm_tpu.utils import faults as jax_faults

    params = {**BASE, "objective": snapped_logloss}
    ours = _kill_and_resume(RowBlockStore, ContinuousTrainer, faults, params, tmp_path, "port")
    _op_by_op(monkeypatch)
    theirs = _kill_and_resume(JaxStore, JaxTrainer, jax_faults, params, tmp_path, "jax")
    assert ours[1].model_to_string() == ours[0].model_to_string()
    for a, b in zip(ours, theirs):
        assert a.model_to_string() == b.model_to_string()


def test_no_refit_below_min_new_rows():
    X, y = _data(n=400)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X, label=y)
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=2, min_new_rows=100)
    assert tr.step() is not None  # the first call always fits
    assert tr.step() is None
    store.push_rows(X[:50], label=y[:50])
    assert tr.step() is None
    store.push_rows(X[50:150], label=y[50:150])
    assert tr.step() is not None and tr.generation == 2


def test_hot_swap_with_zero_failed_predicts():
    X, y = _data(n=700, f=6)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X[:300], label=y[:300])
    svc = _service()
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=3, service=svc,
                           model_name="live")
    try:
        tr.refit()
        failures, answers, done = [], [], threading.Event()

        def hammer():
            while not done.is_set():
                try:
                    answers.append(svc.predict("live", X[:16], raw_score=True))
                except Exception as e:  # noqa: BLE001 - what the test counts
                    failures.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        boosters = [tr.booster]
        for lo in (300, 500):
            store.push_rows(X[lo:lo + 200], label=y[lo:lo + 200])
            boosters.append(tr.step())
        done.set()
        _join(threads)
    finally:
        svc.close()
    assert failures == [] and answers
    assert tr.generation == 3 and svc.registry.get("live").version == 3
    # every answer is one generation's Booster.predict, bit for bit
    wants = [b.predict(X[:16], raw_score=True) for b in boosters]
    assert all(any(np.array_equal(a, w) for w in wants) for a in answers)


def test_refit_event_generation_is_the_sidecars(tmp_path):
    X, y = _data(n=512)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X, label=y)
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=2,
                           checkpoint_dir=str(tmp_path))
    with telemetry.capture(None, label="gen-test", watch_compiles=False) as sess:
        assert tr.step() is not None
    events = [e for e in sess.events if e.get("ev") == "stream_refit"]
    assert len(events) == 1
    manifest = read_sidecar_manifest(tr.checkpoint_path(0))
    assert events[0]["generation"] == manifest["stream_generation"] == 0
    assert manifest["bin_mapper_generation"] == 0
    assert global_timer.counters["stream_generation"] == 0
    assert tr.generation == 1


def test_bad_generation_rejected_and_never_serves(tmp_path):
    X, y = _chunks(n=2048, f=6)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X[:1024], label=y[:1024])
    svc = _service()
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=3, service=svc,
                           model_name="live", checkpoint_dir=str(tmp_path),
                           holdout_rows=256, gate_tolerance=0.1)
    try:
        with telemetry.capture(None, label="gate-test", watch_compiles=False) as sess:
            tr.step()
            expected = svc.predict("live", X[:16], raw_score=True)
            faults.install("bad_generation@1")
            store.push_rows(X[1024:], label=y[1024:])
            failures, done = [], threading.Event()

            def hammer():
                while not done.is_set():
                    try:
                        if not np.array_equal(svc.predict("live", X[:16], raw_score=True),
                                              expected):
                            failures.append("an answer not from the serving model")
                    except Exception as e:  # noqa: BLE001 - what the test counts
                        failures.append(repr(e))

            threads = [threading.Thread(target=hammer) for _ in range(3)]
            for t in threads:
                t.start()
            rejected = tr.step()
            done.set()
            _join(threads)
            assert rejected is None and failures == []
            assert tr.generation == 1 and svc.registry.get("live").version == 1
            assert global_timer.counters["stream_generation_rejected"] >= 1
            events = [e for e in sess.events if e.get("ev") == "generation_rejected"]
            assert events and events[-1]["generation"] == 1
            assert events[-1]["candidate_loss"] > events[-1]["serving_loss"]
            # the retry resumes the checkpointed, clean model and passes
            assert tr.step() is not None
            assert tr.generation == 2 and svc.registry.get("live").version == 2
    finally:
        svc.close()


def test_canary_promotes_then_rolls_back():
    X, y = _data(n=900, f=6)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X[:300], label=y[:300])
    svc = _service()
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=2, service=svc,
                           model_name="m", canary_fraction=0.5, canary_promote_after=3)
    try:
        first = tr.step()  # nothing serves yet: a plain load
        assert svc.registry.get("m").version == 1 and not svc.canary_info()["active"]
        store.push_rows(X[300:600], label=y[300:600])
        second = tr.step()
        assert svc.canary_info()["active"]
        for _ in range(12):
            assert svc.predict("m", X[:8], raw_score=True).shape == (8,)
        info = svc.canary_info()
        assert not info["active"] and info["promoted"] == 1
        assert np.array_equal(svc.predict("m", X[:8], raw_score=True),
                              second.predict(X[:8], raw_score=True))
        store.push_rows(X[600:], label=y[600:])
        tr.step()
        assert svc.canary_info()["active"]
        svc.breaker.note_signals({"compiles": 0})
        svc.breaker.note_signals({"compiles": 100})  # churn: the breaker degrades
        assert np.array_equal(svc.predict("m", X[:8], raw_score=True),
                              second.predict(X[:8], raw_score=True))
        info = svc.canary_info()
        assert not info["active"] and info["rolled_back"] == 1
        assert first is not second
    finally:
        svc.close()


def test_refresh_then_kill_then_resume_byte_equal(monkeypatch, tmp_path):
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    monkeypatch.setenv("LGBM_TPU_DRIFT_CHECK_ROWS", "256")

    def run(kill):
        X, y = _chunks(n=2560, shift_from=1024)
        store = RowBlockStore(params=dict(BASE), bin_sample_rows=1024)
        tr = ContinuousTrainer(dict(BASE), store, num_boost_round=6,
                               checkpoint_dir=str(tmp_path / ("crashy" if kill else "clean")))
        store.push_rows(X[:1024], label=y[:1024])
        assert tr.step() is not None
        for lo in range(1024, 2560, 256):
            store.push_rows(X[lo:lo + 256], label=y[lo:lo + 256])
        assert store._drift.alarmed
        if kill:
            faults.install("kill@3")
            with pytest.raises(InjectedFault):
                tr.step()  # the refresh and the pin happened, then training died
            faults.clear()
            assert store.layout_generation == 1
        booster = tr.step()
        return (booster.model_to_string(), store.layout_generation,
                read_sidecar_manifest(tr.checkpoint_path(1)))

    clean_text, clean_gen, _ = run(kill=False)
    crash_text, crash_gen, manifest = run(kill=True)
    assert clean_gen == crash_gen == 1
    assert manifest["bin_mapper_generation"] == 1 and manifest["stream_generation"] == 1
    assert crash_text == clean_text


def test_scheduled_refresh_at_a_generation_boundary(monkeypatch, tmp_path):
    monkeypatch.setenv("LGBM_TPU_DRIFT", "1")
    X, y = _chunks(n=2048)
    store = RowBlockStore(params=dict(BASE), bin_sample_rows=512)
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=2,
                           checkpoint_dir=str(tmp_path), refresh_every=1)
    store.push_rows(X[:1024], label=y[:1024])
    assert tr.step() is not None
    assert read_sidecar_manifest(tr.checkpoint_path(0))["bin_mapper_generation"] == 0
    store.push_rows(X[1024:], label=y[1024:])
    assert tr.step() is not None
    assert store.layout_generation == 1
    man = read_sidecar_manifest(tr.checkpoint_path(1))
    assert man["stream_generation"] == 1 and man["bin_mapper_generation"] == 1


def test_lost_worker_rolls_the_generation_back(monkeypatch):
    from lightgbm_tpu_torch import engine

    X, y = _data(n=600)
    store = RowBlockStore(params=dict(BASE))
    store.push_rows(X[:400], label=y[:400])
    tr = ContinuousTrainer(dict(BASE), store, num_boost_round=2)
    assert tr.step() is not None
    store.push_rows(X[400:], label=y[400:])
    real_train = engine.train

    def lost(*args, **kwargs):
        raise WorkerLostError("peer gone", rank=1, last_good_iteration=1)

    monkeypatch.setattr(engine, "train", lost)
    lost_before = global_timer.counters.get("stream_refit_worker_lost", 0)
    assert tr.step() is None
    assert tr.generation == 1 and tr._inflight_rows == 600
    assert global_timer.counters["stream_refit_worker_lost"] == lost_before + 1
    monkeypatch.setattr(engine, "train", real_train)
    assert tr.step() is not None and tr.generation == 2
