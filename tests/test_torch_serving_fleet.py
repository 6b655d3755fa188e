"""The rest of serving in the port, on the CPU: replicas, the staged
canary, the breaker's shedding, /metrics and /debug/flight.

Contracts:

* every served answer is bit-equal to Booster.predict, through replicas
  on concurrent threads and through the canary;
* replica placement is round-robin, sticky and forgotten at unload;
* the canary gets exactly the requests the JAX package's rule sends it
  (every round(1/fraction)-th request of the model): the same routing as
  the JAX PredictionService on the same request sequence;
* the mirror of the JAX package's tests/test_serving.py:408
  (test_fault_injected_serving_scenario): a slow chunk with a deadline
  behind it, a corrupt upload rejected while the prior version serves,
  dispatch failures that fail their batches and open the breaker, an OPEN
  breaker shedding with a typed 503 (BreakerOpen) where the JAX package
  answers on the host, recovery through a half-open probe; every failure
  and every shed request is counted on /statz, /metrics and /healthz;
* a model whose traversal cannot launch fails its load and never serves.
"""
import hashlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import exposition, telemetry, tracing
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.serving import (BreakerOpen, CircuitBreaker, DeadlineExceeded,
                                        InvalidRequest, ModelLoadError, PredictionService,
                                        ServingError, serve)
from lightgbm_tpu_torch.serving.breaker import CLOSED, OPEN
from lightgbm_tpu_torch.serving.registry import ModelEntry
from lightgbm_tpu_torch.utils import faults
from tests.test_torch_ref import jax_ref  # noqa: F401

N_FEATURES = 10
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
          "verbosity": -1, "min_data_in_leaf": 5, "device_type": "cpu"}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.clear()


def _train(seed, col=0, n=500, rounds=8):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, N_FEATURES)
    y = (X[:, col] + X[:, col + 1] > 1.0).astype(np.float64)
    return lt.train(PARAMS, lt.Dataset(X, label=y), num_boost_round=rounds)


def _service(**kw):
    kw.setdefault("batch_window_s", 0.0)
    kw.setdefault("max_batch_rows", 1024)
    return PredictionService(device="cpu", **kw)


def _rows(seed, n):
    return np.ascontiguousarray(np.random.RandomState(seed).rand(n, N_FEATURES),
                                dtype=np.float32)


# ------------------------------------------------------------- replicas


def test_replica_placement_and_aggregate_stats():
    svc = _service(replicas=2)
    try:
        bst0, bst1 = _train(0, 0), _train(1, 3)
        svc.load_model("m0", booster=bst0)
        svc.load_model("m1", booster=bst1)
        placement = svc.stats()["replicas"]["placement"]
        assert placement == {"m0": 0, "m1": 1}
        Q = _rows(2, 25)
        assert np.array_equal(svc.predict("m0", Q, raw_score=True),
                              bst0.predict(Q, raw_score=True))
        assert np.array_equal(svc.predict("m1", Q, raw_score=True),
                              bst1.predict(Q, raw_score=True))
        stats = svc.stats()
        assert [b["requests"] for b in stats["replicas"]["batchers"]] == [1, 1]
        assert stats["batcher"]["requests"] == 2
        health = svc.healthz()
        assert health["status"] == "ok" and health["replicas"] == 2
        assert health["breaker_shed"] == 0 and health["device_failures"] == 0
    finally:
        svc.close()


def test_replica_placement_is_sticky_and_forgotten_on_unload():
    svc = _service(replicas=3)
    try:
        svc.load_model("m0", booster=_train(0))
        first = svc.placement()["m0"]
        for _ in range(4):
            svc.predict("m0", _rows(1, 5))
        assert svc.placement()["m0"] == first
        svc.unload_model("m0")
        assert "m0" not in svc.placement()
    finally:
        svc.close()


def test_replica_concurrent_models_bit_exact():
    svc = _service(replicas=2)
    try:
        boosters = [_train(i, i) for i in range(4)]
        for i, bst in enumerate(boosters):
            svc.load_model(f"m{i}", booster=bst)
        Q = _rows(9, 16)
        want = [b.predict(Q) for b in boosters]
        got, errs = [None] * 4, []

        def fire(i):
            try:
                for _ in range(5):
                    got[i] = svc.predict(f"m{i}", Q)
            except Exception as exc:  # noqa: BLE001 - surfaced below
                errs.append(exc)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        for i in range(4):
            assert np.array_equal(got[i], want[i])
    finally:
        svc.close()


def test_shard_rows_is_refused_by_item():
    svc = _service()
    try:
        with pytest.raises(InvalidRequest, match=r"ROADMAP Queue 1 item 8\)"):
            svc.load_model("m", booster=_train(0), shard_rows=1000)
    finally:
        svc.close()


# --------------------------------------------------------------- canary


def _canary_routes(svc, texts, X, fraction, n_requests, promote_after):
    """Which requests the canary answered: their answers equal the
    candidate's and not the primary's (the two models differ on X)."""
    svc.load_model("m", model_str=texts[0])
    svc.start_canary("m", fraction=fraction, promote_after=promote_after,
                     model_str=texts[1])
    routed = []
    for i in range(n_requests):
        routed.append(svc.predict("m", X[i:i + 1], raw_score=True))
    return routed


@pytest.mark.parametrize("fraction", [0.25, 0.4])
def test_canary_routing_equals_jax(jax_ref, fraction):
    from lightgbm_tpu.serving import PredictionService as JaxService

    rng = np.random.RandomState(5)
    texts = [random_model(rng, N_FEATURES, 6, 7).to_string() for _ in range(2)]
    X = make_rows(np.random.RandomState(6), 40, N_FEATURES)
    primary = lt.Booster(model_str=texts[0], params={"device_type": "cpu"})
    candidate = lt.Booster(model_str=texts[1], params={"device_type": "cpu"})
    p_raw, c_raw = primary.predict(X, raw_score=True), candidate.predict(X, raw_score=True)
    assert not np.any(p_raw == c_raw)
    svc = _service()
    jsvc = JaxService(max_batch_rows=64, min_bucket=64, batch_window_s=0.0)
    try:
        ours = _canary_routes(svc, texts, X, fraction, 40, promote_after=6)
        theirs = _canary_routes(jsvc, texts, X, fraction, 40, promote_after=6)
        ours_c = [bool(np.array_equal(o, c_raw[i:i + 1])) for i, o in enumerate(ours)]
        theirs_c = [bool(np.array_equal(np.asarray(t, dtype=np.float32),
                                        c_raw[i:i + 1]))
                    for i, t in enumerate(theirs)]
        assert ours_c == theirs_c
        every = int(round(1 / fraction))
        # canary turns until promotion, then the promoted candidate throughout
        first_promoted = 6 * every
        assert ours_c == [(i + 1) % every == 0 or i >= first_promoted for i in range(40)]
        for i, o in enumerate(ours):
            assert np.array_equal(o, (c_raw if ours_c[i] else p_raw)[i:i + 1])
        assert svc.canary_info() == {"active": False, "promoted": 1, "rolled_back": 0}
        assert jsvc.canary_info() == svc.canary_info()
    finally:
        svc.close()
        jsvc.close()


def test_canary_rolls_back_on_breaker_pressure():
    svc = _service()
    try:
        bst0, bst1 = _train(0), _train(1, 3)
        svc.load_model("m", booster=bst0)
        svc.start_canary("m", fraction=0.5, promote_after=100, booster=bst1)
        svc.breaker.note_signals({"compiles": 0})
        svc.breaker.note_signals({"compiles": 100})  # churn: DEGRADED
        Q = _rows(3, 4)
        assert np.array_equal(svc.predict("m", Q), bst0.predict(Q))
        info = svc.canary_info()
        assert not info["active"] and info["rolled_back"] == 1
        assert "m!canary" not in svc.registry.names()
        assert tracing.last_dump()["reason"] == "canary_rollback"
    finally:
        svc.close()


# ---------------------------------------------------- breaker, faults


def test_fault_injected_serving_scenario(tmp_path):
    """A slow chunk with an expired deadline behind it, a corrupt upload,
    dispatch failures that open the breaker: no crash, the corrupt model
    rejected while the prior version serves, each failed dispatch failing
    its request, the open breaker shedding (BreakerOpen, never an answer
    from the CPU), recovery through a half-open probe, every completed
    response bit-identical."""
    bst = _train(4)
    breaker = CircuitBreaker(fail_threshold=2, probe_successes=1, cooldown_s=0.05)
    svc = _service(breaker=breaker)
    try:
        svc.load_model("m", booster=bst)
        Q = np.random.RandomState(8).rand(40, N_FEATURES)
        expected = bst.predict(Q)

        faults.install("slow_predict@1:0.15")
        t = threading.Thread(target=lambda: svc.predict("m", Q))
        t.start()
        time.sleep(0.02)
        with pytest.raises(DeadlineExceeded):
            svc.predict("m", Q, timeout_s=0.03)
        t.join()
        faults.clear()

        faults.install("model_corrupt_upload")
        with pytest.raises(ModelLoadError):
            svc.load_model("m", model_str=bst.model_to_string(),
                           expected_sha256=hashlib.sha256(
                               bst.model_to_string().encode()).hexdigest())
        faults.clear()
        assert svc.registry.get("m").version == 1
        assert np.array_equal(svc.predict("m", Q), expected)

        faults.install("predict_fail@1:2")
        for _ in range(2):
            with pytest.raises(ServingError, match="injected fault: device dispatch") as err:
                svc.predict("m", Q)
            assert err.value.status == 500
        assert breaker.state == OPEN
        assert svc.healthz()["status"] == "degraded"
        faults.clear()
        with pytest.raises(BreakerOpen) as err:  # OPEN: shed, answered nowhere
            svc.predict("m", Q)
        assert err.value.status == 503
        time.sleep(0.1)
        assert np.array_equal(svc.predict("m", Q), expected)  # the half-open probe
        assert breaker.state == CLOSED

        stats = svc.stats()
        assert stats["batcher"]["device_failures"] == 2
        assert stats["batcher"]["breaker_shed"] == 1
        assert stats["rejected_uploads"] == 1
        health = svc.healthz()
        assert health["status"] == "ok" and health["breaker_shed"] == 1
        assert health["device_failures"] == 2
    finally:
        svc.close()


def test_load_fails_when_the_traversal_cannot_launch(monkeypatch):
    svc = _service()
    try:
        good = _train(0)
        svc.load_model("m", booster=good)

        def broken(self, X, raw_score):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(ModelEntry, "predict", broken)
        with pytest.raises(ModelLoadError, match="failed to launch"):
            svc.load_model("m", booster=_train(1, 3))
        monkeypatch.undo()
        assert svc.registry.get("m").version == 1
        Q = _rows(4, 3)
        assert np.array_equal(svc.predict("m", Q), good.predict(Q))
        assert svc.breaker.info()["transitions"] == 0
    finally:
        svc.close()


def test_signal_poll_degrades_the_breaker():
    svc = _service(signal_poll_s=0.0)
    try:
        svc.load_model("m", booster=_train(0))
        with telemetry.capture(None):
            svc.predict("m", _rows(1, 2))
            for _ in range(svc.breaker.compile_churn_limit):
                telemetry.note_compile("tree_graph", kernel=False)
            svc.predict("m", _rows(1, 2))
        assert svc.breaker.state == "degraded"
    finally:
        svc.close()


# -------------------------------------------------------- the HTTP front


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_metrics_and_debug_flight_over_http():
    bst = _train(0)
    breaker = CircuitBreaker(fail_threshold=1, cooldown_s=60.0)
    svc = _service(breaker=breaker, replicas=2)
    srv, thread = serve(svc, port=0)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        svc.load_model("m", booster=bst)
        Q = _rows(5, 6)
        n = 12
        codes = []
        for i in range(n):
            body = json.dumps({"model": "m", "rows": Q.tolist()}).encode()
            req = urllib.request.Request(base + "/predict", data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            if i == n - 2:
                faults.install("predict_fail@1:1")
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    got = np.asarray(json.loads(resp.read())["predictions"],
                                     dtype=np.float32)
                assert np.array_equal(got, bst.predict(Q))
                codes.append(resp.status)
            except urllib.error.HTTPError as exc:
                codes.append((exc.code, json.loads(exc.read())["error"],
                              exc.headers.get("Retry-After")))
        # the failed dispatch fails its request; the open breaker sheds the next
        assert codes == [200] * (n - 2) + [(500, "internal_error", None),
                                           (503, "breaker_open", "1")]
        status, ctype, text = _get(base + "/metrics")
        assert status == 200 and ctype == exposition.CONTENT_TYPE
        m = exposition.parse_exposition(text.decode())
        assert m[("lgbm_tpu_serve_batcher_requests", ())] == n - 2
        assert m[("lgbm_tpu_serve_batcher_device_failures", ())] == 1
        assert m[("lgbm_tpu_serve_batcher_breaker_shed", ())] == 1
        assert m[("lgbm_tpu_serve_breaker_state", ())] == 2  # open
        assert m[("lgbm_tpu_serve_replicas_count", ())] == 2
        statz = json.loads(_get(base + "/statz")[2])
        assert statz["batcher"]["breaker_shed"] == 1 and statz["breaker"]["state"] == OPEN
        health = json.loads(_get(base + "/healthz")[2])
        assert health["status"] == "degraded" and health["breaker_shed"] == 1
        assert health["device_failures"] == 1
        status, _, dump = _get(base + "/debug/flight")
        dump = json.loads(dump)
        assert status == 200 and dump["reason"] == "debug_endpoint"
        kinds = {e["kind"] for e in dump["events"]}
        assert {"serve_dispatch_failed", "breaker_transition", "span"} <= kinds
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)
