"""The port's prediction service and HTTP front, on the CPU.

The model is built with the port's own Tree API (no JAX). Every answer
must be bit-equal to Booster.predict on the same rows, whichever batch the
request rode in.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu_torch import Booster, tracing
from lightgbm_tpu_torch.models.synthetic import make_rows, random_model
from lightgbm_tpu_torch.serving import PredictionService, serve, wire
from lightgbm_tpu_torch.serving.registry import ModelEntry

N_FEATURES = 8


@pytest.fixture(scope="module")
def model_text():
    return random_model(np.random.RandomState(0), N_FEATURES, 8, 15,
                        num_class=3, cat_features=(2,),
                        objective="multiclass num_class:3").to_string()


@pytest.fixture
def server():
    svc = PredictionService(device="cpu", max_batch_rows=256, min_bucket=16,
                            batch_window_s=0.002)
    srv, thread = serve(svc, port=0)
    try:
        yield svc, f"http://127.0.0.1:{srv.port}"
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)


def _call(url, body=None, method="POST", ctype="application/json"):
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def _load(base, text, **extra):
    return _call(base + "/models", {"name": "m", "model_str": text, **extra})


def test_concurrent_json_and_wire_bit_equal(server, model_text):
    svc, base = server
    status, _, body = _load(base, model_text)
    assert status == 200, body
    assert json.loads(body)["version"] == 1
    booster = Booster(model_str=model_text, params={"device_type": "cpu"})
    X = make_rows(np.random.RandomState(1), 24 * 16, N_FEATURES, (2,))
    answers = [None] * 24

    def client(i):
        rows = X[i * 16:(i + 1) * 16]
        raw = bool(i % 3 == 0)
        if i % 2:
            status, ctype, body = _call(base + "/predict",
                                        wire.encode_request("m", rows, raw),
                                        ctype=wire.CONTENT_TYPE)
            assert status == 200 and ctype == wire.CONTENT_TYPE, body
            preds = wire.decode_response(body)[0]
        else:
            # NaN is not JSON: missing values travel as null -> NaN
            payload = [[None if np.isnan(v) else float(v) for v in r] for r in rows]
            status, _, body = _call(base + "/predict", {
                "model": "m", "rows": payload, "raw_score": raw})
            assert status == 200, body
            preds = np.asarray(json.loads(body)["predictions"], dtype=np.float32)
        answers[i] = (preds, raw)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i, (preds, raw) in enumerate(answers):
        want = booster.predict(X[i * 16:(i + 1) * 16], raw_score=raw)
        np.testing.assert_array_equal(preds, want, err_msg=f"request {i}")
    status, _, body = _call(base + "/healthz", method="GET")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, _, body = _call(base + "/readyz", method="GET")
    assert status == 200 and json.loads(body)["ready"]
    stats = json.loads(_call(base + "/statz", method="GET")[2])
    assert stats["batcher"]["requests"] == 24
    assert "device" in stats["stages"]


def test_bad_upload_rejected_old_version_keeps_serving(server, model_text):
    svc, base = server
    assert _load(base, model_text)[0] == 200
    X = make_rows(np.random.RandomState(2), 4, N_FEATURES, (2,))
    before = svc.predict("m", X)
    truncated = model_text[: len(model_text) // 2]
    status, _, body = _load(base, truncated)
    assert status == 400 and json.loads(body)["error"] == "model_load_error"
    status, _, body = _load(base, model_text, expected_sha256="0" * 64)
    assert status == 400 and json.loads(body)["error"] == "model_load_error"
    assert svc.registry.rejected_uploads == 2
    assert svc.registry.get("m").version == 1
    np.testing.assert_array_equal(svc.predict("m", X), before)
    wrong_width = {"model": "m", "rows": [[0.0] * (N_FEATURES + 1)]}
    assert _call(base + "/predict", wrong_width)[0] == 400
    assert _call(base + "/models/m", method="DELETE")[0] == 200
    assert _call(base + "/predict", {"model": "m", "rows": [[0.0] * N_FEATURES]})[0] == 404


def test_device_error_fails_the_batch_without_host_retry(server, model_text,
                                                         monkeypatch):
    svc, base = server
    # the dump rate limit is per process: a batcher_exception dumped by an
    # earlier test file in this process must not hold this one back
    tracing.reset()
    assert _load(base, model_text)[0] == 200
    calls = []

    def broken(self, X, raw_score):
        calls.append(X.shape[0])
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(ModelEntry, "predict", broken)
    status, _, body = _call(base + "/predict", {
        "model": "m", "rows": [[0.5] * N_FEATURES] * 3})
    assert status == 500, body
    assert "injected device fault" in json.loads(body)["detail"]
    assert calls == [3]  # one dispatch, no second try anywhere
    assert svc.batcher.stats()["device_failures"] == 1
    dump = tracing.last_dump()
    assert dump["reason"] == "batcher_exception"
    assert any(e["kind"] == "batcher_exception" and e["requests"] == 1
               for e in dump["events"])
