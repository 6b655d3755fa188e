"""Stdlib HTTP front for PredictionService.

ThreadingHTTPServer (one thread per connection) is deliberate: request
threads only validate + enqueue + wait, so the thread-per-connection model
costs idle waiters, not device contention — every dispatch still funnels
through the batcher's single worker. No framework, no new dependency.

    POST   /predict          {"model", "rows", "raw_score"?, "timeout_ms"?}
                             Content-Type negotiated: application/json (the
                             compatibility path, bit-identical to before) or
                             application/x-lgbm-wire (serving/wire.py binary
                             framing — zero-copy numpy decode, raw float32
                             response block)
    GET    /models           registered models + versions
    POST   /models           {"name", "path"|"model_str", "expected_sha256"?,
                              "reject_nonfinite"?}  -> staged verified swap
    DELETE /models/<name>    unload
    GET    /healthz          liveness + breaker/queue detail (always 200)
    GET    /readyz           200 once a model is loaded, else 503
    GET    /statz            batcher/breaker/registry/replica counters + the
                             per-stage request-path quantiles
    GET    /metrics          Prometheus text exposition (exposition.py):
                             telemetry signals + global_timer counters +
                             the numeric /statz figures as serve_* gauges
    GET    /debug/flight     on-demand flight-recorder dump (JSON; also
                             written to the flight dir when one resolves)

Every error is JSON `{"error": <code>, "detail": <msg>}` with the typed
status from serving/errors.py; Overloaded responses carry Retry-After.

Trace context: /predict honors an inbound W3C ``traceparent`` header
(malformed ones start a fresh trace, per spec), threads the request span
through the batcher stage marks, and echoes a ``traceparent`` naming the
request's own span id on the success response.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from .. import tracing
from ..utils.log import Log
from . import wire
from .errors import InvalidRequest, Overloaded, ServingError
from .service import PredictionService

MAX_BODY_BYTES = 64 * 1024 * 1024


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog is 5: a fleet of clients
    # connecting at once gets connection RESETS, not queueing. Size the
    # backlog for a connection storm instead.
    request_queue_size = 128

    def __init__(self, service: PredictionService, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        super().__init__((host, port), _Handler)
        self.service = service

    @property
    def port(self) -> int:
        return self.server_address[1]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Nagle + delayed-ACK interact badly with the header/body write pair
    # on keep-alive connections: a closed-loop client sees ~40 ms stalls
    # per response. Predictions are latency-sensitive; flush immediately.
    disable_nagle_algorithm = True

    # BaseHTTPRequestHandler logs every request to stderr by default;
    # route through the package logger at debug level instead
    def log_message(self, fmt: str, *args: Any) -> None:
        Log.debug("serving-http: " + fmt % args)

    @property
    def service(self) -> PredictionService:
        return self.server.service  # type: ignore[attr-defined]

    # ---------------------------------------------------------------- io

    def _send_json(self, status: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error(self, exc: Exception) -> None:
        if isinstance(exc, ServingError):
            headers = {"Retry-After": "1"} if isinstance(exc, Overloaded) \
                else None
            self._send_json(exc.status,
                            {"error": exc.code, "detail": str(exc)}, headers)
        else:
            self._send_json(500, {"error": "internal_error",
                                  "detail": str(exc)})

    def _send_text(self, status: int, body: str, content_type: str) -> None:
        raw = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_wire(self, status: int, body: bytes,
                   headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", wire.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise InvalidRequest("missing request body")
        if length > MAX_BODY_BYTES:
            raise InvalidRequest(
                f"request body of {length} bytes exceeds the "
                f"{MAX_BODY_BYTES}-byte limit")
        return self.rfile.read(length)

    def _read_json(self) -> Dict[str, Any]:
        try:
            payload = json.loads(self._read_body())
        except (ValueError, UnicodeDecodeError) as exc:
            raise InvalidRequest(f"body is not valid JSON: {exc}")
        if not isinstance(payload, dict):
            raise InvalidRequest("body must be a JSON object")
        return payload

    # ------------------------------------------------------------ routing

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        try:
            if self.path == "/healthz":
                self._send_json(200, self.service.healthz())
            elif self.path == "/readyz":
                ready = self.service.readyz()
                self._send_json(200 if ready["ready"] else 503, ready)
            elif self.path == "/statz":
                self._send_json(200, self.service.stats())
            elif self.path == "/models":
                self._send_json(200, {"models": self.service.models()})
            elif self.path == "/metrics":
                self._metrics()
            elif self.path == "/debug/flight":
                self._send_json(200, tracing.build_dump("debug_endpoint"))
                tracing.dump_flight("debug_endpoint", force=True)
            else:
                self._send_json(404, {"error": "not_found",
                                      "detail": self.path})
        except Exception as exc:
            self._send_error(exc)

    def do_POST(self) -> None:  # noqa: N802
        try:
            if self.path == "/predict":
                self._predict()
            elif self.path == "/models":
                self._load_model()
            else:
                self._send_json(404, {"error": "not_found",
                                      "detail": self.path})
        except Exception as exc:
            self._send_error(exc)

    def do_DELETE(self) -> None:  # noqa: N802
        try:
            if self.path.startswith("/models/"):
                name = self.path[len("/models/"):]
                if self.service.unload_model(name):
                    self._send_json(200, {"unloaded": name})
                else:
                    self._send_json(404, {"error": "model_not_found",
                                          "detail": name})
            else:
                self._send_json(404, {"error": "not_found",
                                      "detail": self.path})
        except Exception as exc:
            self._send_error(exc)

    # ----------------------------------------------------------- handlers

    def _predict(self) -> None:
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == wire.CONTENT_TYPE:
            self._predict_wire()
        else:
            self._predict_json()

    def _predict_wire(self) -> None:
        """Binary fast path: one frombuffer decode, no float text on either
        leg. Error responses stay JSON (typed status + error body) so the
        client branches on the response Content-Type."""
        t_parse = time.perf_counter()
        body = self._read_body()
        dec = wire.decode_request(body)
        # the in-frame traceparent wins over the HTTP header: the frame is
        # the unit a wire client retries/forwards, so its context travels
        # with it through any proxy that re-writes headers
        span = tracing.start_span(
            "serve_request",
            traceparent=dec.traceparent or self.headers.get("traceparent"))
        try:
            timeout_s = (dec.timeout_ms / 1000.0
                         if dec.timeout_ms is not None else None)
            span.add_stage("parse", time.perf_counter() - t_parse)
            version = self.service.registry.get(dec.model).version
            t0 = time.monotonic()
            preds = self.service.predict(
                dec.model, dec.rows, raw_score=dec.raw_score,
                timeout_s=timeout_s, span=span)
            t_ser = time.perf_counter()
            self._send_wire(200, wire.encode_response(
                preds, version, (time.monotonic() - t0) * 1000.0),
                headers={"traceparent": span.traceparent()})
            span.add_stage("serialize", time.perf_counter() - t_ser)
        finally:
            span.finish()

    def _predict_json(self) -> None:
        t_parse = time.perf_counter()
        span = tracing.start_span(
            "serve_request", traceparent=self.headers.get("traceparent"))
        try:
            payload = self._read_json()
            model = payload.get("model")
            if not isinstance(model, str) or not model:
                raise InvalidRequest("missing 'model' (string) field")
            if "rows" not in payload:
                raise InvalidRequest("missing 'rows' field")
            timeout_ms = payload.get("timeout_ms")
            timeout_s = float(timeout_ms) / 1000.0 \
                if timeout_ms is not None else None
            span.add_stage("parse", time.perf_counter() - t_parse)
            version = self.service.registry.get(model).version
            t0 = time.monotonic()
            preds = self.service.predict(
                model, payload["rows"],
                raw_score=bool(payload.get("raw_score", False)),
                timeout_s=timeout_s, span=span)
            t_ser = time.perf_counter()
            self._send_json(200, {
                "model": model,
                "version": version,
                "predictions": preds.tolist(),
                "latency_ms": round((time.monotonic() - t0) * 1000.0, 3),
                "trace_id": span.trace_id,
            }, headers={"traceparent": span.traceparent()})
            span.add_stage("serialize", time.perf_counter() - t_ser)
        finally:
            # idempotent: a shed request was already finished (terminal
            # `shed`) inside the batcher — this records everyone else
            span.finish()

    def _metrics(self) -> None:
        from ..exposition import CONTENT_TYPE, render_metrics

        # the numeric /statz figures flattened into serve_* gauges, so one
        # scrape carries the batcher, breaker and replica state beside the
        # telemetry counter namespace
        extra: Dict[str, Any] = {}

        def flatten(prefix: str, obj: Any) -> None:
            if isinstance(obj, dict):
                for k, v in obj.items():
                    flatten(f"{prefix}_{k}", v)
            elif isinstance(obj, bool):
                extra[prefix] = int(obj)
            elif isinstance(obj, (int, float)):
                extra[prefix] = obj

        flatten("serve", self.service.stats())
        self._send_text(200, render_metrics(extra), CONTENT_TYPE)

    def _load_model(self) -> None:
        payload = self._read_json()
        name = payload.get("name")
        if not isinstance(name, str) or not name:
            raise InvalidRequest("missing 'name' (string) field")
        info = self.service.load_model(
            name, path=payload.get("path"),
            model_str=payload.get("model_str"),
            expected_sha256=payload.get("expected_sha256"),
            reject_nonfinite=bool(payload.get("reject_nonfinite", False)),
            shard_rows=payload.get("shard_rows"))
        self._send_json(200, info)


def serve(service: PredictionService, host: str = "127.0.0.1",
          port: int = 0) -> Tuple[ServingHTTPServer, threading.Thread]:
    """Start the HTTP front on a daemon thread; returns (server, thread).
    port=0 binds an ephemeral port (read it back from server.port)."""
    server = ServingHTTPServer(service, host=host, port=port)
    thread = threading.Thread(target=server.serve_forever,
                              name="lgbm-serve-http", daemon=True)
    thread.start()
    Log.info("serving: HTTP front listening on %s:%d",
             server.server_address[0], server.port)
    return server, thread
