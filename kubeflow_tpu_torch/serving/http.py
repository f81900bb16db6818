"""REST front end: the port of kubeflow_tpu/serving/http.py.

The same wire contract: ``POST /model/NAME:predict`` (and
``/model/NAME/version/N:predict``) takes ``{"instances": [...]}`` and
answers ``{"predictions": [...]}``; ``:classify`` (both forms) takes the
same body and answers ``{"result": {"classifications": [[[class,
score], ...], ...]}}``; ``GET /model/NAME:metadata`` returns
the exported signature; ``GET /model/NAME:stats`` the batching plane's
live stats (the decode engine's ``stats()``, a batcher's dispatch
profile, or null on the direct path); ``/healthz`` is liveness and
``/readyz`` readiness (503 while draining).  Typed errors map to
404/400/429/504, and a feature not ported yet (``NotPortedError``) to
501.  stdlib ``http.server`` (threaded), one process.

Not ported yet: :generate streaming, :prefill and :fetch_kv (ROADMAP
queue 1, item 2); /metrics and /debug/traces (item 9).
"""

from __future__ import annotations

import base64
import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from kubeflow_tpu_torch.serving.model_server import ModelServer

log = logging.getLogger(__name__)

WELCOME = "kubeflow-tpu model server"

_ROUTES = [
    ("GET", re.compile(r"^/model/(?P<name>[^/:]+):metadata$"), "metadata"),
    ("GET", re.compile(r"^/model/(?P<name>[^/:]+):stats$"), "stats"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):predict$"), "predict"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):classify$"), "classify"),
    ("POST", re.compile(
        r"^/model/(?P<name>[^/:]+)/version/(?P<version>\d+):predict$"),
     "predict"),
    ("POST", re.compile(
        r"^/model/(?P<name>[^/:]+)/version/(?P<version>\d+):classify$"),
     "classify"),
    ("GET", re.compile(r"^/$"), "index"),
    ("GET", re.compile(r"^/healthz$"), "health"),
    ("GET", re.compile(r"^/readyz$"), "ready"),
]


def parse_deadline_ms(body: Dict[str, Any]) -> Optional[float]:
    """``deadline_ms`` body key -> absolute time.monotonic() instant."""
    deadline_ms = body.get("deadline_ms")
    if deadline_ms is None:
        return None
    try:
        deadline_ms = float(deadline_ms)
    except (TypeError, ValueError):
        raise ValueError(
            f"deadline_ms must be a number, got {deadline_ms!r}") from None
    if not math.isfinite(deadline_ms) or deadline_ms <= 0:
        raise ValueError(f"deadline_ms must be a positive finite number, "
                         f"got {deadline_ms}")
    return time.monotonic() + deadline_ms / 1e3


def decode_b64_if_needed(value: Any) -> Any:
    """Recursively decode {"b64": "..."} leaves to uint8 arrays."""
    if isinstance(value, dict):
        if len(value) == 1 and "b64" in value:
            return np.frombuffer(base64.b64decode(value["b64"]),
                                 dtype=np.uint8)
        return {k: decode_b64_if_needed(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_b64_if_needed(v) for v in value]
    return value


def instances_to_inputs(
    instances: List[Any], input_names: Optional[List[str]] = None
) -> Dict[str, np.ndarray]:
    """Column-ize row-major instances.  Non-dict rows bind to the
    signature's sole input."""
    if not isinstance(instances, (list, tuple)) or not instances:
        raise ValueError("'instances' must be a non-empty list")
    first = instances[0]
    if isinstance(first, dict):
        return {c: np.stack([np.asarray(row[c]) for row in instances])
                for c in first}
    if input_names and len(input_names) == 1:
        name = input_names[0]
    else:
        raise ValueError("non-dict instances require a single-input signature")
    return {name: np.stack([np.asarray(row) for row in instances])}


def outputs_to_predictions(outputs: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Row-ize output columns back to per-instance dicts."""
    arrays = {k: np.asarray(v) for k, v in outputs.items()}
    n = next(iter(arrays.values())).shape[0]
    return [{k: v[i].tolist() for k, v in arrays.items()} for i in range(n)]


class ServingAPI:
    """Transport-independent request handling (shared by tests + HTTP)."""

    def __init__(self, server: ModelServer):
        self.server = server

    def metadata(self, name: str) -> Dict[str, Any]:
        model = self.server.get(name)
        return {
            "model_spec": {"name": name, "version": str(model.version)},
            "metadata": {
                "signature": model.meta.get("signature", {}),
                "loader": model.meta.get("loader"),
            },
        }

    def stats(self, name: str) -> Dict[str, Any]:
        """Live batching-plane stats for one model: the DecodeEngine's
        occupancy, throughput, latency and prefix-cache counters, or a
        batcher's dispatch profile (null on the direct path)."""
        model = self.server.get(name)  # 404 on unknown names
        return {
            "model_spec": {"name": name, "version": str(model.version)},
            "batcher": self.server.batcher_stats(name),
        }

    def predict(self, name: str, body: Dict[str, Any],
                version: Optional[int] = None) -> Dict[str, Any]:
        instances = body.get("instances")
        if instances is None:
            raise ValueError(
                "Request json object must use the key: instances")
        deadline = parse_deadline_ms(body)
        instances = decode_b64_if_needed(instances)
        model = self.server.get(name, version)
        sig_inputs = list(
            model.meta.get("signature", {}).get("inputs", []) or [])
        inputs = instances_to_inputs(instances, sig_inputs or None)
        outputs = self.server.predict(name, inputs, version,
                                      deadline=deadline)
        return {"predictions": outputs_to_predictions(outputs)}

    def classify(self, name: str, body: Dict[str, Any],
                 version: Optional[int] = None) -> Dict[str, Any]:
        """Classification response: ``[[class_id, score], ...]`` per
        instance (TF-Serving's ClassificationResult): the top k where the
        model gives it, else every class in order."""
        result = self.predict(name, body, version)
        classifications = []
        for row in result["predictions"]:
            if "top_k_classes" in row:
                pairs = [[str(c), float(s)] for c, s in
                         zip(row["top_k_classes"], row["top_k_scores"])]
            else:
                pairs = [[str(i), float(s)]
                         for i, s in enumerate(row.get("scores", []))]
            classifications.append(pairs)
        return {"result": {"classifications": classifications}}


class _Handler(BaseHTTPRequestHandler):
    api: ServingAPI  # set by make_http_server

    # Keep-alive is safe: every response carries Content-Length.
    protocol_version = "HTTP/1.1"
    _PROBE_PATHS = ("/healthz", "/readyz")

    def log_message(self, fmt, *args):
        log.debug("http: " + fmt, *args)

    def _dispatch(self, method: str) -> None:
        # Bracket the whole dispatch, body read included, in the server's
        # in-flight count; probes are not work a drain waits for.
        if self.path in self._PROBE_PATHS:
            self._dispatch_inner(method)
            return
        self.api.server.enter_request()
        try:
            self._dispatch_inner(method)
        finally:
            self.api.server.exit_request()

    def _dispatch_inner(self, method: str) -> None:
        for m, pattern, action in _ROUTES:
            if m != method:
                continue
            match = pattern.match(self.path)
            if not match:
                continue
            try:
                self._run(action, match.groupdict())
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Overloaded as e:
                self._send(429, {"error": str(e)},
                           headers={"Retry-After":
                                    f"{max(1, round(e.retry_after_s))}"})
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e)})
            except NotImplementedError as e:
                self._send(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- serving must not die
                log.exception("handler error")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        # Drain an unrouted request's body first: with keep-alive an
        # unread body would be parsed as the next request line.
        length = int(self.headers.get("Content-Length", 0))
        if length:
            self.rfile.read(length)
        self._send(404, {"error": f"no route for {method} {self.path}"})

    def _run(self, action: str, groups: Dict[str, str]) -> None:
        server = self.api.server
        if action == "index":
            self._send(200, WELCOME, raw=True)
        elif action == "health":
            self._send(200, {"status": "ok", "models": server.models()})
        elif action == "ready":
            if server.is_ready():
                self._send(200, {"status": "ready",
                                 "models": server.models()})
            else:
                self._send(503, {"status": "draining" if server.draining()
                                 else "no models loaded"})
        elif action == "metadata":
            self._send(200, self.api.metadata(groups["name"]))
        elif action == "stats":
            self._send(200, self.api.stats(groups["name"]))
        else:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            version = int(groups["version"]) if groups.get("version") \
                else None
            handler = (self.api.classify if action == "classify"
                       else self.api.predict)
            self._send(200, handler(groups["name"], body, version))

    def _send(self, code: int, payload: Any, raw: bool = False,
              headers: Optional[Dict[str, str]] = None) -> None:
        data = (payload if raw else json.dumps(payload)).encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain" if raw else "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_http_server(
    model_server: ModelServer, port: int = 8000, host: str = "0.0.0.0",
) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Build and start the REST server on a daemon thread; returns
    (httpd, thread).  Port 0 binds an ephemeral port."""
    handler = type("BoundHandler", (_Handler,),
                   {"api": ServingAPI(model_server)})
    httpd = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="serving-http")
    thread.start()
    return httpd, thread
