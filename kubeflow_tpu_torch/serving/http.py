"""REST front end: the port of kubeflow_tpu/serving/http.py.

The same wire contract: ``POST /model/NAME:predict`` (and
``/model/NAME/version/N:predict``) takes ``{"instances": [...]}`` and
answers ``{"predictions": [...]}``; ``:classify`` (both forms) takes the
same body and answers ``{"result": {"classifications": [[[class,
score], ...], ...]}}``; ``GET /model/NAME:metadata`` returns
the exported signature; ``GET /model/NAME:stats`` the batching plane's
live stats (the decode engine's ``stats()``, a batcher's dispatch
profile, or null on the direct path); ``/healthz`` is liveness and
``/readyz`` readiness (503 while draining), with the server's ``role``
and, where an engine serves adapters, its resident ``adapters``.
``GET /metrics`` refreshes the server's load gauges and answers the
metrics registry in the Prometheus text format; ``GET /debug/traces``
answers the tail-sampled trace store.  Neither they nor the probes count
as in flight.  Every model route opens a ``server.<route>`` span that
continues a ``traceparent`` header, and counts in
``kft_serving_requests_total`` (model, route, outcome) and
``kft_serving_request_seconds`` (route); only a served model's name
becomes a label value (others read ``_unknown_``).  An
``x-kft-idempotency-key`` header dedups retried POSTs (see
``ModelServer.predict``).
``NAME`` may be ``model@adapter`` on :predict, :generate and :prefill
(an unknown adapter answers 404).
On a decode-engine model, ``POST /model/NAME:generate`` streams chunked
NDJSON (a meta line, ``{"tokens": [...]}`` lines as the engine emits, a
terminal done or error line), and ``POST /model/NAME:prefill`` answers
the prompt's finished KV pages as a wire-encoded ``kv_handoff`` that a
decode tier's :generate body carries; ``POST /model/NAME:fetch_kv``
answers the host spill tier's pages for a prompt in the same form
(``{"kv_handoff": null, "tokens_covered": 0}`` on a miss).  Typed errors
map to 404/400/429/504, and a feature not ported yet
(``NotPortedError``) to 501.  stdlib ``http.server`` (threaded), one
process.

The wire form of a KV page stack is JAX's, byte for byte: ``{"b64",
"shape", "dtype"}`` with the raw little-endian bytes, ``"bfloat16"``
for bf16 pages (written from an int16 view, read back with
``torch.frombuffer``), and ``{"values", "scale"}`` of int8 and float32
stacks for an int8 pool, so a tier of either package can hand pages to
one of the other.
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
import torch

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.serving.adapters import split_model_adapter
from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from kubeflow_tpu_torch.serving.model_server import (
    LATENCY_HELP,
    LATENCY_SECONDS,
    REQUESTS_HELP,
    REQUESTS_TOTAL,
    ModelServer,
)
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

WELCOME = "kubeflow-tpu model server"

_ROUTES = [
    ("GET", re.compile(r"^/model/(?P<name>[^/:]+):metadata$"), "metadata"),
    ("GET", re.compile(r"^/model/(?P<name>[^/:]+):stats$"), "stats"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):predict$"), "predict"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):classify$"), "classify"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):generate$"), "generate"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):prefill$"), "prefill"),
    ("POST", re.compile(r"^/model/(?P<name>[^/:]+):fetch_kv$"), "fetch_kv"),
    ("POST", re.compile(
        r"^/model/(?P<name>[^/:]+)/version/(?P<version>\d+):predict$"),
     "predict"),
    ("POST", re.compile(
        r"^/model/(?P<name>[^/:]+)/version/(?P<version>\d+):classify$"),
     "classify"),
    ("GET", re.compile(r"^/$"), "index"),
    ("GET", re.compile(r"^/healthz$"), "health"),
    ("GET", re.compile(r"^/readyz$"), "ready"),
    ("GET", re.compile(r"^/metrics$"), "metrics"),
    ("GET", re.compile(r"^/debug/traces$"), "traces"),
]

IDEMPOTENCY_HEADER = "x-kft-idempotency-key"


def parse_deadline_ms(body: Dict[str, Any]) -> Optional[float]:
    """``deadline_ms`` body key -> absolute instant on the policy clock
    (``faults.monotonic()``, which the deadline checks downstream read)."""
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
    return faults.monotonic() + deadline_ms / 1e3


# Wire dtype names of the port's pool tensors: the model-dtype pages, and
# an int8 pool's values and float32 scales.
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}
_FROM_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _enc_arr(pages: torch.Tensor) -> Dict[str, Any]:
    """A page stack -> ``{b64, shape, dtype}``; bf16 bytes go out through
    an int16 view."""
    t = pages.detach().to("cpu").contiguous()
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return {"b64": base64.b64encode(raw.tobytes()).decode(),
            "shape": list(t.shape), "dtype": _WIRE_DTYPES[t.dtype]}


def _dec_arr(d: Any) -> torch.Tensor:
    if not isinstance(d, dict) or "b64" not in d:
        raise ValueError("kv_handoff array must be {b64, shape, dtype}")
    try:
        dtype = _FROM_WIRE[str(d["dtype"])]
        raw = bytearray(base64.b64decode(d["b64"]))
        shape = [int(s) for s in d["shape"]]
        if not raw:
            return torch.zeros(shape, dtype=dtype)
        return torch.frombuffer(raw, dtype=dtype).reshape(shape)
    except (ValueError, TypeError, KeyError, RuntimeError) as e:
        raise ValueError(f"malformed kv_handoff array: {e!r}") from None


def encode_kv_handoff(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Engine-form KV handoff (page stacks, DecodeEngine._attach_export or
    fetch_kv) -> JSON wire form, each stack ``{b64, shape, dtype}`` (an
    int8 pool's side ``{"values", "scale"}`` of two).  A router forwards
    it verbatim from a :prefill or :fetch_kv answer into a decode tier's
    :generate body."""
    def enc_side(side):
        if isinstance(side, dict):  # int8: values + scale
            return {"values": _enc_arr(side["values"]),
                    "scale": _enc_arr(side["scale"])}
        return _enc_arr(side)

    return {"block_tokens": int(payload["block_tokens"]),
            "tokens_covered": int(payload["tokens_covered"]),
            "k": enc_side(payload["k"]),
            "v": enc_side(payload["v"])}


def decode_kv_handoff(wire: Any) -> Dict[str, Any]:
    """Wire form -> the engine's import form (CPU tensors; the engine
    validates geometry and dtype against its own pool)."""
    if not isinstance(wire, dict):
        raise ValueError("kv_handoff must be an object")

    def dec_side(side):
        if isinstance(side, dict) and "values" in side:
            return {"values": _dec_arr(side.get("values")),
                    "scale": _dec_arr(side.get("scale"))}
        return _dec_arr(side)

    return {"block_tokens": int(wire.get("block_tokens", 0)),
            "k": dec_side(wire.get("k")),
            "v": dec_side(wire.get("v"))}


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
                version: Optional[int] = None,
                idem_key: Optional[str] = None) -> Dict[str, Any]:
        instances = body.get("instances")
        if instances is None:
            raise ValueError(
                "Request json object must use the key: instances")
        deadline = parse_deadline_ms(body)
        instances = decode_b64_if_needed(instances)
        # A ``model@adapter`` name: the signature is the base model's;
        # ModelServer.predict splits the name again to hand the adapter
        # to the engine's admission.
        model = self.server.get(split_model_adapter(name)[0], version)
        sig_inputs = list(
            model.meta.get("signature", {}).get("inputs", []) or [])
        inputs = instances_to_inputs(instances, sig_inputs or None)
        outputs = self.server.predict(name, inputs, version,
                                      deadline=deadline,
                                      idem_key=idem_key)
        return {"predictions": outputs_to_predictions(outputs)}

    def classify(self, name: str, body: Dict[str, Any],
                 version: Optional[int] = None,
                 idem_key: Optional[str] = None) -> Dict[str, Any]:
        """Classification response: ``[[class_id, score], ...]`` per
        instance (TF-Serving's ClassificationResult): the top k where the
        model gives it, else every class in order."""
        result = self.predict(name, body, version, idem_key=idem_key)
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

    def generate(self, name: str, body: Dict[str, Any]):
        """Streaming generation admission: (meta, iterator) from the
        model's decode engine.  Body keys: ``tokens`` (the prompt),
        optional ``max_new_tokens`` / ``seed`` / ``prompt_len`` /
        ``deadline_ms`` / ``resume_tokens`` (tokens a prior attempt
        delivered), and ``kv_handoff`` (a prefill tier's pages: the
        engine imports them and prefills only the rest)."""
        tokens = body.get("tokens")
        if tokens is None:
            raise ValueError("Request json object must use the key: tokens")
        deadline = parse_deadline_ms(body)
        inputs: Dict[str, Any] = {"tokens": np.asarray(tokens, np.int32)}
        for key in ("max_new_tokens", "seed", "prompt_len",
                    "resume_tokens", "park_kv"):
            if body.get(key) is not None:
                inputs[key] = body[key]
        if body.get("kv_handoff") is not None:
            inputs["kv_handoff"] = decode_kv_handoff(body["kv_handoff"])
        return self.server.generate_stream(name, inputs, deadline=deadline)

    def prefill(self, name: str, body: Dict[str, Any],
                version: Optional[int] = None,
                idem_key: Optional[str] = None) -> Dict[str, Any]:
        """Disaggregated serving, prefill tier: chunk-prefill the prompt
        on the model's engine and answer its finished pages as a wire
        ``kv_handoff``, null when the prompt is too short to cover one
        full page (the caller then takes the untiered path).
        ``idem_key`` is taken for the generic dispatch's sake; prefill
        is pure, so a replay is harmless without dedup."""
        tokens = body.get("tokens")
        if tokens is None:
            raise ValueError("Request json object must use the key: tokens")
        deadline = parse_deadline_ms(body)
        inputs: Dict[str, Any] = {"tokens": np.asarray(tokens, np.int32)}
        for key in ("seed", "prompt_len"):
            if body.get(key) is not None:
                inputs[key] = body[key]
        out = self.server.prefill_handoff(name, inputs, deadline=deadline)
        payload = out.get("kv_handoff")
        return {
            "kv_handoff": None if payload is None
            else encode_kv_handoff(payload),
            "tokens_covered": 0 if payload is None
            else int(payload["tokens_covered"]),
        }

    def fetch_kv(self, name: str, body: Dict[str, Any],
                 version: Optional[int] = None,
                 idem_key: Optional[str] = None) -> Dict[str, Any]:
        """The host spill tier's page fetch: the longest match of the
        prompt in the engine's host tier as a wire ``kv_handoff``, null
        on a miss.  A pure host-memory read, so a replay is harmless."""
        tokens = body.get("tokens")
        if tokens is None:
            raise ValueError("Request json object must use the key: tokens")
        out = self.server.fetch_kv(
            name, {"tokens": np.asarray(tokens, np.int32)})
        payload = out.get("kv_handoff")
        return {
            "kv_handoff": None if payload is None
            else encode_kv_handoff(payload),
            "tokens_covered": int(out.get("tokens_covered", 0)),
        }


class _Handler(BaseHTTPRequestHandler):
    api: ServingAPI  # set by make_http_server

    # Keep-alive is safe: every response carries Content-Length.
    protocol_version = "HTTP/1.1"
    # Pure reads outside the in-flight bracket: a probe or a scrape is
    # not work a drain waits for, and a scrape counted as in flight
    # would report a phantom +1 load.
    _PROBE_PATHS = ("/metrics", "/healthz", "/readyz", "/debug/traces")

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
            # ``role`` advertises the disaggregation tier (prefill,
            # decode or unified) to whatever routes between tiers.
            if server.is_ready():
                body = {"status": "ready", "role": server.role,
                        "models": server.models()}
                # Resident adapters (name, digest, slot, pins) per engine
                # model, for a router's digest-affinity pick.
                adapters = server.adapter_info()
                if adapters:
                    body["adapters"] = adapters
                self._send(200, body)
            else:
                self._send(503, {"status": "draining" if server.draining()
                                 else "no models loaded",
                                 "role": server.role})
        elif action == "metrics":
            # The load gauges are refreshed at scrape time: a reader of
            # this render sees the load now, not at the last request.
            server.refresh_gauges()
            self._send(200, REGISTRY.render(), raw=True)
        elif action == "traces":
            self._send(200, tracing.snapshot())
        elif action == "metadata":
            self._send(200, self.api.metadata(groups["name"]))
        elif action == "stats":
            self._send(200, self.api.stats(groups["name"]))
        elif action == "generate":
            self._run_generate(groups["name"])
        else:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            version = int(groups["version"]) if groups.get("version") \
                else None
            handler = getattr(self.api, action)
            name = groups["name"]
            model_label = self._model_label(name)
            # Server span: continues the caller's trace (traceparent) or
            # roots a fresh one; as the thread's current context it lets
            # the batching planes stamp child spans.
            span = tracing.start_span(
                f"server.{action}", parent=tracing.extract(self.headers),
                attrs={"model": model_label, "transport": "rest"})
            # ``outcome`` is the request counter's vocabulary (a 4xx
            # counts as "error"); ``span_status`` also names the client
            # faults, so tail sampling treats a 404/400 as an answer.
            outcome = span_status = "error"
            t0 = time.perf_counter()
            idem_key = self.headers.get(IDEMPOTENCY_HEADER)
            try:
                with tracing.use_span(span):
                    out = handler(name, body, version, idem_key=idem_key)
                outcome = span_status = "ok"
            except KeyError:
                span_status = "not_found"
                raise
            except ValueError:
                span_status = "invalid_argument"
                raise
            except Overloaded:
                outcome = span_status = "shed"
                raise
            except DeadlineExceeded:
                outcome = span_status = "deadline_exceeded"
                raise
            finally:
                self._count(model_label, action, outcome, t0)
                span.end(status=span_status)
            self._send(200, out)

    def _model_label(self, name: str) -> str:
        """Only served model names become label values: the URL is the
        client's, and each distinct label value is a permanent series."""
        return name if self.api.server.has_model(name) else "_unknown_"

    @staticmethod
    def _count(model_label: str, route: str, outcome: str,
               t0: float) -> None:
        REGISTRY.counter(REQUESTS_TOTAL, REQUESTS_HELP).inc(
            model=model_label, route=route, outcome=outcome)
        # Failures included: the slowest requests of an incident are
        # usually the failing ones.
        REGISTRY.histogram(LATENCY_SECONDS, LATENCY_HELP).observe(
            time.perf_counter() - t0, route=route)

    def _run_generate(self, name: str) -> None:
        """The streaming :generate route: chunked NDJSON on the keep-alive
        connection.  Admission failures (shed, expired deadline, bad
        request, no engine) raise before the status line and map to the
        ordinary codes; once streaming has begun, a failure becomes a
        terminal ``{"error": ..., "code": ...}`` line (a second status
        line would corrupt the chunked body)."""
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        model_label = self._model_label(name)
        span = tracing.start_span(
            "server.generate", parent=tracing.extract(self.headers),
            attrs={"model": model_label, "transport": "rest"})
        outcome = span_status = "error"
        t0 = time.perf_counter()
        try:
            try:
                with tracing.use_span(span):
                    meta, stream = self.api.generate(name, body)
            except KeyError:
                span_status = "not_found"
                raise
            except ValueError:
                span_status = "invalid_argument"
                raise
            except Overloaded:
                outcome = span_status = "shed"
                raise
            except DeadlineExceeded:
                outcome = span_status = "deadline_exceeded"
                raise
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            emitted = 0
            try:
                self._write_chunk({"meta": dict(meta, model=name)})
                for chunk in stream:
                    emitted += len(chunk)
                    self._write_chunk({"tokens": chunk})
                self._write_chunk({"done": True,
                                   "tokens_emitted": emitted})
                outcome = span_status = "ok"
            except DeadlineExceeded as e:
                outcome = span_status = "deadline_exceeded"
                self._write_chunk({"error": str(e), "code": 504})
            except ConnectionError:
                # The client went away: nothing is left to write to, and
                # the engine entry resolves on its own.
                span_status = "client_disconnected"
                return
            except Exception as e:  # noqa: BLE001 -- the stream must close
                log.exception("generate stream error")
                self._write_chunk({"error": f"{type(e).__name__}: {e}",
                                   "code": 500})
            finally:
                stream.close()
            self._end_chunks()
        finally:
            self._count(model_label, "generate", outcome, t0)
            span.end(status=span_status)

    def _write_chunk(self, payload: Dict[str, Any]) -> None:
        """One NDJSON line as one flushed HTTP/1.1 chunk: a proxy splices
        streams on line boundaries, so each line goes out when it
        exists."""
        data = json.dumps(payload).encode() + b"\n"
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

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
    server_cls: type = ThreadingHTTPServer,
) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Build and start the REST server on a daemon thread; returns
    (httpd, thread).  Port 0 binds an ephemeral port.  ``server_cls``
    lets a chaos harness substitute a ThreadingHTTPServer subclass whose
    kill() severs live connections (a SIGKILL's socket signature, in
    process), as the JAX package's does."""
    handler = type("BoundHandler", (_Handler,),
                   {"api": ServingAPI(model_server)})
    httpd = server_cls((host, port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="serving-http")
    thread.start()
    return httpd, thread
