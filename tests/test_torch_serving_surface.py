"""The rest of the port's serving surface against the JAX package's.

Twins of the JAX package's tests of the same surface, run on the port
(``device="cpu"``): the reload breaker (tests/test_fault_tolerance.py
``TestReloadBreaker*``, the corrupt ``lm`` version included), readiness
and drain (``TestReadinessAndDrain``), the typed-error mapping
(``TestHTTPStatusMapping``), the REST idempotency header
(tests/test_serving.py ``TestIdempotencyDedup``), the trace routes and
batcher spans (tests/test_tracing.py ``TestDebugRoutes``,
``TestBatcherSpans``) and the exposition (tests/test_prom.py
``TestParseMetrics``, ``TestServingLoadGauges``, ``TestServeMetrics``).

Three checks hold the two packages to each other: one request sequence
to a JAX server and to a port server gives the same (metric name, label
keys) pairs on /metrics and the same span names on /debug/traces; under
a skewed policy clock a REST ``deadline_ms`` expires at the same instant
in both; and the port's entry point refuses to start when ``KFT_FAULTS``
fails its one load, as the JAX one does.
"""

import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.runtime import prom, tracing
from kubeflow_tpu_torch.runtime.prom import (
    Registry,
    parse_metrics,
    sample_value,
    serve_metrics,
)
from kubeflow_tpu_torch.serving import http as port_http
from kubeflow_tpu_torch.serving import model_server as port_ms
from kubeflow_tpu_torch.serving.errors import DeadlineExceeded, Overloaded
from kubeflow_tpu_torch.serving.http import make_http_server
from kubeflow_tpu_torch.serving.model_server import (
    LoadedModel,
    MicroBatcher,
    ModelServer,
    _ReloadBreaker,
)
from kubeflow_tpu_torch.testing import faults

REPO = Path(__file__).resolve().parents[1]
LM_LOADER = "kubeflow_tpu.serving.loaders:lm"
LM_OVERRIDES = {
    "vocab_size": 32, "d_model": 8, "n_layers": 1, "n_heads": 2,
    "n_kv_heads": 2, "d_ff": 16, "head_dim": 4,
    "max_seq_len": 16, "dtype": "float32",
}


_VARIABLES = {}


def _export_lm(base, version, seed=0):
    """A JAX export of the ``lm`` loader (the port maps its name); the
    weights of each seed are initialized once a module."""
    if seed not in _VARIABLES:
        model = JaxTransformer(jax_model_config(LM_OVERRIDES))
        _VARIABLES[seed] = jax.tree.map(np.asarray, nn.unbox(model.init(
            jax.random.key(seed), np.zeros((1, 4), np.int32))))
    jax_export(base, version, _VARIABLES[seed],
               loader=LM_LOADER, config=LM_OVERRIDES,
               signature={"inputs": ["tokens"], "outputs": ["logits"]})


def _cpu_server(**kwargs) -> ModelServer:
    return ModelServer(device="cpu", **kwargs)


class _GatedPredict:
    """predict() that announces entry and blocks until released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def __call__(self, inputs):
        self.calls += 1
        self.entered.set()
        assert self.release.wait(timeout=30), "test forgot to release"
        return {"y": np.asarray(inputs["x"])}


@pytest.fixture
def enabled_store():
    store = tracing.enable(sample_rate=1.0, capacity=16)
    try:
        yield store
    finally:
        tracing.disable()


# -- the reload breaker -------------------------------------------------------


class TestReloadBreaker:
    def test_corrupt_version_trips_breaker_last_good_serves(
            self, tmp_path):
        base = tmp_path / "lm"
        _export_lm(base, 1)
        with faults.injected("seed=0") as inj:
            srv = _cpu_server(reload_backoff_s=0.5, reload_backoff_cap_s=8.0)
            srv.add_model("lm", str(base))
            assert srv.get("lm").version == 1
            loads_after_v1 = inj.fired("loader.load")
            # Corrupt version 2 lands in the watch path.
            (base / "2").mkdir()
            (base / "2" / "model.json").write_text("{corrupt")
            with pytest.raises(Exception):
                srv.reload("lm")
            attempts = inj.fired("loader.load")
            assert attempts == loads_after_v1 + 1
            # Breaker OPEN: watcher-style polls skip the loader.
            for _ in range(8):
                assert srv.reload("lm") is False
            assert inj.fired("loader.load") == attempts
            # Last-good keeps serving.
            out = srv.predict(
                "lm", {"tokens": np.asarray([[1, 2, 3]], np.int32)})
            assert "logits" in out
            assert srv.get("lm").version == 1
            # Backoff elapsed (policy clock) -> HALF-OPEN: one trial.
            inj.advance_clock(60)
            with pytest.raises(Exception):
                srv.reload("lm")
            assert inj.fired("loader.load") == attempts + 1
            # Re-opened with doubled backoff: skipped again.
            assert srv.reload("lm") is False
            assert inj.fired("loader.load") == attempts + 1
            # A NEW good version resets the breaker immediately.
            _export_lm(base, 3)
            assert srv.reload("lm") is True
            assert srv.get("lm").version == 3
            srv.stop()
        rendered = prom.REGISTRY.render()
        line = [ln for ln in rendered.splitlines() if ln.startswith(
            'kft_serving_reload_failures_total{model="lm"}')]
        assert line and float(line[0].rsplit(" ", 1)[1]) >= 2

    def test_half_open_admits_exactly_one_trial(self):
        with faults.injected("seed=0") as inj:
            breaker = _ReloadBreaker(base_s=1.0, cap_s=8.0)
            breaker.record_failure(2)
            assert not breaker.allow(2)  # open
            inj.advance_clock(10)
            assert breaker.allow(2)       # the half-open trial
            assert not breaker.allow(2)   # concurrent poll: refused
            breaker.record_failure(2)     # trial failed -> re-opened
            assert not breaker.allow(2)
            breaker.record_success()
            assert breaker.allow(2)

    def test_new_version_resets_breaker(self):
        breaker = _ReloadBreaker(base_s=100.0)
        breaker.record_failure(2)
        assert not breaker.allow(2)
        assert breaker.allow(3)  # different artifact: try at once

    def test_injected_load_fault_fails_one_reload(self, tmp_path):
        """``loader.load:raise*1`` in the KFT_FAULTS grammar fails
        exactly one reload; the breaker gauge reads 1 until a new
        version loads."""
        base = tmp_path / "lm"
        _export_lm(base, 1)
        srv = _cpu_server()
        srv.add_model("lm", str(base))
        _export_lm(base, 2, seed=1)
        with faults.injected("loader.load:raise*1") as inj:
            with pytest.raises(faults.FaultInjected):
                srv.reload("lm")
            parsed = parse_metrics(prom.REGISTRY.render())
            assert sample_value(parsed, "kft_serving_reload_breaker_open",
                                model="lm") == 1.0
            _export_lm(base, 3, seed=2)
            assert srv.reload("lm") is True
            assert inj.fired("loader.load") == 2
        parsed = parse_metrics(prom.REGISTRY.render())
        assert sample_value(parsed, "kft_serving_reload_breaker_open",
                            model="lm") == 0.0
        assert srv.get("lm").version == 3
        srv.stop()


class TestReloadBreakerBackoffBounds:
    def test_backoff_window_within_jitter_bounds_per_failure(self):
        base_s, cap_s = 0.5, 8.0
        with faults.injected("seed=0"):
            breaker = _ReloadBreaker(base_s=base_s, cap_s=cap_s,
                                     rng=random.Random(7))
            for n in range(1, 10):
                before = faults.monotonic()
                breaker.record_failure(2)
                window = breaker.open_until - before
                expected = min(cap_s, base_s * (2 ** (n - 1)))
                assert expected <= window <= expected * 1.25 + 1e-6, (
                    n, window, expected)

    def test_jitter_sequences_differ_across_default_breakers(self):
        with faults.injected("seed=0"):
            windows = []
            for _ in range(2):
                b = _ReloadBreaker(base_s=1.0, cap_s=64.0)
                seq = []
                for _ in range(6):
                    before = faults.monotonic()
                    b.record_failure(2)
                    seq.append(round(b.open_until - before, 9))
                windows.append(seq)
            assert windows[0] != windows[1]

    def test_half_open_single_trial_under_concurrent_clock_skew(self):
        with faults.injected("seed=0") as inj:
            breaker = _ReloadBreaker(base_s=1.0, cap_s=64.0)
            breaker.record_failure(5)
            first_window = breaker.open_until - faults.monotonic()
            inj.advance_clock(2.0)  # backoff spent
            grants = []
            barrier = threading.Barrier(8)

            def racer():
                barrier.wait()
                if breaker.allow(5):
                    grants.append(threading.get_ident())

            threads = [threading.Thread(target=racer) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert len(grants) == 1, grants
            before = faults.monotonic()
            breaker.record_failure(5)
            second_window = breaker.open_until - before
            assert second_window >= 2.0 > first_window / 1.25
            assert not breaker.allow(5)
            inj.advance_clock(second_window + 0.001)
            assert breaker.allow(5)      # next half-open trial
            breaker.record_success()
            assert breaker.allow(5) and breaker.allow(5)


# -- readiness, drain and the typed-error mapping -----------------------------


class TestReadinessAndDrain:
    def test_ready_requires_models_and_not_draining(self):
        srv = _cpu_server()
        assert not srv.is_ready()  # nothing loaded yet
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1, predict=lambda i: i, meta={})}
        assert srv.is_ready()
        srv.begin_drain()
        assert srv.draining() and not srv.is_ready()

    def test_readyz_flips_healthz_stays(self):
        srv = _cpu_server()
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1, predict=lambda i: i, meta={})}
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        port = httpd.server_address[1]
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=30) as r:
                assert r.status == 200
                assert json.loads(r.read())["status"] == "ready"
            srv.begin_drain()
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=30)
            assert err.value.code == 503
            assert json.loads(err.value.read())["status"] == "draining"
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert r.status == 200  # alive while draining
        finally:
            httpd.shutdown()
            srv.stop()

    def test_wait_for_drain_tracks_inflight(self):
        from kubeflow_tpu_torch.serving.main import wait_for_drain

        gate = _GatedPredict()
        srv = _cpu_server()
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1, predict=lambda i: gate(i), meta={})}
        srv._base_paths["m"] = "unused"
        holder: dict = {}
        t = threading.Thread(target=lambda: holder.update(
            out=srv.predict("m", {"x": np.zeros((2, 2))})))
        t.start()
        try:
            assert gate.entered.wait(timeout=10)
            assert srv.inflight() == 1
            assert not wait_for_drain(srv, deadline_s=0.2)
            gate.release.set()
            t.join(timeout=10)
            assert srv.inflight() == 0
            assert wait_for_drain(srv, deadline_s=5.0)
            assert "out" in holder  # the accepted request completed
        finally:
            gate.release.set()
            t.join(timeout=10)
            srv.stop()


class _Raiser:
    """Stub batcher raising a scripted error from submit()."""

    def __init__(self, exc):
        self.exc = exc

    def submit(self, inputs, deadline=None):
        raise self.exc

    def stats(self):
        return {}

    def close(self):
        pass


def _stub_server(exc):
    srv = _cpu_server()
    srv._models["m"] = {1: LoadedModel(
        name="m", version=1,
        predict=lambda i: {"y": np.asarray(i["x"])}, meta={})}
    srv._base_paths["m"] = "unused"
    srv._batchers["m"] = _Raiser(exc)
    return srv


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class TestHTTPStatusMapping:
    def _post(self, port, body):
        code, headers, raw = _post(port, "/model/m:predict", body)
        return code, headers, json.loads(raw)

    def test_overloaded_maps_to_429_with_retry_after(self):
        srv = _stub_server(Overloaded("queue full", retry_after_s=7))
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        try:
            code, headers, payload = self._post(
                httpd.server_address[1], {"instances": [{"x": [1.0]}]})
            assert code == 429
            assert headers.get("Retry-After") == "7"
            assert "queue full" in payload["error"]
        finally:
            httpd.shutdown()
            srv.stop()

    def test_deadline_maps_to_504(self):
        srv = _stub_server(DeadlineExceeded("expired mid-generation"))
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        try:
            code, _, payload = self._post(
                httpd.server_address[1], {"instances": [{"x": [1.0]}]})
            assert code == 504
            assert "expired" in payload["error"]
        finally:
            httpd.shutdown()
            srv.stop()

    def test_malformed_deadline_ms_is_400(self):
        srv = _stub_server(RuntimeError("unreached"))
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        try:
            for bad in (0, -5, [500], "soon", float("nan")):
                code, _, payload = self._post(
                    httpd.server_address[1],
                    {"instances": [{"x": [1.0]}], "deadline_ms": bad})
                assert code == 400, (bad, code, payload)
        finally:
            httpd.shutdown()
            srv.stop()


    def test_out_of_range_token_is_400_and_server_keeps_serving(
            self, tmp_path):
        """An ``lm`` request with an id outside the vocabulary answers
        400, and the same server answers the next good request."""
        base = tmp_path / "lm"
        _export_lm(base, 1)
        server = _cpu_server()
        server.add_model("lm", str(base))
        httpd = None
        try:
            httpd, _ = make_http_server(server, port=0, host="127.0.0.1")
            port = httpd.server_address[1]
            vocab = LM_OVERRIDES["vocab_size"]
            for bad in (vocab, -1):
                code, _, raw = _post(
                    port, "/model/lm:predict",
                    {"instances": [{"tokens": [1, bad, 3]}]})
                assert code == 400, (bad, code, raw)
                assert "token ids must lie in" in json.loads(raw)["error"]
            code, _, raw = _post(port, "/model/lm:predict",
                                 {"instances": [{"tokens": [1, 2, 3]}]})
            assert code == 200
            logits = np.asarray(json.loads(raw)["predictions"][0]["logits"])
            assert logits.shape == (3, vocab) and np.isfinite(logits).all()
        finally:
            if httpd is not None:
                httpd.shutdown()
            server.stop()


# -- idempotency --------------------------------------------------------------


class TestIdempotencyDedup:
    def test_rest_header_key_dedups(self, tmp_path):
        """The REST x-kft-idempotency-key header reaches the dedup cache
        and the duplicate answers byte-identical."""
        base = tmp_path / "lm"
        _export_lm(base, 1)
        calls = []
        server = _cpu_server()
        server.add_model("lm", str(base))
        real = server.get("lm").predict

        def counting(inputs):
            calls.append(1)
            return real(inputs)

        server.get("lm").predict = counting
        httpd = None
        try:
            httpd, _ = make_http_server(server, port=0, host="127.0.0.1")
            port = httpd.server_address[1]
            body = {"instances": [{"tokens": [1, 2, 3, 4]}]}
            headers = {"X-KFT-Idempotency-Key": "rest-1"}
            p1 = _post(port, "/model/lm:predict", body, headers)
            p2 = _post(port, "/model/lm:predict", body, headers)
            assert p1[0] == p2[0] == 200
            assert len(calls) == 1
            assert p1[2] == p2[2]
            # Another key executes again.
            _post(port, "/model/lm:predict", body,
                  {"X-KFT-Idempotency-Key": "rest-2"})
            assert len(calls) == 2
        finally:
            if httpd is not None:
                httpd.shutdown()
            server.stop()


# -- tracing ------------------------------------------------------------------


class TestDebugRoutes:
    @pytest.fixture
    def http_server(self):
        server = _cpu_server()
        httpd, _ = make_http_server(server, port=0, host="127.0.0.1")
        try:
            yield httpd.server_address[1]
        finally:
            httpd.shutdown()
            server.stop()

    def test_debug_traces_route(self, http_server):
        store = tracing.enable(sample_rate=1.0)
        try:
            tracing.start_span("probe").end()
            assert len(store) == 1
            conn = http.client.HTTPConnection("127.0.0.1", http_server,
                                              timeout=30)
            conn.request("GET", "/debug/traces")
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            conn.close()
        finally:
            tracing.disable()
        assert resp.status == 200
        assert payload["enabled"] is True
        assert payload["traces"][0]["root"] == "probe"

    def test_debug_traces_disabled_still_answers(self, http_server):
        tracing.disable()
        conn = http.client.HTTPConnection("127.0.0.1", http_server,
                                          timeout=30)
        conn.request("GET", "/debug/traces")
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert payload == {"enabled": False, "traces": []}

    def test_unknown_debug_route_404_and_keepalive_survives(
            self, http_server):
        conn = http.client.HTTPConnection("127.0.0.1", http_server,
                                          timeout=30)
        body = json.dumps({"pad": "x" * 4096}).encode()
        conn.request("POST", "/debug/nonexistent", body=body)
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 404
        assert "no route" in payload["error"]
        conn.request("GET", "/healthz")
        resp2 = conn.getresponse()
        assert resp2.status == 200
        assert json.loads(resp2.read())["status"] == "ok"
        conn.close()

    def test_server_span_continues_traceparent(self, enabled_store):
        """A client's traceparent roots the server span's trace: the
        trace id comes back in /debug/traces under server.predict, with
        the admission span beneath it."""
        srv = _cpu_server()
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1,
            predict=lambda i: {"y": np.asarray(i["x"])}, meta={})}
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        trace_id, parent = "ab" * 16, "cd" * 8
        try:
            port = httpd.server_address[1]
            code, _, _ = _post(
                port, "/model/m:predict", {"instances": [{"x": [1.0]}]},
                {"traceparent": tracing.format_traceparent(trace_id,
                                                           parent)})
            assert code == 200
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/traces",
                    timeout=30) as r:
                traces = json.loads(r.read())["traces"]
        finally:
            httpd.shutdown()
            srv.stop()
        trace = next(t for t in traces if t["trace_id"] == trace_id)
        spans = {s["name"]: s for s in trace["spans"]}
        assert spans["server.predict"]["parent_id"] == parent
        assert spans["server.admission"]["parent_id"] \
            == spans["server.predict"]["span_id"]


class TestBatcherSpans:
    def test_queue_wait_and_dispatch_spans(self, enabled_store):
        batcher = MicroBatcher(
            lambda inputs: {"y": np.asarray(inputs["x"]) + 1},
            max_batch_size=2, batch_timeout_s=0.001, name="traced")
        try:
            span = tracing.start_span("server.predict")
            with tracing.use_span(span):
                out = batcher.submit({"x": np.zeros((1, 2))})
            span.end()
        finally:
            batcher.close()
        np.testing.assert_allclose(out["y"], 1.0)
        trace = enabled_store.traces()[0]
        spans = {s["name"]: s for s in trace["spans"]}
        assert {"batcher.queue_wait", "batcher.dispatch",
                "server.predict"} <= set(spans)
        assert spans["batcher.dispatch"]["attrs"]["batcher"] == "traced"
        assert spans["batcher.queue_wait"]["parent_id"] \
            == spans["server.predict"]["span_id"]

    def test_untraced_submissions_record_nothing(self, enabled_store):
        batcher = MicroBatcher(
            lambda inputs: {"y": np.asarray(inputs["x"])},
            max_batch_size=2, batch_timeout_s=0.001, name="quiet")
        try:
            batcher.submit({"x": np.zeros((1, 2))})
        finally:
            batcher.close()
        assert enabled_store.traces() == []

    def test_dispatch_fault_reaches_every_waiter(self):
        """``batcher.dispatch:raise*1`` fails one batch's waiters with
        the injected error; the next batch is served."""
        batcher = MicroBatcher(
            lambda inputs: {"y": np.asarray(inputs["x"])},
            max_batch_size=1, batch_timeout_s=0.001, name="chaos")
        try:
            with faults.injected("batcher.dispatch:raise*1") as inj:
                with pytest.raises(faults.FaultInjected):
                    batcher.submit({"x": np.zeros((1, 2))})
                out = batcher.submit({"x": np.ones((1, 2))})
                assert inj.fired("batcher.dispatch") == 2
        finally:
            batcher.close()
        np.testing.assert_allclose(out["y"], 1.0)


# -- the exposition -----------------------------------------------------------


class TestParseMetrics:
    def test_roundtrip_counter_gauge_histogram(self):
        reg = Registry()
        reg.counter("c_total", "c").inc(3, model="m")
        reg.gauge("g", "g").set(7)
        reg.gauge("g").set(2, model="m")
        reg.histogram("h_seconds", "h").observe(0.2)
        parsed = parse_metrics(reg.render())
        assert sample_value(parsed, "c_total", model="m") == 3.0
        assert sample_value(parsed, "g") == 7.0  # unlabeled first
        assert sample_value(parsed, "g", model="m") == 2.0
        assert sample_value(parsed, "h_seconds_count") == 1.0
        assert sample_value(parsed, "missing") is None

    def test_exact_label_match_beats_first_superset(self):
        reg = Registry()
        ctr = reg.counter("reqs_total", "r")
        ctr.inc(5, model="lm", adapter="a")
        ctr.inc(2, model="lm")
        parsed = parse_metrics(reg.render())
        assert sample_value(parsed, "reqs_total", model="lm") == 2.0
        assert sample_value(parsed, "reqs_total",
                            model="lm", adapter="a") == 5.0
        only_refined = parse_metrics(
            'reqs_total{adapter="a",model="lm"} 5\n'
            'reqs_total{adapter="b",model="lm"} 7\n')
        assert sample_value(only_refined, "reqs_total", model="lm") == 5.0

    def test_garbage_lines_skipped_not_fatal(self):
        parsed = parse_metrics(
            "# HELP x y\nnot a metric line !!\nx 1.5\nx{a=\"b\"} nan?\n")
        assert parsed == {"x": [({}, 1.5)]}

    def test_escaped_label_values_roundtrip(self):
        reg = Registry()
        reg.gauge("g", "").set(1, path='a"b\\c')
        parsed = parse_metrics(reg.render())
        labels, value = parsed["g"][0]
        assert value == 1.0 and labels["path"] == 'a"b\\c'

    def test_backslash_adjacent_escapes_roundtrip(self):
        for value in ("C:\\new", "tab\\\\n", 'q\\"x', "a\nb\\"):
            reg = Registry()
            reg.gauge("g", "").set(1, path=value)
            parsed = parse_metrics(reg.render())
            labels, _ = parsed["g"][0]
            assert labels["path"] == value, (value, labels)

    def test_render_matches_jax_byte_for_byte(self):
        """The same writes into both packages' registries render the same
        exposition text."""
        from kubeflow_tpu.runtime.prom import Registry as JaxRegistry

        texts = []
        for reg in (Registry(), JaxRegistry()):
            reg.counter("kft_a_total", "a").inc(2, model='x"y')
            reg.gauge("kft_g", "g").set(3)
            reg.gauge("kft_g").set(1.5, model="m")
            reg.histogram("kft_h_seconds", "h").observe(0.02, route="p")
            reg.histogram("kft_idle_seconds", "i")
            texts.append(reg.render())
        assert texts[0] == texts[1]


class TestServingLoadGauges:
    def test_refresh_gauges_exports_inflight_and_readiness(self):
        srv = _cpu_server()
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1, predict=lambda i: i, meta={})}
        srv._inflight_by_model["m"] = 2
        srv.enter_request()
        srv.enter_request()
        try:
            srv.refresh_gauges()
            parsed = parse_metrics(prom.REGISTRY.render())
            assert sample_value(parsed, "kft_serving_inflight") == 2.0
            assert sample_value(parsed, "kft_serving_inflight",
                                model="m") == 2.0
            assert sample_value(parsed, "kft_serving_queue_depth",
                                model="m") == 0.0
            assert sample_value(parsed, "kft_serving_ready") == 1.0
            srv.begin_drain()
            srv.refresh_gauges()
            parsed = parse_metrics(prom.REGISTRY.render())
            assert sample_value(parsed, "kft_serving_ready") == 0.0
        finally:
            srv.exit_request()
            srv.exit_request()

    def test_metrics_route_refreshes_before_render(self):
        srv = _cpu_server()
        srv._models["m"] = {1: LoadedModel(
            name="m", version=1, predict=lambda i: i, meta={})}
        httpd, _ = make_http_server(srv, port=0, host="127.0.0.1")
        try:
            port = httpd.server_address[1]
            srv.enter_request()  # a real request mid-parse
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics",
                    timeout=30) as resp:
                parsed = parse_metrics(resp.read().decode())
            srv.exit_request()
            # The scrape saw the live request, and is not itself counted.
            assert sample_value(parsed, "kft_serving_inflight") == 1.0
            assert sample_value(parsed, "kft_serving_ready") == 1.0
        finally:
            httpd.shutdown()


class TestServeMetrics:
    def test_http_endpoint(self):
        reg = Registry()
        reg.counter("ticks_total").inc()
        httpd, _ = serve_metrics(0, reg, host="127.0.0.1")
        port = httpd.server_address[1]
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5
            ).read().decode()
            assert "ticks_total 1.0" in body
        finally:
            httpd.shutdown()


# -- the two packages side by side --------------------------------------------


def _drive(ms_mod, http_mod, base, port_device):
    """One request sequence against one package's server: a traced
    predict through a MicroBatcher, a keyed predict twice, an unknown
    model, a malformed body, metadata, then /metrics and /debug/traces.
    Returns ({(name, label keys)}, {span names}, [status codes])."""
    kwargs = {"device": port_device} if port_device else {}
    srv = ms_mod.ModelServer(**kwargs)
    srv.add_model("lm", str(base))
    srv.enable_batching("lm", lambda m: ms_mod.MicroBatcher(
        m.predict, max_batch_size=2, batch_timeout_s=0.001,
        name="lm-v1"))
    httpd, _ = http_mod.make_http_server(srv, port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    body = {"instances": [{"tokens": [1, 2, 3, 4]}]}
    codes = []
    try:
        tp = "00-" + "12" * 16 + "-" + "34" * 8 + "-01"
        codes.append(_post(port, "/model/lm:predict", body,
                           {"traceparent": tp})[0])
        for _ in range(2):
            codes.append(_post(port, "/model/lm:predict", body,
                               {"x-kft-idempotency-key": "k"})[0])
        codes.append(_post(port, "/model/nope:predict", body)[0])
        codes.append(_post(port, "/model/lm:predict", {"x": 1})[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/model/lm:metadata",
                timeout=30) as r:
            codes.append(r.status)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/traces", timeout=30) as r:
            traces = json.loads(r.read())["traces"]
    finally:
        httpd.shutdown()
        srv.stop()
    pairs = {(name, tuple(sorted(labels)))
             for name, samples in parse_metrics(text).items()
             for labels, _ in samples}
    spans = {s["name"] for t in traces for s in t["spans"]}
    return pairs, spans, codes


def test_metric_and_span_names_match_jax(tmp_path, monkeypatch):
    """The same request sequence to a JAX server and to a port server
    (each on a fresh registry and trace store) yields the same (metric
    name, label keys) pairs on /metrics, the same span names on
    /debug/traces and the same status codes."""
    from kubeflow_tpu.runtime import prom as jax_prom
    from kubeflow_tpu.runtime import tracing as jax_tracing
    from kubeflow_tpu.serving import http as jax_http
    from kubeflow_tpu.serving import model_server as jax_ms

    base = tmp_path / "lm"
    _export_lm(base, 1)
    jax_reg = jax_prom.Registry()
    monkeypatch.setattr(jax_prom, "REGISTRY", jax_reg)
    monkeypatch.setattr(jax_tracing, "REGISTRY", jax_reg)
    port_reg = Registry()
    for mod in (prom, tracing, port_ms, port_http):
        monkeypatch.setattr(mod, "REGISTRY", port_reg)
    jax_tracing.enable(sample_rate=1.0, capacity=32)
    tracing.enable(sample_rate=1.0, capacity=32)
    try:
        want = _drive(jax_ms, jax_http, base, None)
        got = _drive(port_ms, port_http, base, "cpu")
    finally:
        jax_tracing.disable()
        tracing.disable()
    assert got[2] == want[2] == [200, 200, 200, 404, 400, 200]
    assert got[1] == want[1]
    assert {"server.predict", "server.admission", "batcher.queue_wait",
            "batcher.dispatch"} <= got[1]
    assert got[0] == want[0]
    names = {name for name, _ in got[0]}
    assert {"kft_serving_requests_total", "kft_serving_inflight",
            "kft_serving_dedup_hits_total",
            "kft_serving_batch_size_count"} <= names


def test_rest_deadline_expires_on_the_skewed_clock_like_jax():
    """With the policy clock skewed 100 s ahead, a REST ``deadline_ms``
    is stamped on that clock in both packages: a queued request with a
    5 s budget expires when the clock passes 10 s more, one with 60 s
    does not, and a fresh 5 s request is served (a stamp on the real
    clock would have expired all three on arrival)."""
    from kubeflow_tpu.serving import http as jax_http
    from kubeflow_tpu.serving import model_server as jax_ms
    from kubeflow_tpu.testing import faults as jax_faults

    def run(ms_mod, http_mod, faults_mod, kwargs):
        gate = _GatedPredict()
        srv = ms_mod.ModelServer(**kwargs)
        srv._models["m"] = {1: ms_mod.LoadedModel(
            name="m", version=1, predict=gate, meta={})}
        srv._base_paths["m"] = "unused"
        batcher = ms_mod.MicroBatcher(
            gate, max_batch_size=1, batch_timeout_s=0.0, in_flight=1,
            name="skew")
        srv._batchers["m"] = batcher
        httpd, _ = http_mod.make_http_server(srv, port=0,
                                             host="127.0.0.1")
        port = httpd.server_address[1]
        codes = {}

        def call(key, deadline_ms):
            body = {"instances": [{"x": [1.0]}]}
            if deadline_ms is not None:
                body["deadline_ms"] = deadline_ms
            codes[key] = _post(port, "/model/m:predict", body)[0]

        with faults_mod.injected("seed=0") as inj:
            inj.advance_clock(100.0)
            stamped = http_mod.parse_deadline_ms({"deadline_ms": 500})
            offset = stamped - faults_mod.monotonic()
            try:
                first = threading.Thread(target=call, args=("busy", None))
                first.start()
                assert gate.entered.wait(timeout=30)
                queued = [threading.Thread(target=call, args=k)
                          for k in (("short", 5000), ("long", 60000))]
                for t in queued:
                    t.start()
                deadline = time.monotonic() + 30
                while batcher.stats()["queue_depth"] < 2:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                inj.advance_clock(10.0)
                gate.release.set()
                for t in [first] + queued:
                    t.join(timeout=60)
                call("fresh", 5000)
            finally:
                gate.release.set()
                httpd.shutdown()
                srv.stop()
        return offset, codes

    want_offset, want = run(jax_ms, jax_http, jax_faults, {})
    got_offset, got = run(port_ms, port_http, faults, {"device": "cpu"})
    assert abs(want_offset - 0.5) < 0.05 and abs(got_offset - 0.5) < 0.05
    assert want == {"busy": 200, "short": 504, "long": 200, "fresh": 200}
    assert got == want


def test_entry_point_refuses_a_failed_load_from_kft_faults(tmp_path):
    """``KFT_FAULTS=loader.load:raise*1`` makes the port's serving entry
    point fail its one load at start: the process exits non-zero with
    the injected fault on stderr and never reports ready."""
    base = tmp_path / "lm"
    _export_lm(base, 1)
    env = dict(os.environ, PYTHONPATH=str(REPO),
               KFT_FAULTS="loader.load:raise*1")
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
         "--model_name", "lm", "--model_base_path", str(base),
         "--port", "0", "--host", "127.0.0.1", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0
    assert "fault injection ACTIVE" in proc.stderr
    assert "FaultInjected: injected fault at loader.load" in proc.stderr
    assert "KFT_SERVING_READY" not in proc.stderr


def test_tracing_flags_and_codec_match_jax():
    """The port's copy of runtime/tracing.py takes the same flags to the
    same store, extracts the same parent from the same headers and
    snapshots in the same form as the JAX package's."""
    import argparse

    from kubeflow_tpu.runtime import tracing as jax_tracing

    argv = ["--trace_sample_rate", "0.5", "--trace_capacity", "7"]
    parsed = []
    for mod in (jax_tracing, tracing):
        ap = argparse.ArgumentParser()
        mod.add_cli_args(ap)
        parsed.append(vars(ap.parse_args(argv)))
        dashed = argparse.ArgumentParser()
        mod.add_cli_args(dashed, dashes=True)
        assert vars(dashed.parse_args(["--no-tracing"]))["no_tracing"]
    assert parsed[0] == parsed[1]
    headers = {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"}
    for bad in ({}, {"traceparent": "junk"}, headers):
        got, want = tracing.extract(bad), jax_tracing.extract(bad)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.trace_id, got.span_id) == (want.trace_id,
                                                   want.span_id)
    shapes = []
    for mod in (jax_tracing, tracing):
        try:
            store = mod.enable_from_args(argparse.Namespace(
                no_tracing=False, trace_sample_rate=1.0,
                trace_capacity=7))
            mod.start_span("probe", parent=mod.extract(headers)).end()
            snap = mod.snapshot()
            assert len(store) == 1
            shapes.append((sorted(snap), sorted(snap["traces"][0]),
                           snap["traces"][0]["trace_id"]))
        finally:
            mod.disable()
        assert mod.snapshot() == {"enabled": False, "traces": []}
        assert mod.enable_from_args(argparse.Namespace(
            no_tracing=True)) is None
    assert shapes[0] == shapes[1]
