"""Hermetic end-to-end scenarios of the port behind the fleet router:
twins of the JAX package's ``kubeflow_tpu/testing/e2e.py`` scenarios
that run behind ``FleetRouter`` (``fleet``, ``survivable``, ``kv_spill``,
``multichip_serving``, ``adapter_serving``), on the port's
``ModelServer``, ``DecodeEngine``, REST front, ``export`` and
``batcher_factory``, at the JAX scenarios' tiny float32 configuration,
``KFT_FAULTS`` defaults, pool sizes and assertions.

    python -m kubeflow_tpu_torch.testing.e2e fleet --device cpu
    python -m kubeflow_tpu_torch.testing.e2e survivable kv_spill

Each scenario takes ``device`` (None = CUDA, as every entry point of the
port) and ``params``: the LM's weights as the JAX-layout tree
``{"embed": ..., "layers": ...}`` that an export carries (None = seeded
random weights made by the port).  Each returns what it served (prompts
and greedy tokens), so a caller can hold the tokens to a reference
generate() on the same weights.  ``multichip_serving_smoke(mesh=
"tensor=2")`` starts its decode replica as two ``serving.main --mesh
tensor=2`` processes over gloo; without ``mesh`` the decode replica is
one device in process.

The control plane's scenarios are twins of the JAX package's
``tpujob``, ``scheduler``, ``train_resilience``, ``hfta`` and
``colocation``: the port's operator, cluster scheduler and fleet
autoscaler, over the port's fake apiserver and ``HttpKube`` where JAX's
run over its own, at the JAX scenarios' seeds, clock skews, sizes and
assertions, with JAX's slice names mapped onto the port's GPU shapes
(``SLICE_MAP``).  ``train_resilience`` trains the tiny LM in float32 on
``device``; the others run on the host alone.

    python -m kubeflow_tpu_torch.testing.e2e scheduler colocation --device cpu
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.operator.reconciler import LABEL_JOB

JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
# The JAX scenarios' tiny float32 LM (the multichip and adapter scenarios
# use their own vocabulary and kv heads).
OVERRIDES = {
    "vocab_size": 128, "d_model": 32, "n_layers": 2, "n_heads": 4,
    "n_kv_heads": 2, "d_ff": 64, "head_dim": 8, "max_seq_len": 64,
    "dtype": "float32",
}
MULTICHIP_OVERRIDES = dict(OVERRIDES, vocab_size=96, n_kv_heads=4)
ADAPTER_OVERRIDES = dict(OVERRIDES, vocab_size=96)
WAIT_S = 180

log = logging.getLogger(__name__)


class KillableServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that can sever its live connections:
    shutdown() only stops accepting, while a crashed process also resets
    every established socket; kill() reproduces that signature, so a
    stream broken mid-generation breaks for its reader."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._live = set()
        self._live_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._live_lock:
            self._live.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address):
        # The severed handler threads die on a broken pipe by design.
        pass

    def kill(self):
        # Sever first: shutdown() waits up to serve_forever's poll, and a
        # kill that waits that long lands after a short generation ended.
        with self._live_lock:
            live = list(self._live)
            self._live.clear()
        for sock in live:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.shutdown()
        self.server_close()


def seeded_params(overrides: Dict[str, Any], seed: int = 0):
    """JAX-layout weights of a seeded random LM, made by the port."""
    import torch

    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.serving.loaders import _model_config

    cfg = _model_config(dict(overrides, dtype="float32"))
    return params_to_jax(Transformer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))


def export_lm(base: str, params, overrides: Dict[str, Any],
              max_new: int) -> None:
    """One greedy ``lm_generate`` version of ``params`` under ``base``,
    servable by both packages."""
    from kubeflow_tpu_torch.serving.export import export

    export(base, 1, {"params": params}, loader=JAX_LOADER,
           config={"model": overrides, "max_new_tokens": max_new,
                   "temperature": 0.0},
           signature={"inputs": ["tokens"], "outputs": ["tokens"]})


def make_replica(base: str, device, port: int = 0, role: str = "unified",
                 server_cls: type = ThreadingHTTPServer, **engine):
    """A ModelServer serving ``base`` as ``lm`` through the DecodeEngine
    behind a REST listener on localhost; returns (server, httpd)."""
    from kubeflow_tpu_torch.serving.http import make_http_server
    from kubeflow_tpu_torch.serving.main import batcher_factory
    from kubeflow_tpu_torch.serving.model_server import ModelServer

    server = ModelServer(device=device, role=role)
    server.add_model("lm", base)
    server.enable_batching("lm", batcher_factory(
        micro_batch_size=0, batch_timeout_s=0.005, lm_engine=True,
        **engine))
    httpd, _ = make_http_server(server, port=port, host="127.0.0.1",
                                server_cls=server_cls)
    return server, httpd


def predict_via(port: int, body, path: str = "/model/lm:predict",
                headers=None, timeout: float = WAIT_S):
    """POST a JSON body; (status, parsed answer) for any status."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def stream_via(port: int, body, path: str = "/model/lm:generate",
               on_tokens=None, timeout: float = WAIT_S):
    """POST :generate and read the NDJSON stream: (status, meta, tokens,
    terminal line), or (status, headers, body, None) for a non-200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, dict(resp.headers.items()), resp.read(), \
                None
        meta = terminal = None
        tokens: List[int] = []
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            msg = json.loads(line)
            if "meta" in msg:
                meta = msg["meta"]
            elif "tokens" in msg:
                tokens.extend(msg["tokens"])
                if on_tokens is not None:
                    on_tokens(tokens)
            if "done" in msg or "error" in msg:
                terminal = msg
                break
        if terminal is not None:
            # Read the body's last chunk: a socket closed with unread
            # bytes resets, and the server's keep-alive reader sees it.
            try:
                resp.read()
            except (http.client.HTTPException, OSError):
                pass
        return 200, meta, tokens, terminal
    finally:
        conn.close()


def scrape(port: int):
    from kubeflow_tpu_torch.runtime.prom import parse_metrics

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        return parse_metrics(resp.read().decode())


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def metric_delta(before, after, name, **labels) -> float:
    from kubeflow_tpu_torch.runtime.prom import sample_value

    return (sample_value(after, name, **labels) or 0.0) \
        - (sample_value(before, name, **labels) or 0.0)


def _wait(condition, seconds: float, what: str, poll: float = 0.01):
    deadline = time.monotonic() + seconds
    while not condition():
        assert time.monotonic() < deadline, what
        time.sleep(poll)


def static_registry(ports, names=None, **kw):
    from kubeflow_tpu_torch.fleet.endpoints import (
        Endpoint,
        EndpointRegistry,
        StaticEndpoints,
    )

    names = names or [f"srv-{i}" for i in range(len(ports))]
    return EndpointRegistry(StaticEndpoints([
        Endpoint(name=n, url=f"http://127.0.0.1:{p}")
        for n, p in zip(names, ports)]), **kw)


def start_router(registry, **kw):
    from kubeflow_tpu_torch.fleet.router import FleetRouter, make_router_server

    router = FleetRouter(registry, **kw)
    httpd, _ = make_router_server(router, port=0, host="127.0.0.1")
    return router, httpd


def close_fleet(router=None, router_httpd=None, servers=()):
    """Stop the router's listener and upstream pool, then every replica
    and listener, whatever state a failed step left them in."""
    if router_httpd is not None:
        router_httpd.shutdown()
        router_httpd.server_close()
    if router is not None:
        router.close()
    for srv, httpd in servers:
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:  # noqa: BLE001 — killed mid-scenario
            pass
        srv.stop()


def fleet_smoke(namespace: str = "kubeflow-test", device=None,
                params=None) -> Dict[str, Any]:
    """The fleet control plane: a load-aware router in front of three
    in-process port replicas, discovered as label-selected pods through
    testing/fake_apiserver.py over real sockets.

      1. discovery + routing: concurrent traffic through the router,
         spread over the replicas, every answer prompt + max_new tokens;
      2. scale-out under the burst: the autoscaler reads the scraped
         load and patches the Deployment through the same apiserver;
      3. a replica killed mid-generation is ejected within one probe
         interval, later traffic lands on survivors, and after the
         clock-skewed backoff the restarted replica readmits;
      4. a drain-aware rolling restart under continuous traffic loses no
         accepted request;
      5. one trace walks router.request -> router.forward ->
         server.predict -> engine.admission -> engine.prefill_chunk ->
         engine.decode with one trace_id, on the router's and a
         replica's /debug/traces; at sample rate 0 a deadline-expired
         request is still retained and ok traffic is not;
      6. the router, autoscaler and trace outcomes in kft_* metrics.
    """
    from kubeflow_tpu_torch.fleet.autoscaler import Autoscaler
    from kubeflow_tpu_torch.fleet.endpoints import (
        EndpointRegistry,
        KubeEndpoints,
    )
    from kubeflow_tpu_torch.operator.kube_http import HttpKube
    from kubeflow_tpu_torch.runtime import tracing
    from kubeflow_tpu_torch.runtime.prom import sample_value
    from kubeflow_tpu_torch.serving.main import wait_for_drain
    from kubeflow_tpu_torch.testing import faults
    from kubeflow_tpu_torch.testing.fake_apiserver import make_fake_apiserver

    max_new = 8
    scenario = os.environ.get(faults.ENV) or \
        "seed=20260803;engine.step:sleep=0.02"
    prompt = list(range(1, 9))
    engine = dict(lm_engine_slots=2, lm_engine_prefill_len=16,
                  max_queue_depth=8)
    params = params if params is not None else seeded_params(OVERRIDES)
    replicas: List[list] = []
    apiserver = router = router_httpd = None
    served: List[List[int]] = []
    tracing.enable(sample_rate=1.0, capacity=256)
    with faults.injected(scenario) as inj, \
            tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, OVERRIDES, max_new)
        try:
            replicas = [list(make_replica(f"{tmp}/lm", device, **engine))
                        for _ in range(3)]
            apiserver, _, store = make_fake_apiserver()
            kube = HttpKube(
                base_url=f"http://127.0.0.1:{apiserver.server_address[1]}")
            store.create_deployment({
                "metadata": {"namespace": namespace, "name": "tpu-serving"},
                "spec": {"replicas": 1}})
            for i, (_, httpd) in enumerate(replicas):
                store.create_pod({
                    "metadata": {"namespace": namespace,
                                 "name": f"srv-{i}",
                                 "labels": {"app": "tpu-serving"}},
                    "spec": {"containers": [{"ports": [{
                        "name": "http",
                        "containerPort": httpd.server_address[1]}]}]},
                    "status": {"podIP": "127.0.0.1"}})
                store.set_pod_phase(namespace, f"srv-{i}", "Running")
            registry = EndpointRegistry(
                KubeEndpoints(kube, namespace, {"app": "tpu-serving"}),
                probe_interval_s=0.2, eject_threshold=1,
                eject_backoff_s=2.0)
            registry.refresh()
            assert len(registry.routable()) == 3, registry.describe()
            router, router_httpd = start_router(registry, max_tries=3,
                                                 try_timeout_s=180.0)
            rport = router_httpd.server_address[1]
            body_full = {"instances": [{"tokens": prompt}]}

            # -- 1. routed traffic spreads and completes ------------------
            results: Dict[int, Any] = {}

            def client(i, body=body_full):
                results[i] = predict_via(rport, body)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(9)]
            for t in threads:
                t.start()
            # -- 2. scale-out under the open-loop burst -------------------
            autoscaler = Autoscaler(
                kube, namespace, "tpu-serving", registry,
                target_inflight_per_replica=1.0, tolerance=0.1,
                min_replicas=1, max_replicas=3,
                scale_up_cooldown_s=0.0, scale_down_cooldown_s=3600.0)
            deadline = time.monotonic() + 120
            scaled = None
            while time.monotonic() < deadline:
                registry.refresh()
                if registry.total_load() >= 2:
                    scaled = autoscaler.reconcile_once()
                    if scaled["applied"]:
                        break
                time.sleep(0.02)
            assert scaled is not None and scaled["applied"], (
                "autoscaler never saw the burst's load")
            dep = kube.get_deployment(namespace, "tpu-serving")
            assert dep["spec"]["replicas"] >= 2, dep
            for t in threads:
                t.join(timeout=WAIT_S)
            assert sorted(r[0] for r in results.values()) == [200] * 9, \
                results
            for _, payload in results.values():
                tokens = payload["predictions"][0]["tokens"]
                assert tokens[:len(prompt)] == prompt
                assert len(tokens) == len(prompt) + max_new
                served.append(tokens)
            served_by = [i for i, (srv, _) in enumerate(replicas)
                         if (srv.batcher_stats("lm") or {}).get(
                             "requests", 0) > 0]
            assert len(served_by) >= 2, (
                f"load not spread: replicas {served_by} served")

            # -- 5a. trace propagation: router hop -> decode step ---------
            snap = get_json(rport, "/debug/traces")
            assert snap["enabled"], snap
            chain = {"router.request", "router.forward", "server.predict",
                     "engine.admission", "engine.prefill_chunk",
                     "engine.decode"}
            full = next((t for t in snap["traces"]
                         if chain <= {s["name"] for s in t["spans"]}),
                        None)
            assert full is not None, (
                "no trace with the full router->engine span chain in "
                f"{[sorted({s['name'] for s in t['spans']})
                    for t in snap['traces']]}")
            tid = full["trace_id"]
            assert all(s["trace_id"] == tid for s in full["spans"])
            by_name: Dict[str, Any] = {}
            for s in full["spans"]:
                by_name.setdefault(s["name"], s)
            root = by_name["router.request"]
            assert root["parent_id"] is None
            assert by_name["router.forward"]["parent_id"] \
                == root["span_id"]
            assert by_name["server.predict"]["parent_id"] \
                == by_name["router.forward"]["span_id"]
            assert by_name["engine.decode"]["attrs"]["tokens"] == max_new
            replica_snap = get_json(replicas[0][1].server_address[1],
                                    "/debug/traces")
            assert any(t["trace_id"] == tid
                       for t in replica_snap["traces"]), (
                f"trace {tid} not visible on a replica")

            # -- 3. kill mid-generation -> eject -> recover ---------------
            victim_srv, victim_httpd = replicas[0]
            victim_port = victim_httpd.server_address[1]
            holder: Dict[str, Any] = {}
            t = threading.Thread(target=lambda: holder.update(
                resp=predict_via(victim_port, body_full, timeout=30)))
            t.start()
            _wait(lambda: victim_srv.inflight() >= 1, 60,
                  "victim request never started")
            victim_httpd.shutdown()
            victim_httpd.server_close()
            t.join(timeout=60)
            registry.refresh()
            states = {s.name: s for s in registry.all()}
            assert states["srv-0"].breaker.open, registry.describe()
            assert len(registry.routable()) == 2
            results.clear()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert sorted(r[0] for r in results.values()) == [200] * 6, \
                results
            served.extend(p["predictions"][0]["tokens"]
                          for _, p in results.values())
            from kubeflow_tpu_torch.serving.http import make_http_server

            replicas[0][1] = make_http_server(
                victim_srv, port=victim_port, host="127.0.0.1")[0]
            inj.advance_clock(10)
            registry.refresh()
            assert states["srv-0"].routable(), registry.describe()

            # -- 4. drain-aware rolling restart, zero loss ----------------
            stop_traffic = threading.Event()
            outcomes: List[int] = []

            def traffic():
                while not stop_traffic.is_set():
                    outcomes.append(predict_via(rport, body_full)[0])

            traffic_threads = [threading.Thread(target=traffic)
                               for _ in range(3)]
            for t in traffic_threads:
                t.start()
            try:
                roll_srv, roll_httpd = replicas[1]
                roll_port = roll_httpd.server_address[1]
                roll_srv.begin_drain()
                registry.refresh()
                states = {s.name: s for s in registry.all()}
                assert not states["srv-1"].routable()
                assert states["srv-1"].state_label() == "draining"
                assert wait_for_drain(roll_srv, deadline_s=120), \
                    "draining replica never quiesced"
                roll_httpd.shutdown()
                roll_httpd.server_close()
                roll_srv.stop()
                replicas[1] = list(make_replica(f"{tmp}/lm", device,
                                                port=roll_port, **engine))
                registry.refresh()
                states = {s.name: s for s in registry.all()}
                deadline = time.monotonic() + 60
                while not states["srv-1"].routable():
                    assert time.monotonic() < deadline, registry.describe()
                    time.sleep(0.05)
                    registry.refresh()
            finally:
                stop_traffic.set()
                for t in traffic_threads:
                    t.join(timeout=WAIT_S)
            assert outcomes, "traffic generator produced nothing"
            bad = [c for c in outcomes if c != 200]
            assert not bad, (f"rolling restart lost {len(bad)}/"
                             f"{len(outcomes)} accepted requests: {bad[:5]}")

            # -- 5b. tail sampling: errored requests always retained ------
            tracing.enable(sample_rate=0.0, capacity=64)
            assert predict_via(rport, body_full)[0] == 200
            code, payload = predict_via(
                rport, dict(body_full, deadline_ms=0.001))
            assert code == 504, (code, payload)
            snap = get_json(rport, "/debug/traces")
            statuses = [t["status"] for t in snap["traces"]]
            assert "deadline_exceeded" in statuses, snap["traces"]
            assert all(t["retained"] == "error" for t in snap["traces"]
                       if t["status"] == "deadline_exceeded")
            assert "ok" not in statuses, (
                f"ok traffic retained at sample rate 0: {statuses}")

            # -- 6. control-plane outcomes in kft_* metrics ---------------
            parsed = scrape(rport)
            assert (sample_value(parsed, "kft_router_ejections_total",
                                 endpoint="srv-0") or 0) >= 1
            ok = sum(v for labels, v in
                     parsed.get("kft_router_requests_total", ())
                     if labels.get("outcome") == "ok")
            assert ok >= 15, parsed.get("kft_router_requests_total")
            assert (sample_value(parsed, "kft_autoscaler_desired_replicas")
                    or 0) >= 2
            assert sample_value(parsed, "kft_router_endpoints",
                                state="routable") == 3, parsed.get(
                                    "kft_router_endpoints")
            assert (sample_value(parsed, "kft_trace_spans_total") or 0) > 0
            assert (sample_value(parsed, "kft_trace_retained_total",
                                 reason="error") or 0) >= 1
            assert sample_value(parsed, "kft_trace_store_traces") \
                is not None
        finally:
            tracing.disable()
            close_fleet(router, router_httpd, replicas)
            if apiserver is not None:
                apiserver.shutdown()
                apiserver.server_close()
    return {"prompt": prompt, "tokens": served}


def kill_serving_replica(replicas, killed, kill_lock):
    """on_tokens hook: at a client's third token, kill the replica that
    has a request in flight (its live sockets severed)."""

    def maybe_kill(tokens):
        if len(tokens) < 3:
            return
        with kill_lock:
            if killed:
                return
            for i, (srv, httpd) in enumerate(replicas):
                stats = srv.batcher_stats("lm") or {}
                if stats.get("in_flight_requests", 0) > 0:
                    killed["index"] = i
                    killed["port"] = httpd.server_address[1]
                    httpd.kill()
                    return

    return maybe_kill


def survivable_smoke(namespace: str = "kubeflow-test", device=None,
                     params=None) -> Dict[str, Any]:
    """Survivable inference: a router in front of three engine replicas
    under a seeded schedule that kills a replica mid-generation.

      1. control: an uninterrupted streaming :generate;
      2. chaos burst: concurrent streams through the router while the
         replica serving a client is killed at its third token; every
         accepted stream completes bit-identical to the control (the
         router resumes prompt + delivered tokens on a survivor);
      3. the dead replica is force-ejected at once, then restarted on
         the same port and readmitted by the half-open probe;
      4. dedup: a double-submitted :predict with one idempotency key
         executes once and both submissions get the same payload;
      5. kft_router_replays_total{outcome="ok"}, kft_router_resume_tokens
         and kft_serving_dedup_hits_total deltas, and the router.replay /
         engine.resume sites fired.
    """
    from kubeflow_tpu_torch.serving.http import make_http_server
    from kubeflow_tpu_torch.testing import faults

    max_new = 12
    prompt = list(range(1, 9))
    scenario = os.environ.get(faults.ENV) or \
        "seed=20260804;engine.step:sleep=0.02"
    engine = dict(lm_engine_slots=2, lm_engine_prefill_len=32,
                  max_queue_depth=16)
    params = params if params is not None else seeded_params(OVERRIDES)
    replicas: List[list] = []
    router = router_httpd = None
    with faults.injected(scenario) as inj, \
            tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, OVERRIDES, max_new)
        try:
            replicas = [list(make_replica(f"{tmp}/lm", device,
                                          server_cls=KillableServer,
                                          **engine))
                        for _ in range(3)]
            registry = static_registry(
                [h.server_address[1] for _, h in replicas],
                probe_interval_s=0.2, eject_threshold=3,
                eject_backoff_s=2.0)
            registry.refresh()
            assert len(registry.routable()) == 3, registry.describe()
            router, router_httpd = start_router(
                registry, max_tries=3, max_replays=2, try_timeout_s=180.0)
            rport = router_httpd.server_address[1]
            body = {"tokens": prompt, "max_new_tokens": max_new}

            # -- 1. uninterrupted control run -------------------------
            _, meta, control, terminal = stream_via(
                replicas[0][1].server_address[1], body)
            assert meta["resumable"] is True, meta
            assert terminal.get("done") and len(control) == max_new, \
                (control, terminal)
            before = scrape(rport)

            # -- 2. chaos burst: kill the serving replica at token 3 --
            killed: Dict[str, int] = {}
            maybe_kill = kill_serving_replica(replicas, killed,
                                               threading.Lock())
            results: Dict[int, Any] = {}

            def client(i, on_tokens=None):
                results[i] = stream_via(rport, body, on_tokens=on_tokens)

            threads = [threading.Thread(
                target=client, args=(i, maybe_kill if i == 0 else None))
                for i in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert killed, "the kill schedule never fired"
            for i, (status, _, tokens, terminal) in results.items():
                assert status == 200 and terminal is not None \
                    and terminal.get("done"), (
                        f"client {i} stream did not complete: {terminal}")
                assert tokens == control, (
                    f"client {i} stream drifted from the uninterrupted "
                    f"control: {tokens} != {control}")
            assert inj.fired("router.replay") >= 1
            assert inj.fired("engine.resume") >= 1

            # -- 3. immediate ejection, then restart + readmission ----
            victim = {s.name: s for s in registry.all()}[
                f"srv-{killed['index']}"]
            assert victim.breaker.open, registry.describe()
            assert victim.breaker.state() in ("open", "half_open")
            srv = replicas[killed["index"]][0]
            replicas[killed["index"]][1] = make_http_server(
                srv, port=killed["port"], host="127.0.0.1",
                server_cls=KillableServer)[0]
            inj.advance_clock(30)
            registry.refresh()
            assert victim.routable(), registry.describe()
            _, _, tokens, terminal = stream_via(rport, body)
            assert terminal.get("done") and tokens == control

            # -- 4. dedup: double submit executes once ----------------
            target_srv, target_httpd = replicas[(killed["index"] + 1) % 3]
            tport = target_httpd.server_address[1]
            stats0 = target_srv.batcher_stats("lm") or {}
            pbody = {"instances": [{"tokens": prompt}]}
            hdrs = {"x-kft-idempotency-key": "survivable-e2e-1"}
            s1, payload1 = predict_via(tport, pbody, headers=hdrs)
            s2, payload2 = predict_via(tport, pbody, headers=hdrs)
            assert (s1, s2) == (200, 200)
            assert payload1 == payload2, "dedup hit changed the payload"
            stats1 = target_srv.batcher_stats("lm") or {}
            assert stats1.get("requests", 0) \
                == stats0.get("requests", 0) + 1, (
                "double submit executed twice", stats0, stats1)

            # -- 5. /metrics deltas -----------------------------------
            after = scrape(rport)
            assert metric_delta(before, after, "kft_router_replays_total",
                                outcome="ok") >= 1
            assert metric_delta(before, after,
                                "kft_serving_dedup_hits_total",
                                model="lm") >= 1
            assert metric_delta(before, after,
                                "kft_router_resume_tokens_count") >= 1
            prior = {tuple(sorted(labels.items())): v for labels, v in
                     before.get("kft_router_requests_total", ())}
            bad = {tuple(sorted(labels.items())): v for labels, v in
                   after.get("kft_router_requests_total", ())
                   if labels.get("code") in ("502", "504")
                   and v > prior.get(tuple(sorted(labels.items())), 0)}
            assert not bad, bad
        finally:
            close_fleet(router, router_httpd, replicas)
    return {"prompt": prompt, "control": control,
            "streams": [r[2] for r in results.values()],
            "killed": killed["index"]}


def kv_spill_smoke(namespace: str = "kubeflow-test", device=None,
                   params=None) -> Dict[str, Any]:
    """The host KV tier behind the router: three engine replicas with a
    12-page device pool and a 60-page host tier.

      1. control: uninterrupted turn-1 and turn-2 streams on replica 0;
      2. spill under pressure: five sessions park their KV on replica 1
         (and session 1 on replica 2 too); the overflow spills to host
         memory with no shed and no destructive eviction;
      3. re-import: session 0's turn 2 re-imports its spilled pages and
         streams bit-identical to the control;
      4. resume by fetch: session 1's turn 2 through the router is
         killed mid-generation; the replay fetches the session's pages
         from a surviving peer (kft_router_kv_fetch_total{outcome="ok"})
         and the spliced stream equals the control.
    """
    import numpy as np

    from kubeflow_tpu_torch.runtime.prom import sample_value
    from kubeflow_tpu_torch.testing import faults

    max_new = 12
    rng = np.random.RandomState(20260807)
    prompts = [rng.randint(1, 120, size=(9 + i,)).tolist()
               for i in range(5)]
    scenario = os.environ.get(faults.ENV) or \
        "seed=20260807;engine.step:sleep=0.02"
    engine = dict(lm_engine_slots=2, lm_engine_prefill_len=32,
                  max_queue_depth=16, kv_block_tokens=4, kv_pool_blocks=12,
                  host_spill_blocks=60)
    params = params if params is not None else seeded_params(OVERRIDES)
    replicas: List[list] = []
    router = router_httpd = None
    with faults.injected(scenario) as inj, \
            tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, OVERRIDES, max_new)
        try:
            replicas = [list(make_replica(f"{tmp}/lm", device,
                                          server_cls=KillableServer,
                                          **engine))
                        for _ in range(3)]
            ports = [h.server_address[1] for _, h in replicas]
            registry = static_registry(ports, probe_interval_s=0.2,
                                        eject_threshold=3,
                                        eject_backoff_s=2.0)
            registry.refresh()
            assert len(registry.routable()) == 3, registry.describe()
            router, router_httpd = start_router(
                registry, max_tries=3, max_replays=2, try_timeout_s=180.0)
            rport = router_httpd.server_address[1]

            def turn1_body(i, park=False):
                b = {"tokens": prompts[i], "max_new_tokens": max_new}
                if park:
                    b["park_kv"] = True
                return b

            # -- 1. uninterrupted controls on replica 0 ---------------
            controls = {}
            for i in range(len(prompts)):
                _, _, toks, term = stream_via(ports[0], turn1_body(i))
                assert term.get("done") and len(toks) == max_new
                controls[i] = toks
            extra = rng.randint(1, 120, size=(3,)).tolist()

            def turn2_body(i):
                return {"tokens": prompts[i] + controls[i] + extra,
                        "max_new_tokens": max_new}

            control2 = {}
            for i in (0, 1):
                _, _, toks, term = stream_via(ports[0], turn2_body(i))
                assert term.get("done"), term
                control2[i] = toks
            before = scrape(rport)
            spills_before = inj.fired("engine.spill")

            def delta(name, **labels):
                # Engine-labeled reads pin engine="lm-v1": the registry
                # is process-wide and other engines register first.
                return metric_delta(before, scrape(rport), name, **labels)

            # -- 2. parked sessions overflow the pool into host RAM --
            for i in range(len(prompts)):
                _, _, toks, term = stream_via(ports[1],
                                              turn1_body(i, park=True))
                assert term.get("done") and toks == controls[i], (
                    f"parked session {i} diverged", toks)
            _, _, toks, _ = stream_via(ports[2], turn1_body(1, park=True))
            assert toks == controls[1]
            assert inj.fired("engine.spill") > spills_before
            assert delta("kft_engine_kv_spill_total", engine="lm-v1",
                         direction="out") > 0
            assert (sample_value(scrape(rport),
                                 "kft_engine_host_tier_blocks",
                                 engine="lm-v1") or 0) > 0
            assert delta("kft_engine_kv_shed_no_blocks_total",
                         engine="lm-v1") == 0, (
                "pool-exhaustion shed while spillable mass existed")
            st1 = replicas[1][0].batcher_stats("lm") or {}
            assert st1.get("shed", 0) == 0, st1
            assert st1.get("parked_sessions") == len(prompts)
            assert st1.get("tokens_addressable") == (12 + 60) * 4
            assert st1.get("kv_spill_ratio", 0) > 0

            # -- 3. turn-2 re-import: bit-identical to the control ----
            _, _, toks, term = stream_via(ports[1], turn2_body(0))
            assert term.get("done") and toks == control2[0], (
                "re-imported resume diverged from control", toks,
                control2[0])
            assert delta("kft_engine_kv_spill_total", engine="lm-v1",
                         direction="in") > 0, (
                "turn 2 did not re-import spilled pages")

            # -- 4. kill mid-generation; resume by FETCH from a peer --
            killed: Dict[str, int] = {}
            _, _, fetched, term = stream_via(
                rport, turn2_body(1), on_tokens=kill_serving_replica(
                    replicas, killed, threading.Lock()))
            assert killed, "the kill never fired"
            assert term is not None and term.get("done"), term
            assert fetched == control2[1], (
                "fetch-resumed stream diverged from control", fetched,
                control2[1])
            assert delta("kft_router_kv_fetch_total", outcome="ok") >= 1
            assert delta("kft_router_replays_total", outcome="ok") >= 1
            assert inj.fired("engine.fetch") >= 1
        finally:
            close_fleet(router, router_httpd, replicas)
    return {"prompts": prompts, "controls": [controls[i]
                                             for i in range(len(prompts))],
            "extra": extra, "control2": [control2[0], control2[1]],
            "fetched": fetched}


def _start_mesh_decode(base: str, device, mesh: str, **engine):
    """The decode replica as ``serving.main --mesh ...`` processes over
    gloo (one a rank, as the port's tensor-parallel server runs);
    returns (procs, rest port, stderr lines)."""
    ranks = int(mesh.split("=")[1])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    flags = ["--model_name", "lm", "--model_base_path", base,
             "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
             "--poll_interval_s", "60", "--mesh", mesh, "--role", "decode",
             "--lm_engine_slots", str(engine["lm_engine_slots"]),
             "--lm_engine_prefill_len", str(engine["lm_engine_prefill_len"]),
             "--kv_block_tokens", str(engine["kv_block_tokens"]),
             "--max_queue_depth", str(engine["max_queue_depth"])]
    if device is not None:
        flags += ["--device", str(device)]
    procs, lines = [], {r: [] for r in range(ranks)}
    for rank in range(ranks):
        env = dict(os.environ, KFT_NUM_PROCESSES=str(ranks),
                   KFT_PROCESS_ID=str(rank),
                   KFT_COORDINATOR_ADDRESS=coordinator,
                   KFT_DIST_BACKEND="gloo", OMP_NUM_THREADS="1",
                   PYTHONUNBUFFERED="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
             *flags], env=env, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=str(Path(__file__).resolve().parents[2])))

    def pump(rank):
        for line in procs[rank].stderr:
            lines[rank].append(line)

    for rank in range(ranks):
        threading.Thread(target=pump, args=(rank,), daemon=True).start()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        ready = [ln for ln in list(lines[0])
                 if ln.startswith("KFT_SERVING_READY")]
        if ready:
            port = int(ready[0].split("rest=")[1].split()[0])
            return procs, port, lines
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    _stop_procs(procs)
    raise AssertionError("mesh decode replica never became ready: "
                         + "".join(lines[0] + lines.get(1, []))[-3000:])


def _stop_procs(procs) -> List[Optional[int]]:
    if procs and procs[0].poll() is None:
        procs[0].send_signal(signal.SIGTERM)
    codes: List[Optional[int]] = []
    for p in procs:
        try:
            codes.append(p.wait(60))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(10)
            codes.append(None)
    return codes


def multichip_serving_smoke(namespace: str = "kubeflow-test", device=None,
                            params=None, mesh: Optional[str] = None
                            ) -> Dict[str, Any]:
    """Tiered serving behind the router: a prefill-role replica and a
    decode-role replica (with ``mesh="tensor=2"``, two ``serving.main
    --mesh tensor=2 --role decode`` processes; without, one device in
    process), and a unified replica outside the fleet as the control.

      1. the registry learns both tiers off /readyz;
      2. tiered :generate streams through the router equal the unified
         control's exactly;
      3. kft_engine_handoff_pages_total{direction="export"} on the
         prefill replica and {direction="import"} on the decode replica,
         and kft_router_tier_requests_total{tier}, move as deltas; the
         decode replica's :stats show its mesh devices, pages in and its
         kv_import program;
      4. with the only decode replica dead, a tiered :generate sheds a
         typed 429 with Retry-After instead of hanging or 502ing.
    """
    import numpy as np

    max_new = 10
    rng = np.random.RandomState(20260804)
    prompts = [rng.randint(1, 96, size=(n,)).tolist() for n in (9, 12, 16)]
    engine = dict(lm_engine_slots=2, lm_engine_prefill_len=32,
                  kv_block_tokens=4, max_queue_depth=16)
    params = params if params is not None \
        else seeded_params(MULTICHIP_OVERRIDES)
    servers: List[Any] = []
    procs: List[Any] = []
    router = router_httpd = None
    tiered: List[List[int]] = []
    with tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, MULTICHIP_OVERRIDES, max_new)
        try:
            pre_srv, pre_httpd = make_replica(
                f"{tmp}/lm", device, role="prefill",
                server_cls=KillableServer, **engine)
            servers.append((pre_srv, pre_httpd))
            if mesh:
                procs, dec_port, _ = _start_mesh_decode(f"{tmp}/lm", device,
                                                        mesh, **engine)
            else:
                dec_srv, dec_httpd = make_replica(
                    f"{tmp}/lm", device, role="decode",
                    server_cls=KillableServer, **engine)
                servers.append((dec_srv, dec_httpd))
                dec_port = dec_httpd.server_address[1]
            uni_srv, uni_httpd = make_replica(f"{tmp}/lm", device,
                                              **engine)
            servers.append((uni_srv, uni_httpd))
            pre_port = pre_httpd.server_address[1]
            uni_port = uni_httpd.server_address[1]
            registry = static_registry([pre_port, dec_port],
                                        names=["pre-0", "dec-0"],
                                        probe_interval_s=0.2,
                                        eject_threshold=2)
            registry.refresh()
            tiers = {s.name: s.tier for s in registry.all()}
            assert tiers == {"pre-0": "prefill", "dec-0": "decode"}, (
                f"registry failed to learn tiers: {tiers}")
            router, router_httpd = start_router(registry, max_tries=3,
                                                 try_timeout_s=60.0)
            rport = router_httpd.server_address[1]
            pre0, dec0, r0 = scrape(pre_port), scrape(dec_port), \
                scrape(rport)

            # --- tiered streams match the unified control exactly ---
            for prompt in prompts:
                body = {"tokens": prompt}
                st, _, want, wterm = stream_via(uni_port, body)
                assert st == 200 and wterm.get("done"), (st, wterm)
                st, _, got, gterm = stream_via(rport, body)
                assert st == 200, (st, got)
                assert gterm.get("done"), gterm
                assert got == want, (
                    f"tiered stream diverged from unified control for "
                    f"len {len(prompt)}: {got} != {want}")
                tiered.append(got)

            # --- handoff + tier counters moved as deltas ------------
            pre1, dec1, r1 = scrape(pre_port), scrape(dec_port), \
                scrape(rport)
            assert metric_delta(pre0, pre1, "kft_engine_handoff_pages_total",
                                engine="lm-v1", direction="export") > 0, \
                "no pages exported by the prefill tier"
            assert metric_delta(dec0, dec1, "kft_engine_handoff_pages_total",
                                engine="lm-v1", direction="import") > 0, \
                "no pages imported by the decode tier"
            assert metric_delta(r0, r1, "kft_router_tier_requests_total",
                                tier="prefill") == len(prompts)
            assert metric_delta(r0, r1, "kft_router_tier_requests_total",
                                tier="decode") == len(prompts)
            dec_stats = get_json(dec_port, "/model/lm:stats")["batcher"]
            assert dec_stats["mesh_devices"] == (
                int(mesh.split("=")[1]) if mesh else 1), dec_stats
            assert dec_stats["handoff_pages_in"] > 0
            assert dec_stats["compiled_programs"]["kv_import"] == 1

            # --- decode-pool death mid-handoff: typed Overloaded ----
            if mesh:
                codes = _stop_procs(procs)
                assert codes == [0] * len(procs), codes
                procs = []
            else:
                dec_httpd.kill()
            # No probe ran since the kill: the router commits to the
            # tiered path, the prefill leg succeeds, and the dead decode
            # pool must shed a typed 429.
            st, headers, payload, _ = stream_via(rport,
                                                 {"tokens": prompts[0]})
            assert st == 429, (st, payload)
            assert "Retry-After" in headers, headers
            r2 = scrape(rport)
            assert metric_delta(r1, r2, "kft_router_requests_total",
                                outcome="shed", code="429") >= 1
        finally:
            close_fleet(router, router_httpd, servers)
            _stop_procs(procs)
    return {"prompts": prompts, "tiered": tiered}


def adapter_serving_smoke(namespace: str = "kubeflow-test", device=None,
                          params=None) -> Dict[str, Any]:
    """Per-tenant adapters over a two-replica engine fleet behind the
    router, every variant riding the base model's programs.

      1. hot-load under live traffic: while base clients stream, the
         first lm@alpha / lm@beta requests load their artifacts; every
         answer equals a sequential per-adapter control server's;
      2. a co-batched mixed burst: all complete, all equal to their
         controls, and each engine reports only the base program set;
      3. evict under pressure: with 2 registry slots, a gamma request
         against a replica holding an in-flight alpha generation evicts
         the idle beta, never the pinned alpha;
      4. /readyz advertises the resident adapters' digests, routed
         lm@alpha traffic prefers warm replicas
         (kft_router_adapter_affinity_total{outcome="hit"}), and an
         unknown adapter answers a typed 404 through the router.
    """
    import numpy as np

    from kubeflow_tpu_torch.serving.adapters import (
        random_adapter_factors,
        save_adapter,
    )
    from kubeflow_tpu_torch.serving.loaders import _model_config
    from kubeflow_tpu_torch.serving.main import batcher_factory
    from kubeflow_tpu_torch.serving.model_server import ModelServer
    from kubeflow_tpu_torch.testing import faults

    cfg = _model_config(ADAPTER_OVERRIDES)
    max_new, rank = 8, 4
    scenario = os.environ.get(faults.ENV) or \
        "seed=20260807;engine.step:sleep=0.01"
    rng = np.random.RandomState(20260807)
    prompts = [rng.randint(1, 96, size=(n,)).tolist() for n in (8, 5, 11, 9)]
    tenants = ("alpha", "beta", "gamma")
    params = params if params is not None \
        else seeded_params(ADAPTER_OVERRIDES)
    replicas: List[Any] = []
    router = router_httpd = control = None
    want: Dict[Any, List[int]] = {}
    with faults.injected(scenario), tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, ADAPTER_OVERRIDES, max_new)
        adir = f"{tmp}/adapters"
        os.makedirs(adir)
        for i, name in enumerate(tenants):
            save_adapter(f"{adir}/{name}.npz", random_adapter_factors(
                cfg, rank, seed=100 + i, scale=0.5))

        def predict(port, name, prompt):
            return predict_via(port, {"instances": [{"tokens": prompt}]},
                               path=f"/model/{name}:predict")

        try:
            # -- sequential per-adapter controls ----------------------
            control = ModelServer(device=device)
            control.add_model("lm", f"{tmp}/lm")
            control.enable_batching("lm", batcher_factory(
                micro_batch_size=0, batch_timeout_s=0.005, lm_engine=True,
                lm_engine_slots=1, lm_engine_prefill_len=16,
                adapters_dir=adir, adapter_slots=3, adapter_rank=rank))
            for name in ("lm", "lm@alpha", "lm@beta", "lm@gamma"):
                for p in prompts:
                    out = control.predict(
                        name, {"tokens": np.asarray(p, np.int32)[None]})
                    want[(name, tuple(p))] = \
                        np.asarray(out["tokens"])[0].tolist()
            assert want[("lm@alpha", tuple(prompts[0]))] != \
                want[("lm", tuple(prompts[0]))], (
                "adapter delta too small to move greedy decode")

            # -- fleet assembly --------------------------------------
            replicas = [make_replica(
                f"{tmp}/lm", device, lm_engine_slots=3,
                lm_engine_prefill_len=16, kv_block_tokens=4,
                max_queue_depth=16, adapters_dir=adir, adapter_slots=2,
                adapter_rank=rank) for _ in range(2)]
            ports = [h.server_address[1] for _, h in replicas]
            registry = static_registry(ports, probe_interval_s=0.2,
                                        eject_threshold=2)
            registry.refresh()
            assert len(registry.routable()) == 2, registry.describe()
            router, router_httpd = start_router(registry, max_tries=3,
                                                 try_timeout_s=180.0)
            rport = router_httpd.server_address[1]
            m0 = scrape(ports[0])

            # -- 1. hot-load under live base traffic -----------------
            results: Dict[int, Any] = {}

            def client(i, name, prompt):
                results[i] = (name, prompt, predict(rport, name, prompt))

            base_threads = [threading.Thread(
                target=client, args=(i, "lm", prompts[i % 2]))
                for i in range(4)]
            for t in base_threads:
                t.start()
            hot_threads = [threading.Thread(
                target=client, args=(4 + j, f"lm@{name}", prompts[2 + j % 2]))
                for j, name in enumerate(("alpha", "beta"))]
            for t in hot_threads:
                t.start()
            for t in base_threads + hot_threads:
                t.join(timeout=WAIT_S)
            assert len(results) == 6
            for name, prompt, (code, payload) in results.values():
                assert code == 200, (name, code, payload)
                assert payload["predictions"][0]["tokens"] \
                    == want[(name, tuple(prompt))], (
                    f"{name} diverged from its sequential control under "
                    f"the hot-load burst")

            # -- 2. co-batched mixed burst ---------------------------
            results = {}
            mixed = [("lm", prompts[0]), ("lm@alpha", prompts[1]),
                     ("lm@beta", prompts[2]), ("lm@alpha", prompts[3]),
                     ("lm", prompts[2]), ("lm@beta", prompts[0]),
                     ("lm@alpha", prompts[2]), ("lm", prompts[1]),
                     ("lm@beta", prompts[3])]
            threads = [threading.Thread(target=client, args=(i, n, p))
                       for i, (n, p) in enumerate(mixed)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert sorted(r[2][0] for r in results.values()) \
                == [200] * len(mixed), results
            for name, prompt, (_, payload) in results.values():
                assert payload["predictions"][0]["tokens"] \
                    == want[(name, tuple(prompt))], (
                    f"{name} diverged from its sequential control in the "
                    f"co-batched burst")
            for i, (srv, _) in enumerate(replicas):
                programs = (srv.batcher_stats("lm") or {}).get(
                    "compiled_programs") or {}
                assert {k for k, v in programs.items() if v} <= \
                    {"chunked_prefill", "step"}, (
                    f"replica {i} grew extra programs under mixed adapter "
                    f"traffic: {programs}")

            # -- 3. evict-under-pressure with a live pin -------------
            srv0, port0 = replicas[0][0], ports[0]
            for name in ("lm@alpha", "lm@beta"):
                code, payload = predict(port0, name, prompts[0])
                assert code == 200, (name, code, payload)
            m_before = scrape(port0)
            inflight0 = srv0.inflight()
            holder: Dict[str, Any] = {}
            t = threading.Thread(target=lambda: holder.update(
                resp=predict(port0, "lm@alpha", prompts[3])))
            t.start()
            _wait(lambda: srv0.inflight() > inflight0, 60,
                  "pinned alpha request never started", poll=0.005)
            code, payload = predict(port0, "lm@gamma", prompts[1])
            assert code == 200, (code, payload)
            assert payload["predictions"][0]["tokens"] \
                == want[("lm@gamma", tuple(prompts[1]))]
            t.join(timeout=WAIT_S)
            code, payload = holder["resp"]
            assert code == 200, ("the in-flight alpha request was dropped "
                                 "by the eviction", code, payload)
            assert payload["predictions"][0]["tokens"] \
                == want[("lm@alpha", tuple(prompts[3]))], (
                "the pinned alpha generation was corrupted by the gamma "
                "load")
            resident = {a["name"] for a in srv0.adapter_info().get("lm", ())}
            assert "alpha" in resident and "gamma" in resident, resident
            assert "beta" not in resident, (
                "eviction took the wrong victim", resident)
            assert metric_delta(m_before, scrape(port0),
                                "kft_engine_adapter_evictions_total",
                                engine="lm-v1") >= 1
            code, payload = predict(port0, "lm@beta", prompts[0])
            assert code == 200
            assert payload["predictions"][0]["tokens"] \
                == want[("lm@beta", tuple(prompts[0]))]

            # -- 4. advertisement + affinity + typed sheds -----------
            code, _ = predict(port0, "lm@alpha", prompts[0])
            assert code == 200
            resident = {a["name"] for a in srv0.adapter_info().get("lm", ())}
            assert "alpha" in resident, resident
            ready = get_json(port0, "/readyz")
            advertised = {a["name"]: a["digest"]
                          for a in ready.get("adapters", {}).get("lm", ())}
            assert set(advertised) == resident, ready
            assert all(len(d) == 64 for d in advertised.values())
            registry.refresh()
            r_before = scrape(rport)
            for _ in range(4):
                code, payload = predict(rport, "lm@alpha", prompts[0])
                assert code == 200
                assert payload["predictions"][0]["tokens"] \
                    == want[("lm@alpha", tuple(prompts[0]))]
            assert metric_delta(r_before, scrape(rport),
                                "kft_router_adapter_affinity_total",
                                outcome="hit") >= 4, (
                "routed lm@alpha traffic never hit the warm subset")
            code, payload = predict(rport, "lm@ghost", prompts[0])
            assert code == 404, ("unknown adapter must shed typed 404 "
                                 "through the router", code, payload)

            # -- engine adapter counters moved as /metrics deltas ----
            m1 = scrape(ports[0])
            assert metric_delta(m0, m1, "kft_engine_adapter_loads_total",
                                engine="lm-v1", adapter="alpha") >= 1
            assert metric_delta(m0, m1, "kft_engine_adapter_requests_total",
                                engine="lm-v1", adapter="alpha") >= 1
            total_loads = sum(
                metric_delta(m0, m1, "kft_engine_adapter_loads_total",
                             engine="lm-v1", adapter=name)
                for name in tenants)
            assert total_loads >= 4, (
                "expected the initial loads + the beta reload", total_loads)
        finally:
            if control is not None:
                control.stop()
            close_fleet(router, router_httpd, replicas)
    return {"prompts": prompts,
            "want": {f"{n}|{','.join(map(str, p))}": v
                     for (n, p), v in want.items()}}


# -- the control plane: operator and cluster scheduler --------------------

# JAX scenario slice names -> the port's shapes with as many hosts and,
# for the one-host shape, as many chips (an h100-32 gang holds 32 GPUs on
# the 4 hosts where a v5p-32 slice holds 16 chips).
SLICE_MAP = {"v5e-8": "h100-8", "v5p-32": "h100-32"}


def _start_apiserver():
    """The fake apiserver and an HttpKube on it: (httpd, kube, store)."""
    from kubeflow_tpu_torch.operator.kube_http import HttpKube
    from kubeflow_tpu_torch.testing.fake_apiserver import make_fake_apiserver

    apiserver, _, store = make_fake_apiserver()
    kube = HttpKube(base_url=f"http://127.0.0.1:"
                             f"{apiserver.server_address[1]}")
    return apiserver, kube, store


def _stop_apiserver(apiserver) -> None:
    if apiserver is not None:
        apiserver.shutdown()
        apiserver.server_close()


def _set_job_pods(kube, store, namespace: str, job: str,
                  phase: str) -> None:
    for p in kube.list_pods(namespace, labels={LABEL_JOB: job}):
        store.set_pod_phase(namespace, p["metadata"]["name"], phase)


def _checkpoint_victim(directory: str, steps: int = 5,
                       width: int = 8) -> None:
    """A victim gang's trainer checkpoints steps 0..steps-1 (its state:
    a step counter and ``arange(width) + step``)."""
    import torch

    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    base = torch.arange(width, dtype=torch.float32)
    with CheckpointManager(directory) as mgr:
        for step in range(steps):
            mgr.save(step, {"step": torch.tensor(step, dtype=torch.int32),
                            "w": base + step})


def _assert_victim_resumes(directory: str, steps: int = 5,
                           width: int = 8) -> None:
    """The re-admitted gang restores its newest step and continues past
    it: never step 0."""
    import torch

    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

    fresh = {"step": torch.zeros((), dtype=torch.int32),
             "w": torch.zeros(width)}
    with CheckpointManager(directory) as mgr:
        restored, start = mgr.restore_or_init(fresh)
    assert start == steps, f"resume restarted at {start}"
    assert int(restored["step"]) == steps - 1
    assert torch.equal(restored["w"], torch.arange(
        width, dtype=torch.float32) + steps - 1)


def tpujob_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """Submit a tiny TPUJob to the in-process control plane and drive it
    to completion (the JAX ``tpujob`` scenario; ``device`` is unused:
    the control plane runs on the host)."""
    from kubeflow_tpu_torch.operator import crd
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.operator.kube import RUNNING, SUCCEEDED, FakeKube
    from kubeflow_tpu_torch.operator.reconciler import (
        JOB_RUNNING,
        JOB_SUCCEEDED,
        TPUJobController,
    )

    kube = FakeKube()
    controller = TPUJobController(kube, GangScheduler(
        {SLICE_MAP["v5e-8"]: 1}))
    job = crd.TPUJobSpec(name="smoke", namespace=namespace,
                         slice_type=SLICE_MAP["v5e-8"])
    kube.create_custom(job.to_custom_resource())
    cr = kube.list_custom()[0]
    controller.reconcile_once(cr)
    for pod in kube.list_pods(namespace):
        kube.set_pod_phase(namespace, pod["metadata"]["name"], RUNNING)
    assert controller.reconcile_once(cr) == JOB_RUNNING
    for pod in kube.list_pods(namespace):
        kube.set_pod_phase(namespace, pod["metadata"]["name"], SUCCEEDED)
    assert controller.reconcile_once(cr) == JOB_SUCCEEDED


def scheduler_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """Two tenants' TPUJobs through the fake apiserver (real sockets,
    HttpKube) against the port's policy layer, gang and reconciler (the
    JAX ``scheduler`` scenario): a quota-capped greedy tenant, backfill
    past a blocked large job, priority preemption through the clock-
    skewed grace window with a victim that resumes from its newest
    checkpoint step, and every outcome in ``kft_scheduler_*`` metrics."""
    from kubeflow_tpu_torch.operator import crd
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.operator.reconciler import (
        JOB_PREEMPTING,
        JOB_SUCCEEDED,
        QUEUED,
        STARTING,
        TPUJobController,
    )
    from kubeflow_tpu_torch.runtime.prom import (
        REGISTRY,
        parse_metrics,
        sample_value,
    )
    from kubeflow_tpu_torch.scheduler import (
        LABEL_PRIORITY,
        LABEL_TENANT,
        ClusterScheduler,
        PreemptionConfig,
        SchedulerConfig,
    )
    from kubeflow_tpu_torch.testing import faults

    small, large = SLICE_MAP["v5e-8"], SLICE_MAP["v5p-32"]

    def make_cr(name, tenant, priority, slice_type=small, n=1):
        job = crd.TPUJobSpec(name=name, namespace=namespace,
                             slice_type=slice_type, num_slices=n)
        cr = job.to_custom_resource()
        cr["metadata"]["labels"] = {LABEL_TENANT: tenant,
                                    LABEL_PRIORITY: priority}
        return cr

    apiserver = None
    with faults.injected("seed=20260804") as inj, \
            tempfile.TemporaryDirectory() as tmp:
        try:
            apiserver, kube, store = _start_apiserver()
            gang = GangScheduler({small: 4, large: 1})
            cluster = ClusterScheduler(gang, SchedulerConfig(
                quotas={"greedy": {small: 16}},
                preemption=PreemptionConfig(grace_period_s=30.0)))
            ctl = TPUJobController(kube, gang, cluster)

            def statuses():
                return {c["metadata"]["name"]: (c.get("status") or {})
                        for c in kube.list_custom(namespace)}

            # -- 1. quota-capped greedy tenant ------------------------
            for i in range(3):
                kube.create_custom(
                    make_cr(f"greedy-{i}", "greedy", "normal"))
            kube.create_custom(make_cr("polite", "polite", "normal"))
            ctl.reconcile_all()
            st = statuses()
            admitted = sorted(n for n in st
                              if st[n].get("phase") == STARTING)
            assert admitted == ["greedy-0", "greedy-1", "polite"], st
            assert st["greedy-2"]["phase"] == QUEUED
            assert st["greedy-2"]["reason"] == "QuotaExceeded", st

            # -- 2. backfill past a blocked large job -----------------
            kube.create_custom(make_cr("vp-run", "research", "high",
                                       slice_type=large))
            ctl.reconcile_all()
            kube.create_custom(make_cr("vp-blocked", "research", "high",
                                       slice_type=large))
            kube.create_custom(make_cr("small-low", "batch", "low"))
            ctl.reconcile_all()
            st = statuses()
            assert st["vp-blocked"]["reason"] == "WaitingForSlices", st
            assert st["small-low"]["phase"] == STARTING, st
            assert cluster.status()["counters"]["backfilled"] >= 1
            # ETA unchanged: vp-run ends, vp-blocked starts at once
            # with the backfilled job still holding its small gang.
            _set_job_pods(kube, store, namespace, "vp-run", "Running")
            ctl.reconcile_all()
            _set_job_pods(kube, store, namespace, "vp-run", "Succeeded")
            ctl.reconcile_all()
            ctl.reconcile_all()
            st = statuses()
            assert st["vp-run"]["phase"] == JOB_SUCCEEDED
            assert st["vp-blocked"]["phase"] == STARTING, st
            assert st["small-low"]["phase"] == STARTING, st

            # -- 3. preemption -> checkpoint grace -> resume ----------
            _checkpoint_victim(f"{tmp}/victim-ckpt")
            kube.create_custom(make_cr("vip", "prod", "high"))
            ctl.reconcile_all()
            st = statuses()
            assert st["small-low"]["phase"] == JOB_PREEMPTING, st
            assert st["small-low"]["resumable"] is True
            assert kube.list_pods(
                namespace, labels={LABEL_JOB: "small-low"}), \
                "pods must survive the checkpoint grace window"
            ctl.reconcile_all()
            assert statuses()["small-low"]["phase"] == JOB_PREEMPTING
            inj.advance_clock(31)   # grace elapses, zero wall waiting
            ctl.reconcile_all()
            st = statuses()
            assert st["small-low"]["phase"] == QUEUED
            assert st["small-low"]["reason"] == "PreemptedRequeued", st
            ctl.reconcile_all()
            st = statuses()
            assert st["vip"]["phase"] == STARTING, st
            _set_job_pods(kube, store, namespace, "vip", "Running")
            ctl.reconcile_all()
            _set_job_pods(kube, store, namespace, "vip", "Succeeded")
            ctl.reconcile_all()
            ctl.reconcile_all()
            st = statuses()
            assert st["vip"]["phase"] == JOB_SUCCEEDED
            assert st["small-low"]["phase"] == STARTING, st
            assert st["small-low"]["resumable"] is False
            assert int(st["small-low"]["preemptions"]) == 1
            assert int(st["small-low"].get("restarts", 0)) == 0, \
                "preemption must not consume the restart budget"
            _assert_victim_resumes(f"{tmp}/victim-ckpt")

            # -- 4. outcomes in kft_scheduler_* metrics ---------------
            parsed = parse_metrics(REGISTRY.render())
            for name in ("kft_scheduler_preemptions_total",
                         "kft_scheduler_backfills_total",
                         "kft_scheduler_resumes_total"):
                assert (sample_value(parsed, name, tenant="batch")
                        or 0) >= 1, parsed.get(name)
            assert sample_value(parsed, "kft_scheduler_quota_chips",
                                tenant="greedy", slice_type=small) == 16
            assert sample_value(parsed, "kft_scheduler_queue_depth",
                                tenant="greedy",
                                priority="normal") is not None
            assert "kft_scheduler_queue_wait_seconds_count" in parsed
        finally:
            _stop_apiserver(apiserver)


# The JAX train_resilience / hfta scenarios' tiny LM.
TRAIN_OVERRIDES = dict(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                       n_kv_heads=2, d_ff=32, head_dim=8, max_seq_len=16)
# Their batch: 2 a device over the JAX test suite's 8 CPU devices.
TRAIN_BATCH = 16


def train_resilience_smoke(namespace: str = "kubeflow-test",
                           device=None) -> Dict[str, Any]:
    """Crash-safe training on the port (the JAX ``train_resilience``
    scenario): the tiny LM trains in float32 under ``TrainSupervisor``
    with an injected ``train.step`` raise and resumes from a verified
    checkpoint (never step 0) with final parameters bit-identical to an
    uninterrupted control; a truncated newest checkpoint is walked back
    over; a TPUJob flapping on one node over the fake apiserver gets
    the node quarantined and the re-placed gang kept off it; every
    outcome moves its ``kft_*`` metric.  Returns the final and control
    parameters."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.operator import crd
    from kubeflow_tpu_torch.operator.gang import GangScheduler, NodeQuarantine
    from kubeflow_tpu_torch.operator.kube import FAILED, RUNNING
    from kubeflow_tpu_torch.operator.reconciler import TPUJobController
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
    from kubeflow_tpu_torch.runtime.prom import (
        REGISTRY,
        parse_metrics,
        sample_value,
    )
    from kubeflow_tpu_torch.runtime.supervisor import TrainSupervisor
    from kubeflow_tpu_torch.runtime.train import Trainer
    from kubeflow_tpu_torch.testing import faults

    def metric(parsed, name, **labels):
        return sample_value(parsed, name, **labels) or 0.0

    before = parse_metrics(REGISTRY.render())
    cfg = TransformerConfig(dtype=torch.float32, **TRAIN_OVERRIDES)
    init_fn, loss_fn = lm_task(cfg, device=device)
    batch, steps = TRAIN_BATCH, 8

    def data_factory():
        rng = np.random.RandomState(0)
        while True:
            yield {"tokens": rng.randint(
                0, cfg.vocab_size, size=(batch, 16)).astype(np.int32)}

    def make_trainer(ckpt_dir):
        return Trainer(
            init_fn=init_fn, loss_fn=loss_fn, tx=optim.adamw(1e-3),
            device=device,
            checkpoints=CheckpointManager(ckpt_dir, max_to_keep=3),
            checkpoint_every=2,
            metrics=MetricsLogger(stream=open(os.devnull, "w")))

    def params(state):
        return {k: v.detach().cpu().clone()
                for k, v in state.params.state_dict().items()}

    with faults.injected("seed=20260804") as inj, \
            tempfile.TemporaryDirectory() as tmp:
        # -- control: one uninterrupted run ---------------------------
        control = make_trainer(f"{tmp}/control")
        control_state = TrainSupervisor(control, max_restarts=0).run(
            data_factory, steps, examples_per_step=batch, log_every=0)
        control.checkpoints.wait()

        # -- 1. supervised resume from a verified step ----------------
        trainer = make_trainer(f"{tmp}/victim")
        sup = TrainSupervisor(trainer, max_restarts=2, backoff_s=5.0)
        sup.run(data_factory, 4, examples_per_step=batch, log_every=0)
        assert trainer.checkpoints.latest_verified_step() == 3
        # Fault the FIRST step of the continuation; the skew entry
        # ages the policy clock past the restart backoff.
        faults.install(faults.parse(
            "train.step:raise*1;train.step:skew=60"))
        try:
            final = sup.run(data_factory, steps,
                            examples_per_step=batch, log_every=0)
        finally:
            faults.install(inj)
        assert sup.restarts == 1, sup.stats()
        boundaries = sup.steps_seen
        assert boundaries == sorted(boundaries), boundaries
        assert boundaries[-1] == steps
        assert min(b for b in boundaries if b > 4) == 5, boundaries
        got, want = params(final), params(control_state)
        assert got.keys() == want.keys()
        for k in got:   # loss identity: bit for bit
            assert torch.equal(got[k], want[k]), k

        # -- 2. corrupt latest -> walk-back restore -------------------
        trainer.checkpoints.wait()
        ckpt_dir = Path(f"{tmp}/victim")
        all_steps = trainer.checkpoints.all_steps()
        latest = all_steps[-1]
        victim_file = max(
            (p for p in (ckpt_dir / str(latest)).rglob("*")
             if p.is_file()), key=lambda p: p.stat().st_size)
        victim_file.write_bytes(victim_file.read_bytes()[:16])
        restored, start = trainer.checkpoints.restore_or_init(
            trainer.create_state())
        prev_verified = max(s for s in all_steps if s != latest)
        assert start == prev_verified + 1, (
            f"walk-back resumed at {start}, want {prev_verified + 1}")

        # -- 3. node flap -> quarantine + gang re-place ---------------
        apiserver = None
        try:
            apiserver, kube, store = _start_apiserver()
            ctl = TPUJobController(
                kube, GangScheduler({SLICE_MAP["v5e-8"]: 1}),
                quarantine=NodeQuarantine(threshold=3, window_s=600,
                                          cooldown_s=1800))
            kube.create_custom(crd.TPUJobSpec(
                name="flappy", namespace=namespace,
                slice_type=SLICE_MAP["v5e-8"]).to_custom_resource())
            for _ in range(3):  # three worker failures on one node
                ctl.reconcile_all()
                for p in kube.list_pods(namespace):
                    store.set_pod_node(namespace, p["metadata"]["name"],
                                       "node-flap")
                    store.set_pod_phase(namespace, p["metadata"]["name"],
                                        RUNNING)
                ctl.reconcile_all()
                pod = kube.list_pods(namespace)[0]
                store.set_pod_phase(namespace, pod["metadata"]["name"],
                                    FAILED)
                ctl.reconcile_all()
            assert ctl.quarantine.quarantined() == ["node-flap"]
            events = [e for e in store.events
                      if e["reason"] == "NodeQuarantined"]
            assert len(events) == 1, events
            ctl.reconcile_all()
            pods = kube.list_pods(namespace)
            assert pods, "gang was not re-placed after quarantine"
            for p in pods:
                terms = (p["spec"]["affinity"]["nodeAffinity"]
                         ["requiredDuringSchedulingIgnoredDuring"
                          "Execution"]["nodeSelectorTerms"])
                expr = terms[0]["matchExpressions"][0]
                assert expr["operator"] == "NotIn"
                assert "node-flap" in expr["values"]
        finally:
            _stop_apiserver(apiserver)

        # -- 4. outcomes in kft_* metrics (deltas) --------------------
        parsed = parse_metrics(REGISTRY.render())
        assert metric(parsed, "kft_train_restarts_total", reason="step") \
            - metric(before, "kft_train_restarts_total",
                     reason="step") >= 1
        assert metric(parsed, "kft_checkpoint_saves_total") \
            - metric(before, "kft_checkpoint_saves_total") >= 4
        assert metric(parsed, "kft_checkpoint_verify_failures_total") \
            - metric(before, "kft_checkpoint_verify_failures_total") >= 1
        assert sample_value(parsed, "kft_operator_quarantined_nodes") == 1
        assert sample_value(
            parsed, "kft_train_heartbeat_age_seconds") is not None
    return {"final": got, "control": want}


def hfta_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """The HFTA tier's admission half on the port (the JAX ``hfta``
    scenario's steps 1-3 and 5; its step 4, the fused trainer's
    preempt/resume bit-identity, is
    ``tests/test_torch_hfta.py::test_e2e_hfta_training_lifecycle_twin``):
    two tenants' four fusable singletons admit as ONE fused gang billed
    per member, a high-priority arrival evicts the gang and every member
    resumes, one pod-gang success completes every member, and the fused
    gauges read the gang while it runs."""
    from kubeflow_tpu_torch.operator import crd
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.operator.reconciler import (
        JOB_PREEMPTING,
        JOB_SUCCEEDED,
        QUEUED,
        STARTING,
        TPUJobController,
    )
    from kubeflow_tpu_torch.runtime.prom import (
        REGISTRY,
        parse_metrics,
        sample_value,
    )
    from kubeflow_tpu_torch.scheduler import (
        LABEL_FUSE_FAMILY,
        LABEL_PRIORITY,
        LABEL_TENANT,
        ClusterScheduler,
        PreemptionConfig,
        SchedulerConfig,
    )
    from kubeflow_tpu_torch.testing import faults

    shape = SLICE_MAP["v5e-8"]

    def make_cr(name, tenant, priority="low", family="sweep"):
        job = crd.TPUJobSpec(name=name, namespace=namespace,
                             slice_type=shape, num_slices=1)
        cr = job.to_custom_resource()
        cr["metadata"]["labels"] = {LABEL_TENANT: tenant,
                                    LABEL_PRIORITY: priority,
                                    LABEL_FUSE_FAMILY: family}
        return cr

    apiserver = None
    with faults.injected("seed=20260807") as inj:
        try:
            apiserver, kube, store = _start_apiserver()
            gang = GangScheduler({shape: 1})
            cluster = ClusterScheduler(gang, SchedulerConfig(
                quotas={"tenant-a": {shape: 4}, "tenant-b": {shape: 4}},
                preemption=PreemptionConfig(grace_period_s=30.0)))
            ctl = TPUJobController(kube, gang, cluster)

            def statuses():
                return {c["metadata"]["name"]: (c.get("status") or {})
                        for c in kube.list_custom(namespace)}

            # -- 1. two tenants' singletons fold into one gang --------
            for i in range(4):
                kube.create_custom(make_cr(
                    f"m{i}", tenant=f"tenant-{'ab'[i % 2]}"))
            ctl.reconcile_all()
            st = statuses()
            gkey = f"fused:{namespace}/sweep"
            for i in range(4):
                assert st[f"m{i}"]["phase"] == STARTING, st
                assert st[f"m{i}"]["fusedGang"] == gkey, st
            assert gang.admitted(gkey)
            assert kube.list_pods(
                namespace, labels={LABEL_JOB: "fused-sweep"}), \
                "fused gang must run ONE shared pod gang"
            quotas = {q["tenant"]: q["used_chips"]
                      for q in cluster.status()["quotas"]}
            assert quotas == {"tenant-a": 4.0, "tenant-b": 4.0}, quotas
            rows = {r["job"]: r for r in cluster.status()["jobs"]}
            assert rows[f"{namespace}/m0"]["members"] == 4
            assert rows[f"{namespace}/m0"]["chips"] == 2.0
            # -- 5. the fused gauges read the running gang ------------
            parsed = parse_metrics(REGISTRY.render())
            assert sample_value(parsed, "kft_scheduler_fused_gangs") == 1.0
            assert sample_value(
                parsed, "kft_scheduler_fused_members") == 4.0

            # -- 2. preempt the gang; every member resumes ------------
            kube.create_custom(make_cr("vip", tenant="prod",
                                       priority="high", family=""))
            ctl.reconcile_all()
            st = statuses()
            for i in range(4):
                assert st[f"m{i}"]["phase"] == JOB_PREEMPTING, st
                assert st[f"m{i}"]["resumable"] is True
            inj.advance_clock(31)   # grace elapses, no wall waiting
            ctl.reconcile_all()
            st = statuses()
            for i in range(4):
                assert st[f"m{i}"]["phase"] == QUEUED, st
                assert st[f"m{i}"]["reason"] == "PreemptedRequeued"
                assert not st[f"m{i}"].get("fusedGang"), st
            assert not gang.admitted(gkey)
            ctl.reconcile_all()
            assert statuses()["vip"]["phase"] == STARTING
            _set_job_pods(kube, store, namespace, "vip", "Succeeded")
            ctl.reconcile_all()
            ctl.reconcile_all()
            st = statuses()
            assert st["vip"]["phase"] == JOB_SUCCEEDED
            for i in range(4):
                assert st[f"m{i}"]["phase"] == STARTING, st
                assert int(st[f"m{i}"]["preemptions"]) == 1
            assert gang.admitted(gkey)
            assert cluster.status()["counters"]["resumed"] == 4

            # -- 3. one pod-gang success completes every member -------
            _set_job_pods(kube, store, namespace, "fused-sweep",
                          "Succeeded")
            ctl.reconcile_all()
            st = statuses()
            for i in range(4):
                assert st[f"m{i}"]["phase"] == JOB_SUCCEEDED, st
            assert not gang.admitted(gkey)
            completed = [e for e in store.events
                         if e["reason"] == "FusedMemberCompleted"]
            assert len(completed) == 4, store.events
        finally:
            _stop_apiserver(apiserver)


def colocation_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """Train/serve colocation on one GPU pool (the JAX ``colocation``
    scenario), driven through the fake apiserver by the port's fleet
    ``Autoscaler`` in claims mode: a trough makes no claim; a burst
    writes a 2-replica claim CR that evicts the low-priority gang on the
    short serving grace while prepull pods pin the victim's nodes, and
    the reconciler patches the Deployment on grant; the evening trough
    releases the claim and the victim is backfilled and resumes from
    its newest checkpoint step; the pool snapshot rides the claim status
    back to the ServingClaimClient and every transition moves its
    metric."""
    from kubeflow_tpu_torch.fleet.autoscaler import Autoscaler
    from kubeflow_tpu_torch.operator import crd
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.operator.reconciler import (
        JOB_PREEMPTING,
        JOB_RUNNING,
        QUEUED,
        STARTING,
        TPUJobController,
    )
    from kubeflow_tpu_torch.runtime.prom import (
        REGISTRY,
        parse_metrics,
        sample_value,
    )
    from kubeflow_tpu_torch.scheduler import (
        LABEL_PRIORITY,
        LABEL_TENANT,
        ClusterScheduler,
        PreemptionConfig,
        SchedulerConfig,
        colocate,
    )
    from kubeflow_tpu_torch.testing import faults

    class ScrapedLoad:
        """Registry stand-in: the diurnal curve the scenario scripts."""

        def __init__(self):
            self.load = 0.0

        def total_load(self):
            return self.load

        def ready_count(self):
            return 1

    def make_train_cr(name, priority, n=1):
        job = crd.TPUJobSpec(name=name, namespace=namespace, num_slices=n)
        cr = job.to_custom_resource()
        cr["metadata"]["labels"] = {LABEL_TENANT: "research",
                                    LABEL_PRIORITY: priority}
        return cr

    apiserver = None
    with faults.injected("seed=20260807") as inj, \
            tempfile.TemporaryDirectory() as tmp:
        try:
            apiserver, kube, store = _start_apiserver()
            gang = GangScheduler({SLICE_MAP["v5e-8"]: 4})
            cluster = ClusterScheduler(gang, SchedulerConfig(
                preemption=PreemptionConfig(
                    grace_period_s=30.0, serving_grace_period_s=5.0)))
            ctl = TPUJobController(kube, gang, cluster)
            store.create_deployment({
                "metadata": {"name": "lm", "namespace": namespace},
                "spec": {"replicas": 0}})
            load = ScrapedLoad()
            claims = colocate.ServingClaimClient(kube, namespace, "lm")
            scaler = Autoscaler(
                kube, namespace, "lm", load,
                target_inflight_per_replica=4.0,
                min_replicas=0, max_replicas=4,
                scale_up_cooldown_s=10.0, scale_down_cooldown_s=60.0,
                claims=claims)

            def statuses():
                return {c["metadata"]["name"]: (c.get("status") or {})
                        for c in kube.list_custom(namespace)}

            def prepulls():
                return kube.list_pods(namespace, labels={
                    colocate.LABEL_WORKLOAD: colocate.WORKLOAD_PREPULL})

            # -- 1. overnight trough: training owns the pool ----------
            out = scaler.reconcile_once()
            assert out["desired"] == 0
            assert out["claim"]["state"] == "released"
            kube.create_custom(make_train_cr("night-batch", "low", n=2))
            kube.create_custom(make_train_cr("steady", "normal", n=2))
            ctl.reconcile_all()
            st = statuses()
            assert st["night-batch"]["phase"] == STARTING, st
            assert st["steady"]["phase"] == STARTING, st
            pool = cluster.pool_status()
            assert pool["free_chips"] == 0
            assert pool["training_chips"] == pool["capacity_chips"]
            _checkpoint_victim(f"{tmp}/night-ckpt")
            for i, p in enumerate(kube.list_pods(
                    namespace, labels={LABEL_JOB: "night-batch"})):
                store.set_pod_node(namespace, p["metadata"]["name"],
                                   f"node-{i}")

            # -- 2. morning burst: claim steals GPUs ------------------
            load.load = 8.0   # ceil(8/4) = 2 replicas wanted
            out = scaler.reconcile_once()
            assert out["applied"] and out["desired"] == 2
            assert out["claim"]["state"] == "pending"
            assert kube.get_deployment(
                namespace, "lm")["spec"]["replicas"] == 0
            ctl.reconcile_all()
            st = statuses()
            assert st["night-batch"]["phase"] == JOB_PREEMPTING, st
            assert st["night-batch"]["resumable"] is True
            assert st["steady"]["phase"] == STARTING, st
            assert sorted(p["spec"]["nodeName"] for p in prepulls()) == \
                ["node-0", "node-1"], prepulls()
            # SHORT serving grace: 6 s ends the drain (the 30 s
            # training grace would still be holding it).
            inj.advance_clock(6)
            ctl.reconcile_all()
            st = statuses()
            assert st["night-batch"]["phase"] == QUEUED
            assert st["night-batch"]["reason"] == "PreemptedRequeued"
            ctl.reconcile_all()
            ctl.reconcile_all()
            st = statuses()
            assert st["serving-lm"]["phase"] == JOB_RUNNING, st
            assert st["serving-lm"]["grantedReplicas"] == 2
            assert kube.get_deployment(
                namespace, "lm")["spec"]["replicas"] == 2
            inj.advance_clock(11)
            out = scaler.reconcile_once()
            assert out["claim"]["state"] == "granted"
            pool = claims.pool()
            assert pool is not None
            assert pool["serving_chips"] == 16
            assert pool["used_chips"] == pool["capacity_chips"]
            ctl.reconcile_all()
            assert prepulls() == []

            # -- 3. evening trough: release, backfill, resume ---------
            load.load = 0.0
            inj.advance_clock(120)   # past the scale-down cooldown
            out = scaler.reconcile_once()
            assert out["desired"] == 0
            assert out["claim"]["state"] == "released"
            assert kube.get_deployment(
                namespace, "lm")["spec"]["replicas"] == 0
            ctl.reconcile_all()   # stale sweep frees the gang claim
            ctl.reconcile_all()   # backfill re-admits the victim
            st = statuses()
            assert "serving-lm" not in st
            assert st["night-batch"]["phase"] == STARTING, st
            assert st["night-batch"]["resumable"] is False
            assert int(st["night-batch"]["preemptions"]) == 1
            assert int(st["night-batch"].get("restarts", 0)) == 0, \
                "eviction must not consume the restart budget"
            _assert_victim_resumes(f"{tmp}/night-ckpt")

            # -- 4. every transition is scrapeable --------------------
            parsed = parse_metrics(REGISTRY.render())
            assert (sample_value(
                parsed, "kft_scheduler_colocation_preemptions_total")
                or 0) >= 1
            assert (sample_value(
                parsed, "kft_autoscaler_claim_granted_total",
                deployment="lm") or 0) >= 1
            assert (sample_value(
                parsed, "kft_scheduler_resumes_total",
                tenant="research") or 0) >= 1
            claims.close()
            parsed = parse_metrics(REGISTRY.render())
            assert not any(
                v for _, v in parsed.get(
                    "kft_scheduler_serving_claim_chips", [])), \
                "claim gauge must read 0 after close()"
        finally:
            _stop_apiserver(apiserver)


SCENARIOS = {
    "tpujob": tpujob_smoke,
    "scheduler": scheduler_smoke,
    "train_resilience": train_resilience_smoke,
    "hfta": hfta_smoke,
    "colocation": colocation_smoke,
    "fleet": fleet_smoke,
    "survivable": survivable_smoke,
    "kv_spill": kv_spill_smoke,
    "multichip_serving": multichip_serving_smoke,
    "adapter_serving": adapter_serving_smoke,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow_tpu_torch.testing.e2e")
    ap.add_argument("scenarios", nargs="*", default=list(SCENARIOS),
                    help=f"scenarios to run, in order: {sorted(SCENARIOS)}")
    ap.add_argument("--namespace", default="kubeflow-test")
    ap.add_argument("--device", default=None,
                    help="replicas' device (default CUDA; 'cpu' asks for "
                         "the CPU)")
    ap.add_argument("--mesh", default="",
                    help="multichip_serving: the decode replica's mesh "
                         "(e.g. tensor=2: serving.main processes); empty "
                         "= one device in process")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    unknown = [s for s in args.scenarios if s not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenarios {unknown}; known: {sorted(SCENARIOS)}")
    failed = []
    for name in args.scenarios:
        kwargs: Dict[str, Any] = {"namespace": args.namespace,
                                  "device": args.device}
        if name == "multichip_serving" and args.mesh:
            kwargs["mesh"] = args.mesh
        t0 = time.perf_counter()
        try:
            SCENARIOS[name](**kwargs)
        except Exception as e:  # noqa: BLE001 — report and go on
            failed.append(name)
            log.exception("scenario %s failed", name)
            print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
            continue
        print(f"PASS {name} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
