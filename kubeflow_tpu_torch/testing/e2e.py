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

The serving smokes are twins of JAX's ``serving`` (a ResNet-18
classifier over REST), ``engine`` (the DecodeEngine behind REST: mixed
lengths, the prefix cache, speculation, block exhaustion, fused rounds),
``faults`` (the seeded ``KFT_FAULTS`` scenario) and ``train`` (two
ResNet-18 steps in a subprocess), on ``device``.  The commands that act
on the current kubectl context (``deploy``, ``deploy-crds``,
``tpujob-real``, ``teardown``) render through the port's registry
(``kubeflow_tpu_torch.manifests``).  ``COMMANDS`` holds all 18 of the JAX
harness's commands; ``main`` runs the named ones in order (every
hermetic one, ``SCENARIOS``, by default) and writes one JUnit report,
``ARTIFACTS/junit_e2e.xml``, with a case a command:

    python -m kubeflow_tpu_torch.testing.e2e serving engine faults train \
        --device cpu --artifacts-dir /tmp/artifacts
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
from kubeflow_tpu_torch.testing.junit import JUnitSuite

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


def seeded_lm(overrides: Dict[str, Any], seed: int = 0, device="cpu"):
    """A seeded random float32 LM made by the port, on ``device``, and
    its JAX-layout weights (the tree an export carries)."""
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.serving.loaders import _model_config

    cfg = _model_config(dict(overrides, dtype="float32"))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)), params_to_jax(model)


def seeded_params(overrides: Dict[str, Any], seed: int = 0):
    """JAX-layout weights of a seeded random LM, made by the port."""
    return seeded_lm(overrides, seed)[1]


def export_lm(base: str, params, overrides: Dict[str, Any],
              max_new: int, version: int = 1) -> None:
    """One greedy ``lm_generate`` version of ``params`` under ``base``,
    servable by both packages."""
    from kubeflow_tpu_torch.serving.export import export

    export(base, version, {"params": params}, loader=JAX_LOADER,
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


# -- the serving, engine, faults and train smokes ----------------------------


def serving_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """Export a seeded ResNet-18 classifier (4 classes, 8 filters), serve
    it over REST, assert a live predict whose scores sum to 1: the twin
    of the JAX package's ``serving`` smoke."""
    import numpy as np

    from kubeflow_tpu_torch.models.resnet import ResNet18
    from kubeflow_tpu_torch.serving.export import export
    from kubeflow_tpu_torch.serving.http import make_http_server
    from kubeflow_tpu_torch.serving.model_server import ModelServer
    from kubeflow_tpu_torch.testing.cnn import random_cnn_variables

    with tempfile.TemporaryDirectory() as tmp:
        model = ResNet18(num_classes=4, num_filters=8, device="meta")
        export(f"{tmp}/m", 1, random_cnn_variables(model, seed=0),
               loader="kubeflow_tpu.serving.loaders:classifier",
               config={"family": "resnet18", "num_classes": 4,
                       "num_filters": 8},
               signature={"inputs": ["image"]})
        server = ModelServer(device=device)
        server.add_model("m", f"{tmp}/m")
        httpd, _ = make_http_server(server, port=0, host="127.0.0.1")
        try:
            port = httpd.server_address[1]
            code, out = predict_via(port, {"instances": [
                {"image": np.zeros((32, 32, 3), np.float32).tolist()}]},
                path="/model/m:predict")
            assert code == 200, (code, out)
            assert len(out["predictions"]) == 1
            scores = out["predictions"][0]["scores"]
            assert abs(sum(scores) - 1.0) < 1e-3
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.stop()


def engine_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """The twin of the JAX package's ``engine`` smoke, on the port's
    DecodeEngine behind REST (2 slots, prefill width 16, 8-token chunks,
    4-token blocks):

      1. three mixed-length requests through 2 slots all complete, and
         the engine drains to zero occupancy and an empty queue;
      2. a shared-prefix burst registers prefix-cache hits (``:stats``
         and ``kft_engine_prefix_hits_total``) and keeps the worst
         inter-token gap under the chunk-budget bound;
      3. a ``--speculative_tokens 4`` rebuild accepts drafts on prompts
         the n-gram drafter predicts (chosen by simulating it against
         ``generate()``), reports the three programs on ``:stats`` and is
         token-identical to a spec-off rebuild;
      4. an 8-page pool with a queue cap of 1 sheds 429s while every
         accepted request completes, admission recovers, and the
         kv shed and eviction counters move as deltas over /metrics;
      5. ``--decode_rounds 8`` dispatches fused rounds, reports the
         ``decode_rounds`` program, and is token-identical to a
         ``decode_rounds 1`` rebuild that has no fused program.
    """
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.runtime.prom import sample_value
    from kubeflow_tpu_torch.serving.engine import _ngram_propose
    from kubeflow_tpu_torch.serving.main import batcher_factory

    max_new = 16
    model, params = seeded_lm(OVERRIDES, device=device)
    geometry = dict(lm_engine_slots=2, lm_engine_prefill_len=16,
                    prefill_chunk_tokens=8, kv_block_tokens=4)
    with tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, OVERRIDES, max_new)
        server, httpd = make_replica(f"{tmp}/lm", device, **geometry)
        try:
            port = httpd.server_address[1]
            rng = np.random.RandomState(0)
            outs: dict = {}

            def post(prompt):
                return predict_via(
                    port, {"instances": [{"tokens": prompt}]}, timeout=120)

            def client(i, prompt):
                code, out = post(prompt)
                assert code == 200, (code, out)
                outs[i] = out

            def burst(prompts, fn=client):
                threads = [threading.Thread(target=fn, args=(i, p))
                           for i, p in enumerate(prompts)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=WAIT_S)
                assert not any(t.is_alive() for t in threads), \
                    "a client hung"

            def tokens_of(i, prompt):
                tokens = outs[i]["predictions"][0]["tokens"]
                assert tokens[:len(prompt)] == prompt
                assert len(tokens) == len(prompt) + max_new
                return tokens

            def stats():
                return get_json(port, "/model/lm:stats")["batcher"]

            def engine_metric(name):
                return sample_value(scrape(port), name,
                                    engine="lm-v1") or 0

            def rebuild(spec_tokens, **extra):
                server.enable_batching("lm", batcher_factory(
                    micro_batch_size=0, batch_timeout_s=0.005,
                    lm_engine=True, speculative_tokens=spec_tokens,
                    **dict(geometry, **extra)))

            # -- 1. mixed lengths through 2 slots -------------------------
            prompts = [rng.randint(1, 128, size=(n,)).tolist()
                       for n in (3, 9, 16)]
            burst(prompts)
            for i, prompt in enumerate(prompts):
                tokens_of(i, prompt)
            _wait(lambda: (lambda s: s["active_slots"] == 0
                           and s["queue_depth"] == 0
                           and s["in_flight_requests"] == 0)(stats()),
                  30, "engine never drained", poll=0.05)
            assert stats()["requests"] == len(prompts)

            # -- 2. shared-prefix burst ------------------------------------
            shared = rng.randint(1, 128, size=(8,)).tolist()
            prefixed = [shared + rng.randint(1, 128, size=(4,)).tolist()
                        for _ in range(4)]
            outs.clear()
            burst(prefixed)
            for i, prompt in enumerate(prefixed):
                tokens_of(i, prompt)
            st = stats()
            assert st["prefix_hits"] > 0, (
                f"shared-prefix burst produced no cache hits: {st}")
            assert st["cached_token_ratio"] > 0
            turn_ms = st["token_latency_p95_ms"] + st["prefill_chunk_p95_ms"]
            bound_ms = 500.0 + 25.0 * max(turn_ms, 1.0)
            assert st["inter_token_gap_max_ms"] <= bound_ms, (
                f"inter-token gap {st['inter_token_gap_max_ms']} ms "
                f"exceeded the chunk-budget bound {bound_ms:.0f} ms")
            parsed = scrape(port)
            assert (sample_value(parsed, "kft_engine_prefix_hits_total")
                    or 0) > 0, "kft_engine_prefix_hits_total not exported"
            assert sample_value(
                parsed, "kft_serving_cached_token_ratio") is not None

            # -- 3. speculative burst --------------------------------------
            rebuild(4)
            cand = [(rng.randint(1, 128, size=(4,)).tolist() * 3)[:12]
                    for _ in range(8)]
            with torch.inference_mode():
                refs = generate(model, torch.tensor(cand),
                                DecodeConfig(max_new_tokens=max_new,
                                             temperature=0.0))[0]
            refs = refs.cpu().numpy()

            def sim_accepts(prompt, cont):
                hist = list(prompt) + [cont[0]]
                accepted, i = 0, 1
                while i < len(cont):
                    room = len(cont) - i - 1
                    prop = (_ngram_propose(np.asarray(hist, np.int32),
                                           min(4, room))
                            if room > 0 else np.empty((0,), np.int32))
                    a = 0
                    for j, p in enumerate(prop.tolist()):
                        if p != cont[i + j]:
                            break
                        a += 1
                    accepted += a
                    hist.extend(cont[i:i + a + 1])
                    i += a + 1
                return accepted

            scores = [sim_accepts(c, refs[i, 12:].tolist())
                      for i, c in enumerate(cand)]
            ranked = sorted(range(len(cand)), key=lambda i: scores[i],
                            reverse=True)
            assert scores[ranked[0]] > 0, (
                "no candidate prompt is draftable under the n-gram "
                "drafter; widen the candidate pool")
            spec_prompts = [cand[i] for i in ranked[:4]]
            outs.clear()
            burst(spec_prompts)
            spec_out = {i: tokens_of(i, p)
                        for i, p in enumerate(spec_prompts)}
            st = stats()
            assert st["spec_drafted"] > 0, (
                f"speculative burst proposed no drafts: {st}")
            assert st["spec_accepted"] > 0, (
                f"speculative burst accepted no drafts: {st}")
            assert 0 < st["spec_acceptance_rate"] <= 1
            programs = st["compiled_programs"]
            assert set(programs) == {"chunked_prefill", "step",
                                     "verify"}, programs
            assert programs["verify"] == 1, programs
            assert programs["chunked_prefill"] == 1, programs
            accepted = engine_metric("kft_engine_spec_accepted_total")
            drafted = engine_metric("kft_engine_spec_drafted_total")
            assert accepted > 0, (
                "kft_engine_spec_accepted_total not exported/zero")
            assert drafted >= accepted
            rebuild(0)
            outs.clear()
            for i, prompt in enumerate(spec_prompts):
                client(i, prompt)
                assert outs[i]["predictions"][0]["tokens"] \
                    == spec_out[i], (
                    f"speculation changed tokens for prompt {i}")
            st = stats()
            assert st["spec_drafted"] == 0
            assert st["compiled_programs"]["verify"] == 0
            assert set(st["compiled_programs"]) \
                == {"chunked_prefill", "step", "verify"}

            # -- 4. block exhaustion ---------------------------------------
            shed_before = engine_metric("kft_engine_kv_shed_no_blocks_total")
            evict_before = engine_metric(
                "kft_engine_kv_block_evictions_total")
            rebuild(0, kv_pool_blocks=8, max_queue_depth=1)
            exhaust = [rng.randint(1, 128, size=(12,)).tolist()
                       for _ in range(8)]
            outs.clear()
            codes: dict = {}

            def burst_client(i, prompt):
                codes[i], out = post(prompt)
                if codes[i] == 200:
                    outs[i] = out

            burst(exhaust, burst_client)
            ok = [i for i, c in codes.items() if c == 200]
            shed = [i for i, c in codes.items() if c == 429]
            assert codes and set(codes.values()) <= {200, 429}, codes
            assert ok, f"exhaustion burst completed nothing: {codes}"
            assert shed, f"pool exhaustion shed nothing (want 429s): {codes}"
            for i in ok:
                tokens_of(i, exhaust[i])
            client("post", exhaust[0])
            assert len(outs["post"]["predictions"][0]["tokens"]) \
                == len(exhaust[0]) + max_new
            st = stats()
            assert st["shed"] >= len(shed), st
            assert st["kv_shed_no_blocks"] >= 1, st
            assert st["kv_blocks"] == 8
            parsed = scrape(port)
            assert sample_value(parsed, "kft_engine_kv_blocks",
                                engine="lm-v1") == 8
            assert (sample_value(parsed, "kft_engine_kv_blocks_used",
                                 engine="lm-v1") or 0) > 0
            shed_after = sample_value(
                parsed, "kft_engine_kv_shed_no_blocks_total",
                engine="lm-v1") or 0
            evict_after = sample_value(
                parsed, "kft_engine_kv_block_evictions_total",
                engine="lm-v1") or 0
            assert shed_after - shed_before >= 1, (
                shed_before, shed_after, codes)
            assert evict_after > evict_before, (evict_before, evict_after)

            # -- 5. fused rounds -------------------------------------------
            fused_before = engine_metric("kft_engine_fused_rounds_total")
            rebuild(0, decode_rounds=8)
            fused_prompts = [rng.randint(1, 128, size=(n,)).tolist()
                             for n in (3, 9, 16)]
            outs.clear()
            burst(fused_prompts)
            fused_out = {i: tokens_of(i, p)
                         for i, p in enumerate(fused_prompts)}
            st = stats()
            assert st["decode_rounds"] == 8, st
            assert st["fused_rounds"] > 0, (
                f"fused burst dispatched no fused rounds: {st}")
            assert st["steps_per_round_p50"] >= 1, st
            programs = st["compiled_programs"]
            assert programs.get("decode_rounds") == 1, programs
            assert programs["chunked_prefill"] == 1, programs
            assert programs["verify"] == 0, programs
            fused_after = engine_metric("kft_engine_fused_rounds_total")
            assert fused_after - fused_before > 0, (fused_before,
                                                    fused_after)
            rebuild(0)
            outs.clear()
            burst(fused_prompts)
            for i in range(len(fused_prompts)):
                assert outs[i]["predictions"][0]["tokens"] \
                    == fused_out[i], (
                    f"fused decode changed tokens for prompt {i}")
            st = stats()
            assert st["fused_rounds"] == 0, st
            assert "decode_rounds" not in st["compiled_programs"], \
                st["compiled_programs"]
        finally:
            close_fleet(servers=[(server, httpd)])


def fault_injection_smoke(namespace: str = "kubeflow-test",
                          device=None) -> None:
    """The twin of the JAX package's ``faults`` smoke: a seeded
    ``KFT_FAULTS`` scenario against the port's serving fault layer.

      1. overload shed: slot and queue seat full => 429 with Retry-After,
         while the accepted requests complete;
      2. a deadline that expires mid-generation (slow steps injected) =>
         504, and the freed slot serves a follow-up;
      3. a corrupt version trips the reload breaker (no loader hot loop)
         while the last good version serves; a new good version loads;
      4. graceful drain: /readyz 503 with a request in flight, /healthz
         200, and the accepted request completes;
      5. the shed, expired and reload-failure counters are on /metrics.

    Override the scenario by exporting KFT_FAULTS (same grammar)."""
    from kubeflow_tpu_torch.serving.http import make_http_server
    from kubeflow_tpu_torch.serving.main import batcher_factory, wait_for_drain
    from kubeflow_tpu_torch.serving.model_server import ModelServer
    from kubeflow_tpu_torch.testing import faults

    max_new = 16
    scenario = os.environ.get(faults.ENV) or \
        "seed=20260803;engine.step:sleep=0.03"
    params = seeded_params(OVERRIDES)

    def predict_req(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/model/lm:predict",
            data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=180) as resp:
                return resp.status, dict(resp.headers), \
                    json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    prompt = list(range(1, 9))
    body_full = {"instances": [{"tokens": prompt}]}
    with faults.injected(scenario) as inj, \
            tempfile.TemporaryDirectory() as tmp:
        export_lm(f"{tmp}/lm", params, OVERRIDES, max_new)
        server = ModelServer(reload_backoff_s=0.5, device=device)
        server.add_model("lm", f"{tmp}/lm")
        server.enable_batching("lm", batcher_factory(
            micro_batch_size=0, batch_timeout_s=0.005, lm_engine=True,
            lm_engine_slots=1, lm_engine_prefill_len=16,
            max_queue_depth=1))
        httpd, _ = make_http_server(server, port=0, host="127.0.0.1")
        port = httpd.server_address[1]
        try:
            # -- 1. overload shed ---------------------------------------
            results: dict = {}

            def client(i, body):
                results[i] = predict_req(port, body)

            t0 = threading.Thread(target=client, args=(0, body_full))
            t0.start()
            _wait(lambda: get_json(port, "/model/lm:stats")["batcher"]
                  ["in_flight_requests"] >= 1, 120,
                  "first request never ran")
            burst = [threading.Thread(target=client, args=(i, body_full))
                     for i in range(1, 5)]
            for t in burst:
                t.start()
            for t in [t0] + burst:
                t.join(timeout=180)
            codes = sorted(results[i][0] for i in range(5))
            assert codes.count(429) >= 1, codes
            assert codes.count(200) >= 2, codes
            assert all(results[i][1].get("Retry-After") for i in range(5)
                       if results[i][0] == 429), (
                "429 responses must carry Retry-After")
            for i in range(5):
                if results[i][0] == 200:
                    tokens = results[i][2]["predictions"][0]["tokens"]
                    assert tokens[:len(prompt)] == prompt
                    assert len(tokens) == len(prompt) + max_new
            # -- 2. deadline expiry mid-generation ----------------------
            code, _, payload = predict_req(
                port, {**body_full, "deadline_ms": 120})
            assert code == 504, (code, payload)
            assert "deadline" in payload["error"].lower()
            code, _, payload = predict_req(port, body_full)
            assert code == 200, (code, payload)
            stats = get_json(port, "/model/lm:stats")["batcher"]
            assert stats["deadline_expired"] >= 1, stats
            assert stats["shed"] >= 1, stats
            # -- 3. loader circuit-break --------------------------------
            os.makedirs(f"{tmp}/lm/2")
            with open(f"{tmp}/lm/2/model.json", "w") as f:
                f.write("{corrupt json")
            raised = False
            try:
                server.reload("lm")
            except Exception:  # noqa: BLE001 — the corrupt load raises
                raised = True
            assert raised, "corrupt version must raise"
            attempts = inj.fired("loader.load")
            for _ in range(5):
                assert server.reload("lm") is False
            assert inj.fired("loader.load") == attempts
            code, _, _ = predict_req(port, body_full)
            assert code == 200
            assert server.get("lm").version == 1
            inj.advance_clock(30)
            raised = False
            try:
                server.reload("lm")
            except Exception:  # noqa: BLE001 — still corrupt
                raised = True
            assert raised, "still-corrupt version must raise"
            assert inj.fired("loader.load") == attempts + 1
            export_lm(f"{tmp}/lm", params, OVERRIDES, max_new, version=3)
            assert server.reload("lm") is True
            assert server.get("lm").version == 3
            code, _, _ = predict_req(port, body_full)
            assert code == 200
            # -- 4. graceful drain --------------------------------------
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=30) as r:
                assert r.status == 200
            holder: dict = {}
            t = threading.Thread(target=lambda: holder.update(
                {"resp": predict_req(port, body_full)}))
            t.start()
            _wait(lambda: server.inflight() >= 1, 120,
                  "drain request never ran")
            server.begin_drain()
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=30)
                raise AssertionError("/readyz must be 503 while draining")
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert json.loads(e.read())["status"] == "draining"
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert r.status == 200
            t.join(timeout=180)
            assert holder["resp"][0] == 200, (
                "request accepted before drain was lost")
            assert wait_for_drain(server, deadline_s=30)
            # -- 5. shed/expired/breaker visible in kft_* metrics -------
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                metrics = r.read().decode()
            for needle in ('kft_serving_shed_total{batcher="lm-v1"}',
                           'kft_serving_deadline_expired_total'
                           '{batcher="lm-v1"}',
                           'kft_serving_reload_failures_total'
                           '{model="lm"}'):
                line = [ln for ln in metrics.splitlines()
                        if ln.startswith(needle)]
                assert line and float(line[0].rsplit(" ", 1)[1]) >= 1, (
                    f"expected a nonzero {needle} series")
        finally:
            close_fleet(servers=[(server, httpd)])


def train_smoke(namespace: str = "kubeflow-test", device=None) -> None:
    """Two real train steps of the ResNet-18 trainer in a subprocess: the
    twin of the JAX package's ``train`` smoke (CUDA unless ``device``
    asks for the CPU)."""
    argv = [sys.executable, "-m", "kubeflow_tpu_torch.tools.train_cnn",
            "--model", "resnet18", "--steps", "2",
            "--batch-size-per-device", "2", "--image-size", "32",
            "--num-classes", "4"]
    if device is not None:
        from kubeflow_tpu_torch.device import resolve_device

        argv += ["--device", resolve_device(device).type]
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- the real-cluster commands -------------------------------------------------


def _kubectl(args, *, input_text: str = None, timeout: int = 300) -> str:
    proc = subprocess.run(
        ["kubectl"] + args, input=input_text, text=True,
        capture_output=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"kubectl {' '.join(args)} failed: {proc.stderr[-2000:]}")
    return proc.stdout


def deploy_real(namespace: str = "kubeflow-test") -> None:
    """Deploy the platform, rendered through the port's registry, to the
    current kubectl context and wait for every Deployment to roll out
    within the reference's 10-minute readiness budget
    (testing/test_deploy.py:160-190).  KFT_E2E_DEPLOY selects the
    prototypes (comma-separated; default the full kubeflow-core)."""
    import kubeflow_tpu_torch.manifests  # noqa: F401 — registers prototypes
    from kubeflow_tpu_torch.config.registry import App
    from kubeflow_tpu_torch.manifests.base import to_yaml

    app = App()
    prototypes = os.environ.get("KFT_E2E_DEPLOY", "kubeflow-core")
    for i, proto in enumerate(p.strip() for p in prototypes.split(",")):
        app.add(proto, f"c{i}-{proto}", namespace=namespace)
    objects = app.render()
    _kubectl(["create", "namespace", namespace,
              "--dry-run=client", "-o", "yaml"])  # validates kubectl works
    try:
        _kubectl(["create", "namespace", namespace])
    except RuntimeError:
        pass  # already exists
    _kubectl(["apply", "-n", namespace, "-f", "-"],
             input_text=to_yaml(objects))
    deployments = [o["metadata"]["name"] for o in objects
                   if o["kind"] == "Deployment"]
    for name in deployments:
        _kubectl(["rollout", "status", f"deployment/{name}",
                  "-n", namespace, "--timeout=600s"], timeout=650)


def deploy_crds(namespace: str = "kubeflow-test") -> None:
    """Apply only the CRDs (+ namespace) to the current context: the
    footing for clusters that cannot pull the platform images, where the
    operator runs as a host process against the cluster."""
    import kubeflow_tpu_torch.manifests  # noqa: F401
    from kubeflow_tpu_torch.config.registry import default_registry
    from kubeflow_tpu_torch.manifests.base import to_yaml

    objs = default_registry.generate("tpujob-operator", "op",
                                     namespace=namespace)
    crds = [o for o in objs if o["kind"] == "CustomResourceDefinition"]
    try:
        _kubectl(["create", "namespace", namespace])
    except RuntimeError:
        pass  # already exists
    _kubectl(["apply", "-f", "-"], input_text=to_yaml(crds))


def tpujob_real(namespace: str = "kubeflow-test") -> None:
    """Submit the tpu-job-simple example (``h100-1``, or KFT_E2E_SLICE)
    to the real cluster and poll the CR until the operator reports a
    terminal phase."""
    import kubeflow_tpu_torch.manifests  # noqa: F401
    from kubeflow_tpu_torch.config.registry import default_registry
    from kubeflow_tpu_torch.manifests.base import to_yaml

    objs = default_registry.generate(
        "tpu-job-simple", "e2e-smoke", namespace=namespace,
        slice_type=os.environ.get("KFT_E2E_SLICE", "h100-1"))
    _kubectl(["apply", "-n", namespace, "-f", "-"],
             input_text=to_yaml(objs))
    deadline = time.time() + 600
    phase = ""
    while time.time() < deadline:
        out = _kubectl(["get", "tpujobs.kubeflow-tpu.org", "e2e-smoke",
                        "-n", namespace, "-o", "json"])
        phase = json.loads(out).get("status", {}).get("phase", "")
        if phase in ("Succeeded", "Failed"):
            break
        time.sleep(5)
    assert phase == "Succeeded", f"TPUJob ended in phase {phase!r}"


def teardown(namespace: str = "kubeflow-test") -> None:
    """Delete the test namespace of a real cluster; with no cluster there
    is nothing to tear down."""
    try:
        _kubectl(["delete", "namespace", namespace, "--ignore-not-found"],
                 timeout=600)
    except (RuntimeError, FileNotFoundError):
        pass


COMMANDS = {
    "tpujob": tpujob_smoke,
    "serving": serving_smoke,
    "engine": engine_smoke,
    "faults": fault_injection_smoke,
    "fleet": fleet_smoke,
    "survivable": survivable_smoke,
    "kv_spill": kv_spill_smoke,
    "multichip_serving": multichip_serving_smoke,
    "adapter_serving": adapter_serving_smoke,
    "scheduler": scheduler_smoke,
    "train": train_smoke,
    "train_resilience": train_resilience_smoke,
    "hfta": hfta_smoke,
    "colocation": colocation_smoke,
    "deploy": deploy_real,
    "deploy-crds": deploy_crds,
    "tpujob-real": tpujob_real,
    "teardown": teardown,
}
# The commands that act on the current kubectl context take no device.
CLUSTER_COMMANDS = {"deploy", "deploy-crds", "tpujob-real", "teardown"}
# The hermetic scenarios, run by default.
SCENARIOS = {k: v for k, v in COMMANDS.items() if k not in CLUSTER_COMMANDS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow_tpu_torch.testing.e2e")
    ap.add_argument("scenarios", nargs="*", default=list(SCENARIOS),
                    help=f"commands to run, in order: {sorted(COMMANDS)} "
                         f"(default: every hermetic scenario)")
    ap.add_argument("--namespace", default="kubeflow-test")
    ap.add_argument("--device", default=None,
                    help="replicas' device (default CUDA; 'cpu' asks for "
                         "the CPU)")
    ap.add_argument("--mesh", default="",
                    help="multichip_serving: the decode replica's mesh "
                         "(e.g. tensor=2: serving.main processes); empty "
                         "= one device in process")
    ap.add_argument("--artifacts-dir",
                    default=os.path.join(tempfile.gettempdir(), "artifacts"),
                    help="where junit_e2e.xml is written, one case a "
                         "command (default: %(default)s)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    unknown = [s for s in args.scenarios if s not in COMMANDS]
    if unknown:
        ap.error(f"unknown scenarios {unknown}; known: {sorted(COMMANDS)}")
    suite = JUnitSuite("e2e")
    for name in args.scenarios:
        kwargs: Dict[str, Any] = {"namespace": args.namespace}
        if name not in CLUSTER_COMMANDS:
            kwargs["device"] = args.device
        if name == "multichip_serving" and args.mesh:
            kwargs["mesh"] = args.mesh

        def run(name=name, kwargs=kwargs):
            try:
                COMMANDS[name](**kwargs)
            except Exception as e:
                log.exception("scenario %s failed", name)
                print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
                raise

        case = suite.run(name, run)
        if case.ok:
            print(f"PASS {name} ({case.time_s:.1f} s)", flush=True)
    path = suite.write(args.artifacts_dir)
    print(f"junit: {path}", file=sys.stderr)
    return 0 if suite.ok else 1


if __name__ == "__main__":
    sys.exit(main())
