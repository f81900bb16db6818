"""The port's fleet control plane (endpoint registry, router, autoscaler)
against the JAX package's: each script of tests/test_fleet.py runs once
on each package, against the same scriptable in-process replicas (real
sockets, fake model), with the same ``random.Random`` seeds and a frozen
policy clock, and the two runs must decide alike: the order in which the
replicas were offered requests, the status codes, headers and bodies the
client saw, the endpoints' breaker states and backoff deadlines on the
policy clock (ejection and readmission), the autoscaler's decisions, and
the deltas of every ``kft_router_*`` and ``kft_autoscaler_*`` sample.
Each script also keeps test_fleet.py's own assertions, checked on both
packages' runs."""

import json
import random
import socket
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import kubeflow_tpu.fleet.autoscaler as jax_autoscaler
import kubeflow_tpu.fleet.endpoints as jax_endpoints
import kubeflow_tpu.fleet.main as jax_main
import kubeflow_tpu.fleet.router as jax_router
import kubeflow_tpu.operator.kube as jax_kube
import kubeflow_tpu.runtime.prom as jax_prom
import kubeflow_tpu.runtime.tracing as jax_tracing
import kubeflow_tpu.scheduler.colocate as jax_colocate
import kubeflow_tpu.testing.faults as jax_faults
import kubeflow_tpu_torch.fleet.autoscaler as port_autoscaler
import kubeflow_tpu_torch.fleet.endpoints as port_endpoints
import kubeflow_tpu_torch.fleet.main as port_main
import kubeflow_tpu_torch.fleet.router as port_router
import kubeflow_tpu_torch.operator.kube as port_kube
import kubeflow_tpu_torch.runtime.prom as port_prom
import kubeflow_tpu_torch.runtime.tracing as port_tracing
import kubeflow_tpu_torch.scheduler.colocate as port_colocate
import kubeflow_tpu_torch.testing.faults as port_faults
from torch_control_parity import SLICE_MAP
from torch_lockcheck import lockcheck_order  # noqa: F401

PACKAGES = {
    "jax": types.SimpleNamespace(
        endpoints=jax_endpoints, router=jax_router,
        autoscaler=jax_autoscaler, kube=jax_kube, prom=jax_prom,
        tracing=jax_tracing, faults=jax_faults, main=jax_main,
        colocate=jax_colocate),
    "port": types.SimpleNamespace(
        endpoints=port_endpoints, router=port_router,
        autoscaler=port_autoscaler, kube=port_kube, prom=port_prom,
        tracing=port_tracing, faults=port_faults, main=port_main,
        colocate=port_colocate),
}

# The gauges among them, zeroed before each run so that both packages'
# runs start from the same values (a registry is shared by every test of
# its process).
_GAUGES = ("kft_router_endpoints", "kft_router_cached_token_ratio",
           "kft_autoscaler_desired_replicas", "kft_autoscaler_observed_load",
           "kft_autoscaler_ready_replicas")
# Samples whose values are wall-clock timings, not decisions: only
# their observation counts are compared.
_TIMED = ("kft_router_request_seconds_sum",
          "kft_router_request_seconds_bucket")


class _Replica:
    """Scriptable stand-in for one serving replica (test_fleet.py's):
    /readyz, /metrics (the gauges the registry scrapes), and predict,
    :generate, :prefill and :fetch_kv routes the script controls.  Every
    request it receives is appended to the run's shared ``log``."""

    def __init__(self, log, index, port=0):
        self.log = log
        self.index = index
        self.ready = True
        self.draining = False
        self.inflight = 0.0
        self.queue_depth = 0.0
        self.cached_ratio = 0.0
        self.predict_status = 200
        self.retry_after = None
        self.hang_up = False
        self.fail_gets = False
        self.get_attempts = 0
        self.requests = []
        self.headers_seen = []
        self.gen_tokens = list(range(100, 115))
        self.gen_die_after = None
        self.gen_meta = {"resumable": True, "seeded": False}
        self.fetch_status = 200
        self.fetch_payload = None
        self.role = None
        self.adapters = None
        self.prefill_status = 200
        self.prefill_payload = {
            "block_tokens": 4, "tokens_covered": 8,
            "k": {"b64": "AA==", "shape": [1], "dtype": "uint8"},
            "v": {"b64": "AA==", "shape": [1], "dtype": "uint8"}}
        self.lock = threading.Lock()
        replica = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, payload, headers=None):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/readyz":
                    extra = {} if replica.role is None \
                        else {"role": replica.role}
                    if replica.adapters is not None:
                        extra["adapters"] = replica.adapters
                    if replica.ready and not replica.draining:
                        self._send(200, dict({"status": "ready"}, **extra))
                    else:
                        self._send(503, dict(
                            {"status": "draining" if replica.draining
                             else "no models loaded"}, **extra))
                elif self.path == "/metrics":
                    data = (f"kft_serving_inflight {replica.inflight}\n"
                            f'kft_serving_queue_depth{{model="m"}} '
                            f"{replica.queue_depth}\n"
                            f"kft_serving_cached_token_ratio "
                            f"{replica.cached_ratio}\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    with replica.lock:
                        replica.get_attempts += 1
                        replica.log.append((replica.index, "GET",
                                            self.path))
                    if replica.fail_gets:
                        self._die()
                        return
                    self._send(200, {"route": self.path})

            def _die(self):
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.connection.close()

            def _chunk(self, obj):
                data = json.dumps(obj).encode() + b"\n"
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                with replica.lock:
                    replica.requests.append((self.path, body))
                    replica.headers_seen.append(dict(self.headers.items()))
                    replica.log.append((replica.index, "POST", self.path))
                if replica.hang_up:
                    self._die()
                    return
                if self.path.endswith(":prefill"):
                    payload = replica.prefill_payload
                    self._send(replica.prefill_status, {
                        "kv_handoff": payload,
                        "tokens_covered": 0 if not payload
                        else payload.get("tokens_covered", 0)})
                    return
                if self.path.endswith(":fetch_kv"):
                    payload = replica.fetch_payload
                    self._send(replica.fetch_status, {
                        "kv_handoff": payload,
                        "tokens_covered": 0 if payload is None
                        else payload.get("tokens_covered", 0)})
                    return
                if self.path.endswith(":generate"):
                    payload = json.loads(body or b"{}")
                    out = replica.gen_tokens[
                        len(payload.get("resume_tokens") or []):]
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self._chunk({"meta": dict(replica.gen_meta)})
                    for i, tok in enumerate(out):
                        if replica.gen_die_after is not None \
                                and i >= replica.gen_die_after:
                            self._die()
                            return
                        self._chunk({"tokens": [tok]})
                    self._chunk({"done": True, "tokens_emitted": len(out)})
                    self.wfile.write(b"0\r\n\r\n")
                    return
                headers = {}
                if replica.retry_after is not None:
                    headers["Retry-After"] = str(replica.retry_after)
                self._send(replica.predict_status,
                           {"predictions": [{"ok": True}]}, headers)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        # A short poll: kill() returns within 20 ms, not 0.5 s.
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.02},
            daemon=True)
        self.thread.start()
        self.alive = True

    def kill(self):
        if self.alive:
            self.alive = False
            self.httpd.shutdown()
            self.httpd.server_close()

    def received(self):
        with self.lock:
            return list(self.requests)


class _Clock:
    """The policy clock both packages read (``faults.monotonic``):
    frozen unless the script advances it, or ticking by ``tick`` a read
    for scripts whose deadline must pass between two reads."""

    def __init__(self, tick=0.0):
        self.now = 1000.0
        self.tick = tick

    def __call__(self):
        self.now += self.tick
        return self.now

    def advance(self, seconds):
        self.now += seconds


class _Run:
    """One script's run on one package: its replicas, their shared
    request log, the policy clock, and what the script records."""

    def __init__(self, pkg, clock):
        self.p = pkg
        self.clock = clock
        self.log = []
        self.record = {}
        self.replicas = []
        self.routers = []

    def replica(self, port=0):
        rep = _Replica(self.log, len(self.replicas), port=port)
        self.replicas.append(rep)
        return rep

    def fleet(self, n=3):
        return [self.replica() for _ in range(n)]

    def registry(self, reps, **kw):
        kw.setdefault("eject_threshold", 2)
        kw.setdefault("rng", random.Random(0))
        reg = self.p.endpoints.EndpointRegistry(
            self.p.endpoints.StaticEndpoints([
                self.p.endpoints.Endpoint(name=f"r{i}", url=r.url)
                for i, r in enumerate(reps)]), **kw)
        reg.refresh()
        return reg

    def router(self, reg, **kw):
        kw.setdefault("rng", random.Random(0))
        kw.setdefault("try_timeout_s", 10.0)
        router = self.p.router.FleetRouter(reg, **kw)
        self.routers.append(router)
        return router

    def note(self, key, value):
        self.record.setdefault(key, []).append(value)

    def states(self, reg):
        """Each endpoint's breaker on the policy clock: its phase, its
        failure count and how far ahead its backoff ends."""
        out = {}
        for s in reg.all():
            b = s.breaker
            out[s.name] = (s.state_label(), b.state(), b.failure_count(),
                           round(b.open_until - self.clock.now, 9)
                           if b.open_until else 0.0)
        return out


def _predict(router, body=None, path="/model/m:predict"):
    payload = json.dumps(body or {"instances": [[1]]}).encode()
    return router.handle("POST", path, payload,
                         {"Content-Type": "application/json"})


def _answer(resp):
    status, headers, body = resp
    return status, dict(sorted(headers.items())), json.loads(body)


class _Sink:
    def __init__(self):
        self.started = False
        self.lines = []

    def start(self):
        self.started = True

    def write_line(self, payload):
        self.started = True
        self.lines.append(payload)

    def tokens(self):
        return [t for m in self.lines for t in m.get("tokens", [])]


def _stream(router, body=None, headers=None):
    sink = _Sink()
    plain = router.handle_stream(
        "/model/m:generate",
        json.dumps(body or {"tokens": [1, 2, 3]}).encode(),
        headers or {}, sink)
    return plain, sink


def _keys(*reps):
    keys = {h.get("x-kft-idempotency-key")
            for r in reps for h in r.headers_seen}
    return len(keys), None in keys


def _metric(p, name, **labels):
    return p.prom.sample_value(p.prom.parse_metrics(p.prom.REGISTRY.render()),
                               name, **labels) or 0.0


def _samples(p):
    out = {}
    for name, series in p.prom.parse_metrics(
            p.prom.REGISTRY.render()).items():
        if not name.startswith(("kft_router_", "kft_autoscaler_")) \
                or name.startswith(_TIMED):
            continue
        for labels, value in series:
            out[(name, tuple(sorted(labels.items())))] = value
    return out


def _zero_gauges(p):
    parsed = p.prom.parse_metrics(p.prom.REGISTRY.render())
    for name in _GAUGES:
        for labels, _ in parsed.get(name, ()):
            p.prom.REGISTRY.gauge(name).set(0.0, **labels)


# -- the scripts: test_fleet.py's tests, one function each ------------------


def registry_discovery_and_readiness(r):
    reps = r.fleet()
    reg = r.registry(reps)
    assert len(reg.all()) == 3 and len(reg.routable()) == 3
    reps[1].ready = False
    reg.refresh()
    assert {s.name for s in reg.routable()} == {"r0", "r2"}
    r.note("states", r.states(reg))


def registry_draining_not_ejected(r):
    reps = r.fleet()
    reg = r.registry(reps)
    reps[0].draining = True
    reg.refresh()
    states = {s.name: s for s in reg.all()}
    assert not states["r0"].routable()
    assert states["r0"].state_label() == "draining"
    assert not states["r0"].breaker.open
    r.note("states", r.states(reg))


def registry_load_scraped(r):
    reps = r.fleet()
    reps[2].inflight, reps[2].queue_depth = 7, 3
    reps[2].cached_ratio = 0.42
    reg = r.registry(reps)
    states = {s.name: s for s in reg.all()}
    assert states["r2"].score() == 10.0 and reg.total_load() == 10.0
    assert states["r2"].cached_token_ratio == 0.42
    assert states["r0"].cached_token_ratio == 0.0
    rows = {row["name"]: row for row in reg.describe()}
    assert rows["r2"]["cached_token_ratio"] == 0.42
    assert _metric(r.p, "kft_router_cached_token_ratio",
                   endpoint="r2") == 0.42
    r.note("describe", sorted((row["name"], row["state"], row["inflight"],
                               row["queue_depth"]) for row in rows.values()))


def registry_dead_replica_ejected(r):
    with r.p.faults.injected("seed=0") as inj:
        reps = r.fleet()
        reg = r.registry(reps, eject_threshold=2, eject_backoff_s=5.0)
        reps[0].kill()
        reg.refresh()
        r.note("states", r.states(reg))
        reg.refresh()
        states = {s.name: s for s in reg.all()}
        assert states["r0"].breaker.open
        assert states["r0"].state_label() == "ejected"
        r.note("states", r.states(reg))
        fired = inj.fired("fleet.probe")
        reg.refresh()
        assert inj.fired("fleet.probe") == fired + 2
        r.note("probes", inj.fired("fleet.probe"))


def registry_half_open_recovery(r):
    with r.p.faults.injected("seed=0"):
        rep = r.replica()
        reg = r.registry([rep], eject_threshold=1, eject_backoff_s=5.0)
        port = rep.port
        rep.kill()
        reg.refresh()
        state = reg.all()[0]
        assert state.breaker.open
        r.note("states", r.states(reg))
        reg.refresh()
        assert state.breaker.open
        r.replica(port=port)
        r.clock.advance(30)
        reg.refresh()
        assert not state.breaker.open and state.routable()
        r.note("states", r.states(reg))


def registry_describe_without_deadlock(r):
    reps = r.fleet()
    reg = r.registry(reps)
    reps[1].draining = True
    reg.refresh()
    done = []
    t = threading.Thread(target=lambda: done.append(reg.describe()))
    t.start()
    t.join(timeout=10)
    assert done, "describe() deadlocked"
    states = {row["name"]: row["state"] for row in done[0]}
    assert states["r0"] == "routable" and states["r1"] == "draining"
    r.note("describe", sorted(
        (row["name"], row["state"], row["tier"], row["breaker_state"])
        for row in done[0]))


def registry_half_open_released_when_not_ready(r):
    with r.p.faults.injected("seed=0"):
        rep = r.replica()
        reg = r.registry([rep], eject_threshold=1, eject_backoff_s=2.0)
        port = rep.port
        rep.kill()
        reg.refresh()
        state = reg.all()[0]
        assert state.breaker.open
        back = r.replica(port=port)
        back.ready = False
        r.clock.advance(10)
        reg.refresh()
        assert state.breaker.open
        r.note("states", r.states(reg))
        back.ready = True
        r.clock.advance(10)
        reg.refresh()
        assert not state.breaker.open and state.routable()
        r.note("states", r.states(reg))


def kube_endpoint_sources(r):
    kube = r.p.kube.FakeKube()
    kube.create_pod({
        "metadata": {"namespace": "kf", "name": "srv-0",
                     "labels": {"app": "srv"}},
        "spec": {"containers": [
            {"ports": [{"name": "http", "containerPort": 8000}]},
            {"ports": [{"containerPort": 9090}]}]},
        "status": {"podIP": "10.0.0.5"}})
    kube.set_pod_phase("kf", "srv-0", "Running")
    kube.create_pod({
        "metadata": {"namespace": "kf", "name": "srv-1",
                     "labels": {"app": "srv"}},
        "spec": {"containers": [{"ports": [{"containerPort": 8123}]}]},
        "status": {"podIP": "10.0.0.6"}})
    kube.create_pod({
        "metadata": {"namespace": "kf", "name": "srv-2",
                     "labels": {"app": "srv"}},
        "spec": {"containers": []}, "status": {"podIP": "10.0.0.7"}})
    kube.set_pod_phase("kf", "srv-2", "Running")
    src = r.p.endpoints.KubeEndpoints(kube, "kf", {"app": "srv"},
                                      default_port=7000)
    eps = src.discover()
    assert [(e.name, e.url) for e in eps] == [
        ("srv-0", "http://10.0.0.5:8000"), ("srv-2", "http://10.0.0.7:7000")]
    r.note("endpoints", [(e.name, e.url, e.grpc_target) for e in eps])


def router_p2c_prefers_lower_load(r):
    reps = r.fleet()
    reps[0].inflight = reps[1].inflight = 50
    router = r.router(r.registry(reps))
    for _ in range(30):
        assert _predict(router)[0] == 200
    counts = [len(rep.received()) for rep in reps]
    assert counts[2] > counts[0] and counts[2] > counts[1]


def router_overloaded_retried_on_other(r):
    reps = r.fleet()
    for rep in reps[:2]:
        rep.predict_status, rep.retry_after = 429, 3
    reg = r.registry(reps)
    router = r.router(reg)
    for _ in range(5):
        resp = _predict(router)
        assert resp[0] == 200, resp
        r.note("answers", _answer(resp))
    assert len(reps[2].received()) >= 5
    assert not any(s.breaker.open for s in reg.all())


def router_all_overloaded_min_retry_after(r):
    reps = r.fleet()
    for rep, hint in zip(reps, (7, 3, 9)):
        rep.predict_status, rep.retry_after = 429, hint
    resp = _predict(r.router(r.registry(reps)))
    assert resp[0] == 429 and resp[1]["Retry-After"] == "3"
    r.note("answers", _answer(resp))


def router_dead_replica_retried_and_ejected(r):
    reps = r.fleet()
    reg = r.registry(reps, eject_threshold=2)
    router = r.router(reg)
    reps[0].kill()
    for _ in range(10):
        resp = _predict(router)
        assert resp[0] == 200, resp
    assert {s.name: s for s in reg.all()}["r0"].breaker.open
    r.note("states", r.states(reg))


def router_transport_failure_replayed_same_key(r):
    dying, healthy = r.replica(), r.replica()
    dying.hang_up = True
    healthy.inflight = 50
    router = r.router(r.registry([dying, healthy]))
    resp = _predict(router)
    assert resp[0] == 200, resp
    assert len(dying.received()) == 1 and len(healthy.received()) == 1
    assert _keys(dying, healthy) == (1, False)
    assert _metric(r.p, "kft_router_replays_total", outcome="ok") >= 1
    r.note("answers", _answer(resp))


def router_client_key_forwarded(r):
    reps = r.fleet()
    router = r.router(r.registry(reps))
    resp = router.handle("POST", "/model/m:predict",
                         json.dumps({"instances": [[1]]}).encode(),
                         {"X-KFT-Idempotency-Key": "client-key-7"})
    assert resp[0] == 200
    keys = [h.get("x-kft-idempotency-key")
            for rep in reps for h in rep.headers_seen]
    assert keys == ["client-key-7"]
    r.note("keys", keys)


@pytest.fixture(params=[0, 2])
def max_replays(request):
    return request.param


def router_replay_cap(r, max_replays=0):
    reps = r.fleet()
    for rep in reps:
        rep.hang_up = True
    resp = _predict(r.router(r.registry(reps), max_replays=max_replays))
    assert resp[0] == 502
    assert sum(len(rep.received()) for rep in reps) == 1 + max_replays
    r.note("answer_code", resp[0])


def router_non_model_post_never_replayed(r):
    reps = r.fleet()
    for rep in reps:
        rep.hang_up = True
    resp = _predict(r.router(r.registry(reps)), path="/admin/do-something")
    assert resp[0] == 502
    assert sum(len(rep.received()) for rep in reps) == 1
    assert [h.get("x-kft-idempotency-key")
            for rep in reps for h in rep.headers_seen] == [None]


def router_reused_conn_death_recovers(r):
    rep, other = r.replica(), r.replica()
    router = r.router(r.registry([rep, other]))
    for _ in range(10):
        assert _predict(router)[0] == 200
        if rep.received() and other.received():
            break
    assert rep.received(), "pool to rep never warmed"
    rep.hang_up = True
    assert _predict(router)[0] == 200


def router_probe_ejection_purges_pool(r):
    with r.p.faults.injected("seed=0"):
        rep = r.replica()
        reg = r.registry([rep], eject_threshold=1, eject_backoff_s=2.0)
        router = r.router(reg)
        assert _predict(router)[0] == 200
        assert router._pool.get(rep.url) is not None
        assert _predict(router)[0] == 200
        port = rep.port
        rep.kill()
        reg.refresh()
        state = reg.all()[0]
        assert state.breaker.open
        assert router._pool.get(rep.url) is None
        r.note("states", r.states(reg))
        r.replica(port=port)
        r.clock.advance(10)
        reg.refresh()
        assert state.routable()
        resp = _predict(router)
        assert resp[0] == 200, resp
        r.note("states", r.states(reg))


def router_get_retried_on_transport_failure(r):
    bad, good = r.replica(), r.replica()
    bad.fail_gets = True
    router = r.router(r.registry([bad, good]), max_tries=3)
    for _ in range(10):
        assert router.handle("GET", "/model/m:stats", b"", {})[0] == 200
    assert bad.get_attempts > 0


def router_expired_deadline(r):
    reps = r.fleet()
    router = r.router(r.registry(reps))
    resp = router.handle("POST", "/model/m:predict", json.dumps(
        {"instances": [[1]], "deadline_ms": 0.0001}).encode(), {})
    assert resp[0] == 504
    assert sum(len(rep.received()) for rep in reps) == 0
    r.note("answers", _answer(resp))


def router_deadline_rewritten(r):
    reps = r.fleet()
    router = r.router(r.registry(reps))
    assert _predict(router, {"instances": [[1]],
                             "deadline_ms": 60000})[0] == 200
    _, body = [rep for rep in reps if rep.received()][0].received()[0]
    forwarded = json.loads(body)["deadline_ms"]
    assert 0 < forwarded <= 60000
    r.note("forwarded", forwarded)


def router_retry_budget_bounds_amplification(r):
    reps = r.fleet()
    for rep in reps:
        rep.predict_status, rep.retry_after = 429, 1
    router = r.router(r.registry(reps), retry_budget_ratio=0.0,
                      retry_budget_cap=0.0)
    resp = _predict(router)
    assert resp[0] == 429
    assert sum(len(rep.received()) for rep in reps) == 1
    r.note("budget", router.budget.snapshot())


def router_draining_gets_no_new_work(r):
    reps = r.fleet()
    reg = r.registry(reps)
    router = r.router(reg)
    reps[0].draining = True
    reg.refresh()
    for _ in range(10):
        assert _predict(router)[0] == 200
    assert len(reps[0].received()) == 0


def router_no_routable_is_503(r):
    reps = r.fleet()
    reg = r.registry(reps)
    for rep in reps:
        rep.ready = False
    reg.refresh()
    resp = _predict(r.router(reg))
    assert resp[0] == 503 and b"no routable" in resp[2]
    r.note("answers", _answer(resp))


def affinity_readyz_adapters_parsed(r):
    reps = r.fleet()
    reps[0].adapters = {"m": [{"name": "a", "digest": "d1"},
                              {"name": "b", "digest": "d2"}]}
    reg = r.registry(reps)
    states = {s.name: s for s in reg.all()}
    assert states["r0"].has_adapter("m", "a")
    assert states["r0"].has_adapter("m", "b")
    assert not states["r0"].has_adapter("m", "zz")
    assert not states["r0"].has_adapter("other", "a")
    assert not states["r1"].has_adapter("m", "a")
    row = next(row for row in reg.describe() if row["name"] == "r0")
    assert row["adapters"] == {"m": ["a", "b"]}
    reps[0].adapters = {"m": [{"name": "b", "digest": "d2"}]}
    reg.refresh()
    states = {s.name: s for s in reg.all()}
    assert not states["r0"].has_adapter("m", "a")
    assert states["r0"].has_adapter("m", "b")


def affinity_path_parse(r):
    f = r.p.router.FleetRouter._path_adapter
    cases = ["/model/m@a:predict", "/model/m@a", "/model/m@a:generate",
             "/model/m:predict", "/model/m@:predict",
             "/model/m/versions/1:predict", "/healthz"]
    got = [f(c) for c in cases]
    assert got == [("m", "a"), ("m", "a"), ("m", "a"), None, None, None,
                   None]
    r.note("parsed", got)


def affinity_pick_prefers_warm(r):
    reps = r.fleet()
    reps[2].adapters = {"m": [{"name": "a", "digest": "d1"}]}
    router = r.router(r.registry(reps))
    hits = _metric(r.p, "kft_router_adapter_affinity_total", outcome="hit")
    for _ in range(8):
        assert router.pick(adapter=("m", "a")).name == "r2"
    assert _metric(r.p, "kft_router_adapter_affinity_total",
                   outcome="hit") == hits + 8
    picked = [router.pick(adapter=("m", "zz")).name for _ in range(24)]
    assert len(set(picked)) > 1
    router.pick()
    r.note("picked", picked)


def affinity_routed_predict_lands_warm(r):
    reps = r.fleet()
    reps[1].adapters = {"m": [{"name": "a", "digest": "d1"}]}
    reg = r.registry(reps)
    router = r.router(reg)
    for _ in range(5):
        assert _predict(router, path="/model/m@a:predict")[0] == 200
    assert len(reps[1].received()) == 5
    reps[1].draining = True
    reg.refresh()
    assert _predict(router, path="/model/m@a:predict")[0] == 200
    assert len(reps[1].received()) == 5


def _pair(r, die_after=5, meta=None):
    dying, survivor = r.replica(), r.replica()
    dying.gen_die_after = die_after
    survivor.inflight = 50
    if meta is not None:
        dying.gen_meta = dict(meta)
        survivor.gen_meta = dict(meta)
    return dying, survivor, r.registry([dying, survivor])


def _generates(rep):
    return [json.loads(b) for p, b in rep.received()
            if p.endswith(":generate")]


def _fetches(rep):
    return [json.loads(b) for p, b in rep.received()
            if p.endswith(":fetch_kv")]


def stream_resume_splice(r):
    dying, survivor, reg = _pair(r)
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.tokens() == dying.gen_tokens
    assert sink.lines[-1] == {"done": True,
                              "tokens_emitted": len(dying.gen_tokens)}
    assert _generates(survivor)[0]["resume_tokens"] == dying.gen_tokens[:5]
    assert _keys(dying, survivor) == (1, False)
    r.note("lines", sink.lines)
    r.note("states", r.states(reg))


def stream_seeded_replays_and_skips(r):
    dying, survivor, reg = _pair(r, 4, {"resumable": False, "seeded": True})
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.tokens() == dying.gen_tokens
    assert "resume_tokens" not in _generates(survivor)[0]
    r.note("lines", sink.lines)


def stream_unseeded_keeps_502(r):
    dying, survivor, reg = _pair(r)
    dying.gen_meta = {"resumable": False, "seeded": False}
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.lines[-1].get("code") == 502
    assert survivor.received() == []
    r.note("lines", [m for m in sink.lines if "error" not in m]
           + [{"code": sink.lines[-1]["code"]}])


def stream_death_before_any_token(r):
    dying, survivor, reg = _pair(r, 0, {"resumable": False,
                                        "seeded": False})
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.tokens() == dying.gen_tokens
    assert "resume_tokens" not in _generates(survivor)[0]
    r.note("lines", sink.lines)


def stream_death_force_ejects(r):
    dying, survivor, reg = _pair(r)
    _stream(r.router(reg))
    states = {s.name: s for s in reg.all()}
    assert states["r0"].breaker.open
    assert states["r0"].breaker.state() in ("open", "half_open")
    assert not states["r1"].breaker.open
    r.note("states", r.states(reg))


@pytest.fixture(params=["cap", "budget"])
def denial(request):
    return request.param


def stream_failover_denied(r, denial="cap"):
    dying, survivor, reg = _pair(r)
    kw = ({"max_replays": 0} if denial == "cap" else
          {"retry_budget_ratio": 0.0, "retry_budget_cap": 0.0})
    plain, sink = _stream(r.router(reg, **kw))
    assert plain is None and sink.lines[-1].get("code") == 502
    assert survivor.received() == []
    r.note("tokens", sink.tokens())


def stream_pre_stream_failure_plain(r):
    rep = r.replica()
    reg = r.registry([rep])
    router = r.router(reg)
    for s in reg.all():
        with s._lock:
            s.ready = False
    plain, sink = _stream(router)
    assert plain is not None and plain[0] == 503 and not sink.started
    r.note("answers", _answer(plain))


def stream_recovered_trace_has_replay_span(r):
    dying, survivor, reg = _pair(r)
    r.p.tracing.enable(sample_rate=0.0, capacity=32)
    try:
        plain, sink = _stream(r.router(reg))
        assert plain is None and sink.tokens() == dying.gen_tokens
        traces = r.p.tracing.store().traces()
    finally:
        r.p.tracing.disable()
    assert len(traces) == 1
    trace = traces[0]
    assert trace["status"] == "recovered" and trace["retained"] == "error"
    by_name = {}
    for s in trace["spans"]:
        by_name.setdefault(s["name"], s)
    root = by_name["router.request"]
    assert root["parent_id"] is None
    assert by_name["router.forward"]["parent_id"] == root["span_id"]
    replay = by_name["router.replay"]
    assert replay["parent_id"] == root["span_id"]
    assert (replay["attrs"]["dead"], replay["attrs"]["replica"],
            replay["attrs"]["resume_tokens"]) == ("r0", "r1", 5)
    ids = {s["span_id"]: s["name"] for s in trace["spans"]}
    r.note("spans", sorted(
        (s["name"], ids.get(s["parent_id"]), s["status"],
         tuple(sorted((k, v) for k, v in s["attrs"].items()
                      if k != "error")))
        for s in trace["spans"]))


HANDOFF = {"block_tokens": 4, "tokens_covered": 8,
           "k": {"b64": "AA==", "shape": [1], "dtype": "uint8"},
           "v": {"b64": "AA==", "shape": [1], "dtype": "uint8"}}


@pytest.fixture(params=["hit", "miss", "error"])
def fetch_outcome(request):
    return request.param


def fetch_resume(r, fetch_outcome="hit"):
    dying, survivor, reg = _pair(r)
    if fetch_outcome == "hit":
        survivor.fetch_payload = dict(HANDOFF)
    elif fetch_outcome == "error":
        survivor.fetch_status = 500
    outcome = {"hit": "ok"}.get(fetch_outcome, fetch_outcome)
    before = _metric(r.p, "kft_router_kv_fetch_total", outcome=outcome)
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.tokens() == dying.gen_tokens
    fetches, gens = _fetches(survivor), _generates(survivor)
    assert len(fetches) == 1
    assert fetches[0]["tokens"] == [1, 2, 3] + dying.gen_tokens[:5]
    assert gens[0]["resume_tokens"] == dying.gen_tokens[:5]
    if fetch_outcome == "hit":
        assert gens[0]["kv_handoff"] == HANDOFF
    else:
        assert "kv_handoff" not in gens[0]
    assert _metric(r.p, "kft_router_kv_fetch_total",
                   outcome=outcome) == before + 1
    r.note("generate_bodies", gens)


def fetch_seeded_replay_never_fetches(r):
    dying, survivor, reg = _pair(r, 4, {"resumable": False, "seeded": True})
    survivor.fetch_payload = dict(HANDOFF)
    plain, sink = _stream(r.router(reg))
    assert sink.tokens() == dying.gen_tokens
    gens = _generates(survivor)
    assert _fetches(survivor) == []
    assert "kv_handoff" not in gens[0] and "resume_tokens" not in gens[0]


def _tiers(r):
    pre, dec, uni = r.fleet()
    pre.role, dec.role = "prefill", "decode"
    return pre, dec, uni, r.registry([pre, dec, uni])


def tiers_learned(r):
    pre, dec, uni, reg = _tiers(r)
    tiers = {s.name: s.tier for s in reg.all()}
    assert tiers == {"r0": "prefill", "r1": "decode", "r2": "unified"}
    assert {row["name"]: row["tier"] for row in reg.describe()} == tiers


def tiers_pipeline_prefill_then_decode(r):
    pre, dec, uni, reg = _tiers(r)
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.tokens() == dec.gen_tokens
    assert [p for p, _ in pre.received()] == ["/model/m:prefill"]
    path, body = dec.received()[0]
    assert path == "/model/m:generate"
    assert json.loads(body)["kv_handoff"] == pre.prefill_payload
    assert uni.received() == []
    r.note("lines", sink.lines)


@pytest.fixture(params=["status", "null", "fault"])
def prefill_failure(request):
    return request.param


def tiers_prefill_failure_falls_back(r, prefill_failure="status"):
    pre, dec, uni, reg = _tiers(r)
    router = r.router(reg)
    if prefill_failure == "status":
        pre.prefill_status = 500
    elif prefill_failure == "null":
        pre.prefill_payload = None
    if prefill_failure == "fault":
        inj = r.p.faults.parse("router.tier_dispatch:raise")
        r.p.faults.install(inj)
        try:
            plain, sink = _stream(router)
        finally:
            r.p.faults.install(None)
        assert inj.fired("router.tier_dispatch") == 1
        assert not any(p.endswith(":prefill") for p, _ in pre.received())
    else:
        plain, sink = _stream(router)
    assert plain is None and sink.tokens() == dec.gen_tokens
    for rep in (pre, dec, uni):
        for path, body in rep.received():
            if path.endswith(":generate"):
                assert "kv_handoff" not in json.loads(body)
    r.note("lines", sink.lines)


def tiers_decode_death_sheds_429(r):
    pre, dec, uni, reg = _tiers(r)
    dec.gen_die_after = 2
    plain, sink = _stream(r.router(reg))
    assert plain is None and sink.lines[-1].get("code") == 429
    assert [s for s in reg.all() if s.name == "r1"][0].breaker.open
    r.note("lines", sink.lines)
    r.note("states", r.states(reg))


class _FixedLoad:
    """Registry stand-in: the autoscaler reads only total_load() and
    ready_count()."""

    def __init__(self, load, ready=1):
        self.load = load
        self.ready = ready

    def total_load(self):
        return self.load

    def ready_count(self):
        return self.ready


def _scaler(r, kube, reg, **kw):
    kw.setdefault("target_inflight_per_replica", 4.0)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 8)
    kw.setdefault("scale_up_cooldown_s", 10.0)
    kw.setdefault("scale_down_cooldown_s", 60.0)
    return r.p.autoscaler.Autoscaler(kube, "kf", "srv", reg, **kw)


def _kube(r, replicas):
    kube = r.p.kube.FakeKube()
    kube.create_deployment({"metadata": {"namespace": "kf", "name": "srv"},
                            "spec": {"replicas": replicas}})
    return kube


def _spec_replicas(kube):
    return kube.get_deployment("kf", "srv")["spec"]["replicas"]


# (initial replicas, load, scaler kwargs, clock advance before the pass,
# expected (applied, desired)) — test_fleet.py's one-pass cases.
ONE_PASS = {
    "scale_up_on_load": (1, 20.0, {}, 0, (True, 5)),
    "hysteresis_band": (2, 9.0, {"tolerance": 0.2}, 0, (False, 2)),
    "min_bound_at_zero_load": (3, 0.0, {"min_replicas": 2}, 120,
                               (True, 2)),
    "scale_to_zero": (1, 0.0, {"min_replicas": 0}, 120, (True, 0)),
}


@pytest.fixture(params=sorted(ONE_PASS))
def one_pass(request):
    return request.param


def autoscaler_one_pass(r, one_pass="scale_up_on_load"):
    replicas, load, kw, advance, (applied, desired) = ONE_PASS[one_pass]
    kube = _kube(r, replicas)
    with r.p.faults.injected("seed=0"):
        scaler = _scaler(r, kube, _FixedLoad(load, ready=replicas), **kw)
        r.clock.advance(advance)
        out = scaler.reconcile_once()
    assert (out["applied"], out["desired"]) == (applied, desired)
    assert _spec_replicas(kube) == desired
    r.note("records", out)


def autoscaler_cooldowns(r):
    kube = _kube(r, 1)
    reg = _FixedLoad(9.0, ready=1)
    with r.p.faults.injected("seed=0"):
        scaler = _scaler(r, kube, reg)
        r.note("records", scaler.reconcile_once())
        assert r.record["records"][-1]["applied"]
        reg.load = 30.0
        r.note("records", scaler.reconcile_once())
        assert not r.record["records"][-1]["applied"]
        r.clock.advance(11)
        out = scaler.reconcile_once()
        assert out["applied"] and out["desired"] == 8
        r.note("records", out)
        # Scale-down waits the longer cooldown.
        reg.load, reg.ready = 2.0, 8
        r.clock.advance(11)
        r.note("records", scaler.reconcile_once())
        assert not r.record["records"][-1]["applied"]
        r.clock.advance(60)
        out = scaler.reconcile_once()
        assert out["applied"] and out["desired"] == 1
        r.note("records", out)
        # Level-triggered: the same load gives the same answer.
        r.clock.advance(120)
        out = scaler.reconcile_once()
        assert not out["applied"] and _spec_replicas(kube) == 1
        r.note("records", out)


class _StubClaims:
    """The claims hook's duck type (the JAX package's ServingClaimClient
    stands behind it there): ``sync(desired)`` returns the claim's view;
    a desire of 0 releases the claim."""

    def __init__(self, grant=True):
        self.grant = grant
        self.synced = []

    def sync(self, desired):
        self.synced.append(desired)
        if desired == 0:
            return {"state": "released", "desired": 0}
        return {"state": "granted" if self.grant else "denied",
                "desired": desired}


def autoscaler_claims_hook(r):
    kube = _kube(r, 2)
    reg = _FixedLoad(8.0, ready=2)
    claims = _StubClaims()
    with r.p.faults.injected("seed=0"):
        scaler = _scaler(r, kube, reg, claims=claims, tolerance=0.2,
                         min_replicas=0)
        out = scaler.reconcile_once()
        assert not out["applied"] and out["claim"]["state"] == "granted"
        for load in (9.0, 7.0, 9.5, 6.5):
            reg.load = load
            r.clock.advance(120)
            assert not scaler.reconcile_once()["applied"]
        reg.load = 20.0
        r.clock.advance(120)
        out = scaler.reconcile_once()
        assert out["applied"] and out["desired"] == 5
        reg.load = 0.0
        r.clock.advance(120)
        out = scaler.reconcile_once()
        assert out["claim"]["state"] == "released"
    # Desire rides the claim; spec.replicas is the arbiter's.
    assert _spec_replicas(kube) == 2
    r.note("synced", claims.synced)
    r.note("records", out)


# -- colocation mode on each package's real ServingClaimClient
# (test_fleet.py's TestAutoscalerClaims) ----------------------------------


def _claim_scaler(r, kube, reg, **kw):
    kw.setdefault("claims", r.p.colocate.ServingClaimClient(kube, "kf",
                                                            "srv"))
    kw.setdefault("target_inflight_per_replica", 4.0)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 8)
    return r.p.autoscaler.Autoscaler(kube, "kf", "srv", reg, **kw)


def _claim_cr(kube):
    """The claim CR as the arbiter reads it, its slice type named by the
    port (the claim client's default: v5e-8 in JAX, h100-8 here, eight
    chips a replica in both)."""
    cr = kube.get_custom("kf", "serving-srv")
    spec = dict(cr["spec"], sliceType=SLICE_MAP.get(
        cr["spec"]["sliceType"], cr["spec"]["sliceType"]))
    return {"metadata": cr["metadata"], "spec": spec,
            "status": cr.get("status")}


def claims_desire_rides_claim_cr(r):
    kube = _kube(r, 1)
    with r.p.faults.injected("seed=0"):
        out = _claim_scaler(r, kube, _FixedLoad(20.0)).reconcile_once()
    assert out["applied"] and out["desired"] == 5
    assert out["claim"]["state"] == "pending"
    cr = _claim_cr(kube)
    assert cr["spec"]["numSlices"] == 5
    assert cr["spec"]["sliceType"] == "h100-8"
    assert cr["metadata"]["labels"]["kubeflow-tpu.org/workload"] == \
        "serving"
    # spec.replicas untouched: the reconciler patches on GRANT.
    assert _spec_replicas(kube) == 1
    r.note("records", out)
    r.note("cr", cr)


def claims_scale_to_zero_releases_whole_claim(r):
    kube = _kube(r, 2)
    reg = _FixedLoad(8.0)
    with r.p.faults.injected("seed=0"):
        scaler = _claim_scaler(r, kube, reg, min_replicas=0)
        r.note("records", scaler.reconcile_once())
        r.note("cr", _claim_cr(kube))
        reg.load = 0.0
        r.clock.advance(120)
        out = scaler.reconcile_once()
    assert out["desired"] == 0
    assert out["claim"]["state"] == "released"
    with pytest.raises(r.p.kube.NotFound):
        kube.get_custom("kf", "serving-srv")
    assert _spec_replicas(kube) == 0
    r.note("records", out)


def claims_hysteresis_band_never_flaps_claim(r):
    creates = []
    kube = _kube(r, 2)
    create_custom = kube.create_custom

    def counting_create(cr):
        creates.append(cr["spec"]["numSlices"])
        return create_custom(cr)
    kube.create_custom = counting_create
    reg = _FixedLoad(8.0, ready=2)
    with r.p.faults.injected("seed=0"):
        scaler = _claim_scaler(r, kube, reg, tolerance=0.2)
        r.note("records", scaler.reconcile_once())
        assert creates == [2]
        for load in (9.0, 7.0, 9.5, 6.5):
            reg.load = load
            r.clock.advance(120)
            out = scaler.reconcile_once()
            assert not out["applied"]
            r.note("records", out)
    assert creates == [2]   # synced every pass, churned never
    assert _claim_cr(kube)["spec"]["numSlices"] == 2


def claims_denied_claim_reported_and_counted(r):
    kube = _kube(r, 1)
    with r.p.faults.injected("seed=0"):
        scaler = _claim_scaler(r, kube, _FixedLoad(20.0))
        r.note("records", scaler.reconcile_once())
        # The arbiter's verdict comes back on the claim status.
        kube.update_custom_status("kf", "serving-srv",
                                  {"grantedReplicas": 0, "denied": True})
        r.clock.advance(11)   # past the up-cooldown: desire holds
        out = scaler.reconcile_once()
    assert out["claim"]["state"] == "denied"
    assert _spec_replicas(kube) == 1
    r.note("records", out)


def claims_no_colocation_restores_direct_patch(r):
    kube = _kube(r, 1)
    with r.p.faults.injected("seed=0") as inj:
        out = _claim_scaler(r, kube, _FixedLoad(20.0),
                            claims=None).reconcile_once()
        assert inj.fired("autoscaler.claim") == 0
    assert out["applied"] and "claim" not in out
    assert _spec_replicas(kube) == 5
    assert not kube.list_custom()
    r.note("records", out)


def claims_sync_is_a_fault_site(r):
    """``autoscaler.claim`` fires on every sync; a raising sync leaves
    the claim CR and spec.replicas as they were."""
    kube = _kube(r, 1)
    client = r.p.colocate.ServingClaimClient(kube, "kf", "srv")
    with r.p.faults.injected("seed=20260804;autoscaler.claim:raise*1") \
            as inj:
        with pytest.raises(r.p.faults.FaultInjected):
            client.sync(2)
        assert not kube.list_custom()
        r.note("synced", client.sync(2))
        r.note("fired", inj.fired("autoscaler.claim"))
    assert _claim_cr(kube)["spec"]["numSlices"] == 2
    assert _spec_replicas(kube) == 1


def autoscaler_rejects_zero_target(r):
    with pytest.raises(ValueError, match="target_inflight_per_replica"):
        _scaler(r, _kube(r, 1), _FixedLoad(1.0),
                target_inflight_per_replica=0.0)


def snapshot_lock_discipline(r):
    e = r.p.endpoints
    reg = e.EndpointRegistry(e.StaticEndpoints([]))
    state = e.EndpointState(e.Endpoint(name="r0", url=""), 3,
                            e._EjectBreaker())
    state.ready = True
    reg._states["r0"] = state
    stop = threading.Event()

    def scraper():
        flip = 0.0
        while not stop.is_set():
            flip = 100.0 - flip
            with state._lock:
                state.inflight = flip
                state.queue_depth = 100.0 - flip

    t = threading.Thread(target=scraper, daemon=True)
    t.start()
    try:
        for _ in range(1000):
            assert reg.total_load() == 100.0
    finally:
        stop.set()
        t.join(timeout=5)
    state.breaker.failure_count = lambda: 777
    assert reg.describe()[0]["breaker_failures"] == 777


SCRIPTS = {f.__name__: f for f in [
    registry_discovery_and_readiness, registry_draining_not_ejected,
    registry_load_scraped, registry_dead_replica_ejected,
    registry_half_open_recovery, registry_describe_without_deadlock,
    registry_half_open_released_when_not_ready, kube_endpoint_sources,
    router_p2c_prefers_lower_load, router_overloaded_retried_on_other,
    router_all_overloaded_min_retry_after,
    router_dead_replica_retried_and_ejected,
    router_transport_failure_replayed_same_key, router_client_key_forwarded,
    router_non_model_post_never_replayed, router_reused_conn_death_recovers,
    router_probe_ejection_purges_pool, router_get_retried_on_transport_failure,
    router_deadline_rewritten, router_retry_budget_bounds_amplification,
    router_draining_gets_no_new_work, router_no_routable_is_503,
    affinity_readyz_adapters_parsed, affinity_path_parse,
    affinity_pick_prefers_warm, affinity_routed_predict_lands_warm,
    stream_resume_splice, stream_seeded_replays_and_skips,
    stream_unseeded_keeps_502, stream_death_before_any_token,
    stream_death_force_ejects, stream_pre_stream_failure_plain,
    stream_recovered_trace_has_replay_span,
    fetch_seeded_replay_never_fetches, tiers_learned,
    tiers_pipeline_prefill_then_decode, tiers_decode_death_sheds_429,
    autoscaler_cooldowns, autoscaler_claims_hook,
    claims_desire_rides_claim_cr, claims_scale_to_zero_releases_whole_claim,
    claims_hysteresis_band_never_flaps_claim,
    claims_denied_claim_reported_and_counted,
    claims_no_colocation_restores_direct_patch, claims_sync_is_a_fault_site,
    autoscaler_rejects_zero_target, snapshot_lock_discipline]}


def _run(name, monkeypatch, script, clock_tick=0.0, **kw):
    """Run ``script`` on each package; returns {package: what it
    recorded}, the replicas' request log and the metric deltas."""
    out = {}
    for pkg_name, pkg in PACKAGES.items():
        clock = _Clock(clock_tick)
        monkeypatch.setattr(pkg.faults, "monotonic", clock)
        run = _Run(pkg, clock)
        _zero_gauges(pkg)
        before = _samples(pkg)
        try:
            script(run, **kw)
        finally:
            for router in run.routers:
                router.close()
            for rep in run.replicas:
                rep.kill()
        after = _samples(pkg)
        deltas = {k: v - before.get(k, 0.0) for k, v in after.items()
                  if v != before.get(k, 0.0)}
        out[pkg_name] = (run.record, run.log, deltas)
    return out


def _same(out):
    jax_record, jax_log, jax_deltas = out["jax"]
    record, log, deltas = out["port"]
    assert log == jax_log
    assert record == jax_record
    assert deltas == jax_deltas


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_port_decides_as_jax(name, monkeypatch):
    _same(_run(name, monkeypatch, SCRIPTS[name]))


def test_expired_deadline_decides_as_jax(monkeypatch):
    """A 100 ns budget on a clock that moves a millisecond a read has
    expired at the router's first re-check: 504, no replica touched."""
    _same(_run("expired", monkeypatch, router_expired_deadline,
               clock_tick=1e-3))


def test_replay_cap_decides_as_jax(monkeypatch, max_replays):
    _same(_run("cap", monkeypatch, router_replay_cap,
               max_replays=max_replays))


def test_stream_failover_denial_decides_as_jax(monkeypatch, denial):
    _same(_run("denial", monkeypatch, stream_failover_denied,
               denial=denial))


def test_fetch_resume_decides_as_jax(monkeypatch, fetch_outcome):
    _same(_run("fetch", monkeypatch, fetch_resume,
               fetch_outcome=fetch_outcome))


def test_prefill_failure_decides_as_jax(monkeypatch, prefill_failure):
    _same(_run("prefill", monkeypatch, tiers_prefill_failure_falls_back,
               prefill_failure=prefill_failure))


def test_autoscaler_pass_decides_as_jax(monkeypatch, one_pass):
    _same(_run("pass", monkeypatch, autoscaler_one_pass,
               one_pass=one_pass))


def test_router_server_surface_matches_jax():
    """``make_router_server``'s own routes (/healthz, /readyz,
    /fleet/endpoints) answer alike, a proxied :predict and an NDJSON
    :generate through each package's HTTP front reach the replica, and
    drain flips /readyz to 503; each router, its upstream pool and its
    listener are closed."""
    import http.client

    answers = {}
    for pkg_name, pkg in PACKAGES.items():
        log = []
        reps = [_Replica(log, i) for i in range(2)]
        reg = pkg.endpoints.EndpointRegistry(pkg.endpoints.StaticEndpoints(
            [pkg.endpoints.Endpoint(name=f"r{i}", url=rep.url)
             for i, rep in enumerate(reps)]), rng=random.Random(0))
        reg.refresh()
        router = pkg.router.FleetRouter(reg, rng=random.Random(0))
        httpd, thread = pkg.router.make_router_server(router, port=0,
                                                      host="127.0.0.1")
        got = []
        try:
            port = httpd.server_address[1]

            def call(method, path, body=None):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=30)
                try:
                    conn.request(method, path, body=body)
                    resp = conn.getresponse()
                    return resp.status, resp.read()
                finally:
                    conn.close()

            got.append(call("GET", "/healthz"))
            got.append(call("GET", "/readyz"))
            status, body = call("GET", "/fleet/endpoints")
            table = json.loads(body)
            got.append((status, sorted(
                (e["name"], e["state"]) for e in table["endpoints"]),
                table["retry_budget"], table["max_replays"]))
            got.append(call("POST", "/model/m:predict",
                            json.dumps({"instances": [[1]]}).encode()))
            status, body = call("POST", "/model/m:generate",
                                json.dumps({"tokens": [1]}).encode())
            got.append((status, [json.loads(line) for line in
                                 body.splitlines() if line.strip()]))
            router.begin_drain()
            got.append(call("GET", "/readyz"))
            assert b"kft_router_requests_total" in call("GET",
                                                        "/metrics")[1]
        finally:
            httpd.shutdown()
            httpd.server_close()
            router.close()
            for rep in reps:
                rep.kill()
            thread.join(timeout=5)
        assert not thread.is_alive()
        answers[pkg_name] = (got, log)
    assert answers["port"] == answers["jax"]
    assert answers["port"][0][-1][0] == 503


def test_fleet_main_flags_match_jax_and_colocation_builds_a_claim_client(
        monkeypatch):
    """The port's entry point takes the JAX entry point's flags with the
    same defaults (the claim shape aside: an H100 gang, where JAX names
    a TPU slice), ``--no-colocation`` keeps the direct patch path, and
    without it ``--autoscale_deployment`` builds the scheduler's
    ``ServingClaimClient`` from the ``--claim_*`` flags, hands it to the
    autoscaler and the claim's pool snapshot to the router's status
    route, as JAX's ``main`` does."""
    jax_args = vars(jax_main.build_parser().parse_args([]))
    port_args = vars(port_main.build_parser().parse_args([]))
    assert set(port_args) == set(jax_args)
    differ = {k for k in jax_args if port_args[k] != jax_args[k]}
    assert differ == {"claim_slice_type"}
    assert port_args["claim_slice_type"] == "h100-8"
    assert SLICE_MAP[jax_args["claim_slice_type"]] == "h100-8"
    assert port_main.build_parser().parse_args(
        ["--no-colocation"]).no_colocation is True

    built = {}
    for pkg_name, pkg in PACKAGES.items():
        seen = {}

        class Recorder:
            def __init__(self, kube, namespace, deployment, registry, **kw):
                seen["autoscaler"] = (namespace, deployment, kw)

            def start(self, interval_s):
                seen["interval_s"] = interval_s

            def stop(self):
                seen["stopped"] = True

        class Router(pkg.router.FleetRouter):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                seen["router"] = self

        stop = threading.Event()
        stop.set()   # main's signal wait returns at once: drain, exit
        with monkeypatch.context() as mp:
            mp.setattr(pkg.main, "Autoscaler", Recorder)
            mp.setattr(pkg.main, "FleetRouter", Router)
            mp.setattr(pkg.main, "threading",
                       types.SimpleNamespace(Event=lambda: stop))
            mp.setattr(pkg.main, "signal", types.SimpleNamespace(
                SIGTERM=15, SIGINT=2, signal=lambda *a: None))
            assert pkg.main.main([
                "--autoscale_deployment", "srv", "--port", "0",
                "--host", "127.0.0.1", "--endpoints", "http://127.0.0.1:1",
                "--kube_base_url", "http://127.0.0.1:1",
                "--kube_namespace", "kf", "--claim_tenant", "team",
                "--claim_priority", "normal", "--claim_image", "img:1",
                "--drain_deadline_s", "0"]) == 0
        namespace, deployment, kw = seen["autoscaler"]
        claims = kw.pop("claims")
        assert isinstance(claims, pkg.colocate.ServingClaimClient)
        assert seen["router"].pool_status == claims.pool
        assert seen["stopped"] is True
        built[pkg_name] = (namespace, deployment, kw, claims.key,
                           SLICE_MAP.get(claims.slice_type,
                                         claims.slice_type),
                           claims.tenant, claims.priority, claims.image)
    assert built["port"] == built["jax"]
    assert built["port"][3:] == ("kf/serving-srv", "h100-8", "team",
                                 "normal", "img:1")


def test_fleet_main_runs_the_router_as_a_process():
    """``python -m kubeflow_tpu_torch.fleet.main`` in front of a replica:
    it prints KFT_ROUTER_READY with its port, proxies a :predict, and on
    SIGTERM drains and exits 0."""
    import os
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    log = []
    rep = _Replica(log, 0)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env.pop("KFT_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.fleet.main", "--port",
         "0", "--host", "127.0.0.1", "--endpoints", rep.url,
         "--drain_deadline_s", "5"],
        cwd=str(Path(__file__).resolve().parents[1]), env=env,
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    # A router that hangs before its ready line is killed, which ends
    # the read below.
    watchdog = threading.Timer(60, proc.kill)
    watchdog.start()
    try:
        port = None
        for line in proc.stderr:
            if line.startswith("KFT_ROUTER_READY rest="):
                port = int(line.split("=", 1)[1])
                break
        assert port is not None, "the router never printed its port"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/model/m:predict",
            data=json.dumps({"instances": [[1]]}).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == {"predictions": [{"ok": True}]}
        assert log == [(0, "POST", "/model/m:predict")]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stderr.close()
        rep.kill()
