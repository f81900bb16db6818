"""Replica endpoint registry: discovery, readiness, ejection state (the
port's copy of kubeflow_tpu/fleet/endpoints.py, stdlib only).

One object (EndpointRegistry) owns the fleet's view of its replicas:

  discovery   a *source* enumerates endpoints — a static list
              (StaticEndpoints) or label-selected pods read through the
              operator's kube client (KubeEndpoints, which works
              identically against a real apiserver and
              testing/fake_apiserver.py)
  readiness   each refresh probes every endpoint's /readyz (the
              serving route: 200 = ready, 503 {"status": "draining"} = draining
              — a draining replica stops receiving NEW work while its
              in-flight completes) or, for gRPC-only replicas, the
              grpc.health.v1 Check mirror of it
  load        the same refresh scrapes /metrics and keeps the parsed
              kft_serving_inflight / kft_serving_queue_depth gauges per
              endpoint — the router's power-of-two-choices signal and
              the autoscaler's utilization input
  ejection    consecutive failures (probe or live traffic, reported by
              the router) trip a per-endpoint circuit breaker with
              jittered exponential backoff and a half-open single-probe
              trial — the _ReloadBreaker discipline from
              serving/model_server.py applied to replicas instead of
              checkpoints

All policy clocks read testing/faults.monotonic() so chaos tests drive
ejection/recovery walks without wall-clock sleeps.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.runtime.prom import REGISTRY, parse_metrics, sample_value
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

EJECTIONS_TOTAL = "kft_router_ejections_total"
EJECTIONS_HELP = "endpoint circuit-breaker trips, by endpoint"
ENDPOINTS_GAUGE = "kft_router_endpoints"
ENDPOINTS_HELP = "fleet endpoints by state (routable/draining/ejected/down)"


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One replica address.  ``url`` is the REST base (http://host:port)
    used for routing, probing, and scraping; ``grpc_target`` (host:port)
    switches the readiness probe to the grpc.health.v1 Check for
    gRPC-only replicas (which the router can then still health-track
    even though it proxies no HTTP to them)."""

    name: str
    url: str = ""
    grpc_target: str = ""


class _EjectBreaker:
    """Outlier-ejection circuit breaker for one endpoint.

    Same invariants as model_server._ReloadBreaker (exponential backoff
    with jitter, half-open single trial, policy clock), minus the
    version-reset — a replica has no artifact version; recovery is a
    successful half-open probe."""

    def __init__(self, base_s: float = 1.0, cap_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self._base_s = base_s
        self._cap_s = cap_s
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.failures = 0
        self.open_until = 0.0
        self._half_open = False

    def allow(self) -> bool:
        """May a trial (probe or request) hit the endpoint now?  Claims
        the single half-open slot once the backoff has expired."""
        with self._lock:
            if self.failures == 0:
                return True
            if self._half_open:
                return False
            if faults.monotonic() < self.open_until:
                return False
            self._half_open = True
            return True

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._half_open = False
            backoff = min(self._cap_s,
                          self._base_s * (2 ** (self.failures - 1)))
            backoff *= 1.0 + 0.25 * self._rng.random()
            self.open_until = faults.monotonic() + backoff

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self.open_until = 0.0
            self._half_open = False

    def cancel_trial(self) -> None:
        """Release a claimed half-open slot without a verdict: the
        trial REACHED the endpoint but it answered not-ready (e.g. a
        restarted pod still loading models).  Re-arms the backoff at
        its current width (no doubling — the replica is alive) so the
        next window probes again; without this the slot would stay
        claimed forever and the endpoint could never rejoin."""
        with self._lock:
            if not self._half_open:
                return
            self._half_open = False
            backoff = min(self._cap_s,
                          self._base_s * (2 ** max(0, self.failures - 1)))
            backoff *= 1.0 + 0.25 * self._rng.random()
            self.open_until = faults.monotonic() + backoff

    @property
    def open(self) -> bool:
        with self._lock:
            return self.failures > 0

    def failure_count(self) -> int:
        """Locked read for status snapshots (describe): ``failures``
        is written under the lock on every verdict, so a bare read
        could tear against a concurrent record_failure."""
        with self._lock:
            return self.failures

    def state(self) -> str:
        """closed / open / half_open — the operator-facing breaker
        phase (`kubeflow-tpu fleet status` BREAKER column)."""
        with self._lock:
            if self.failures == 0:
                return "closed"
            return "half_open" if self._half_open else "open"


class EndpointState:
    """Mutable per-endpoint fleet state (owned by the registry; the
    router reads snapshots and reports request outcomes)."""

    def __init__(self, endpoint: Endpoint, eject_threshold: int,
                 breaker: _EjectBreaker):
        self.endpoint = endpoint
        self._lock = threading.Lock()
        self.ready = False
        self.draining = False
        self.reachable = False
        # Disaggregation tier advertised by the replica's /readyz
        # ("prefill" / "decode" / "unified"): the router's two-tier
        # :generate pipeline keys off this — see FleetRouter.
        self.tier = "unified"
        # Loaded adapter digests advertised on /readyz:
        # {model: {adapter_name: digest}}.  The router's affinity pick
        # prefers replicas already holding a request's adapter resident
        # (a miss elsewhere costs a cold load + possible eviction).
        self.adapters: Dict[str, Dict[str, str]] = {}
        # Scraped load gauges (refresh) + router-local outstanding
        # count: the P2C score adds both — the scrape is stale by up to
        # one refresh interval, and the local count covers exactly the
        # requests that staleness misses (double counting biases the
        # score conservatively, which only dampens bursts).
        self.inflight = 0.0
        self.queue_depth = 0.0
        self.local_inflight = 0
        # Prefix-cache effectiveness scraped off the replica's
        # kft_serving_cached_token_ratio gauge — not a routing signal
        # (cache hits don't make a replica "less loaded" in queue
        # terms), but the per-replica number operators read off
        # `kubeflow-tpu fleet status` to see cache health fleet-wide.
        self.cached_token_ratio = 0.0
        # Host spill-tier occupancy (kft_serving_kv_spill_ratio):
        # like the cache ratio, an operator signal (`fleet
        # status` SPILL%), not a routing input — replicas without a
        # spill tier stay at 0.
        self.kv_spill_ratio = 0.0
        self._consecutive_failures = 0
        self._eject_threshold = max(1, int(eject_threshold))
        self.breaker = breaker

    @property
    def name(self) -> str:
        return self.endpoint.name

    def score(self) -> float:
        with self._lock:
            return self.inflight + self.queue_depth + self.local_inflight

    def routable(self) -> bool:
        """Eligible for NEW work: probed ready, not draining, breaker
        closed (an open breaker's half-open trial is spent on the probe,
        not on live traffic)."""
        with self._lock:
            if not self.ready or self.draining:
                return False
        return not self.breaker.open

    def has_adapter(self, model: str, adapter: str) -> bool:
        """True when the last /readyz probe advertised ``adapter``
        resident for ``model`` — at most one refresh interval stale,
        which only costs a redundant (idempotent) hot-load on a miss."""
        with self._lock:
            return adapter in self.adapters.get(model, {})

    def state_label(self) -> str:
        if self.breaker.open:
            return "ejected"
        with self._lock:
            if self.draining:
                return "draining"
            if self.ready:
                return "routable"
            return "down" if not self.reachable else "not_ready"

    def enter(self) -> None:
        with self._lock:
            self.local_inflight += 1

    def exit(self) -> None:
        with self._lock:
            self.local_inflight -= 1

    def note_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
        self.breaker.record_success()

    def note_failure(self) -> bool:
        """Count one failure (probe or live request); trips the breaker
        at the consecutive-failure threshold.  Returns True when this
        call ejected the endpoint."""
        with self._lock:
            self._consecutive_failures += 1
            tripped = (self._consecutive_failures
                       >= self._eject_threshold
                       and not self.breaker.open)
        if tripped:
            self.breaker.record_failure()
            REGISTRY.counter(EJECTIONS_TOTAL, EJECTIONS_HELP).inc(
                endpoint=self.name)
            log.warning("endpoint %s ejected (%d consecutive failures)",
                        self.name, self._eject_threshold)
        elif self.breaker.open:
            # Failed half-open trial: double the backoff.
            self.breaker.record_failure()
        return tripped

    def force_eject(self) -> bool:
        """Trip the breaker NOW, bypassing the consecutive-failure
        threshold.  The router calls this when a replica dies
        MID-GENERATION on a proxied stream: that is proof of death,
        not weather — waiting out `eject_threshold` further probes
        would keep offering new work to a corpse.  Recovery is the
        ordinary half-open probe walk.  Returns True when this call
        ejected the endpoint."""
        with self._lock:
            self._consecutive_failures = self._eject_threshold
            tripped = not self.breaker.open
        self.breaker.record_failure()
        if tripped:
            REGISTRY.counter(EJECTIONS_TOTAL, EJECTIONS_HELP).inc(
                endpoint=self.name)
            log.warning("endpoint %s force-ejected "
                        "(died mid-generation)", self.name)
        return tripped


class StaticEndpoints:
    """Fixed endpoint list — the no-kube deployment mode (and the unit
    tests' source of truth)."""

    def __init__(self, endpoints: List[Endpoint]):
        self._endpoints = list(endpoints)

    @classmethod
    def from_urls(cls, urls: List[str]) -> "StaticEndpoints":
        return cls([Endpoint(name=u, url=u) for u in urls])

    def discover(self) -> List[Endpoint]:
        return list(self._endpoints)


class KubeEndpoints:
    """Label-selected pod discovery through the operator kube client
    (FakeKube, HttpKube against testing/fake_apiserver.py, or RealKube
    — all speak list_pods).

    A pod becomes an endpoint when it is Running and carries a pod IP;
    the REST port comes from the first containerPort named ``http``
    (falling back to ``default_port``).  Readiness is NOT taken from the
    pod status — the registry probes /readyz itself, which is what
    makes drain visible the instant the replica flips it, ahead of any
    endpoint-controller propagation delay."""

    def __init__(self, kube: Any, namespace: str,
                 labels: Dict[str, str], default_port: int = 8000):
        self._kube = kube
        self._namespace = namespace
        self._labels = dict(labels)
        self._default_port = default_port

    def discover(self) -> List[Endpoint]:
        out = []
        for pod in self._kube.list_pods(self._namespace, self._labels):
            status = pod.get("status", {})
            if status.get("phase") != "Running":
                continue
            ip = status.get("podIP")
            if not ip:
                continue
            # Port preference: the first containerPort NAMED "http"
            # anywhere in the pod; else the pod's first declared port;
            # else the default.  A metrics sidecar's unnamed port must
            # not beat the serving container's named one.
            ports = [p for c in pod.get("spec", {}).get(
                         "containers", [])
                     for p in c.get("ports", [])
                     if p.get("containerPort")]
            named = [p for p in ports if p.get("name") == "http"]
            chosen = named or ports
            port = int(chosen[0]["containerPort"]) if chosen \
                else self._default_port
            out.append(Endpoint(name=pod["metadata"]["name"],
                                url=f"http://{ip}:{port}"))
        return out


class EndpointRegistry:
    """Discovery + readiness + load for the fleet, refreshed in one
    level-triggered pass (run by a background loop or driven directly
    by tests via refresh())."""

    def __init__(self, source: Any, *,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 eject_threshold: int = 3,
                 eject_backoff_s: float = 1.0,
                 eject_backoff_cap_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self._source = source
        self.probe_interval_s = probe_interval_s
        self._probe_timeout_s = probe_timeout_s
        self._eject_threshold = eject_threshold
        self._eject_backoff_s = eject_backoff_s
        self._eject_backoff_cap_s = eject_backoff_cap_s
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._states: Dict[str, EndpointState] = {}
        self._ratio_exported: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Ejection hook: the router hangs its connection-pool purge
        # here so PROBE-driven ejections (not just router-observed
        # failures) also drop stale keep-alive connections to the
        # corpse — a crashed-and-recovered replica must not greet its
        # first request with a dead pooled socket.
        self.on_eject = None

    # -- discovery + probing ----------------------------------------------

    def set_source(self, source) -> None:
        """Swap the discovery source; the next refresh() reconciles the
        endpoint set against it (bench and tests grow/shrink the fleet
        without rebuilding registry state)."""
        self._source = source

    def refresh(self) -> None:
        """One reconcile pass: re-discover, then probe + scrape every
        endpoint.  Endpoints that left the source are dropped (their
        in-flight requests finish through the router's own reference)."""
        try:
            discovered = self._source.discover()
        except Exception:
            # Discovery weather (apiserver blip) must not wipe the
            # fleet view — keep routing on the last-known endpoints.
            log.exception("endpoint discovery failed; keeping %d known",
                          len(self._states))
            discovered = None
        if discovered is not None:
            with self._lock:
                seen = set()
                for ep in discovered:
                    seen.add(ep.name)
                    known = self._states.get(ep.name)
                    # A known name with a CHANGED address is a new
                    # incarnation (pod recreated, fresh IP/port): its
                    # old breaker/ready state describes the dead one.
                    if known is None or known.endpoint != ep:
                        self._states[ep.name] = EndpointState(
                            ep, self._eject_threshold,
                            _EjectBreaker(self._eject_backoff_s,
                                          self._eject_backoff_cap_s,
                                          self._rng))
                for name in [n for n in self._states if n not in seen]:
                    del self._states[name]
        # Probes run CONCURRENTLY: sequentially, one blackholed
        # replica's probe_timeout would stretch the whole pass by a
        # full timeout per corpse — breaking the "ejected within one
        # probe interval" bound and staling every other replica's
        # load signal.  A pass is bounded by ~one probe timeout total.
        states = self.all()
        if len(states) <= 1:
            for state in states:
                self._probe(state)
        else:
            threads = [threading.Thread(target=self._probe,
                                        args=(state,), daemon=True)
                       for state in states]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=self._probe_timeout_s + 5.0)
        self._export_gauges()

    def _probe(self, state: EndpointState) -> None:
        """Readiness + load for one endpoint.  An open breaker gates
        the probe itself: the half-open single trial IS the probe, so a
        dead replica costs one connection attempt per backoff window,
        and recovery needs no live traffic."""
        if state.breaker.open and not state.breaker.allow():
            return
        ep = state.endpoint
        try:
            faults.fire("fleet.probe")
            if ep.grpc_target and not ep.url:
                from kubeflow_tpu_torch.serving.grpc_server import check_health

                # grpc.health.v1 has no drain/not-ready distinction
                # (both answer NOT_SERVING), so a draining gRPC-only
                # replica reads as not_ready here.  Routing behavior
                # is identical either way — no NEW work — only the
                # state label/metric is coarser than the REST probe's.
                ready, draining, tier, adapters = check_health(
                    ep.grpc_target,
                    timeout=self._probe_timeout_s), False, "unified", {}
            else:
                ready, draining, tier, adapters = self._probe_http(ep.url)
            with state._lock:
                state.reachable = True
                state.ready = ready
                state.draining = draining
                state.tier = tier
                state.adapters = adapters
            if ready or draining:
                state.note_success()
            else:
                # Alive but not ready (still loading): if this was the
                # half-open trial, RELEASE the slot — holding it would
                # leave the endpoint ejected forever.
                state.breaker.cancel_trial()
            if ready and ep.url:
                self._scrape(state)
        except Exception as e:
            with state._lock:
                state.reachable = False
                state.ready = False
            log.debug("probe of %s failed: %s", ep.name, e)
            if state.note_failure() and self.on_eject is not None:
                self.on_eject(state)

    def _probe_http(self, url: str):
        """GET /readyz -> (ready, draining, tier, adapters).  503 is a
        VALID answer — the replica is alive and telling us not to route
        to it; only transport failures count against the breaker.  The
        body's ``role`` key (replicas started with --role) is the
        disaggregation tier; replicas that predate it — or whose body
        is unparsable — read as "unified", so a mixed-version fleet
        degrades to the single-tier path instead of misrouting.  The
        ``adapters`` key ({model: [{name, digest}, ...]})
        flattens to {model: {name: digest}}; replicas that predate it
        simply advertise none, so affinity falls back to plain P2C."""
        tier = "unified"
        try:
            with urllib.request.urlopen(
                    url + "/readyz",
                    timeout=self._probe_timeout_s) as resp:
                body = resp.read()
                adapters: Dict[str, Dict[str, str]] = {}
                try:
                    payload = json.loads(body)
                    role = payload.get("role")
                    if role in ("prefill", "decode", "unified"):
                        tier = role
                    for model, infos in (payload.get("adapters")
                                         or {}).items():
                        adapters[str(model)] = {
                            str(i["name"]): str(i.get("digest", ""))
                            for i in infos if "name" in i}
                except (ValueError, AttributeError, TypeError, KeyError):
                    pass
                return resp.status == 200, False, tier, adapters
        except urllib.error.HTTPError as e:
            body = e.read()
            draining = False
            if e.code == 503:
                try:
                    payload = json.loads(body)
                    draining = payload.get("status") == "draining"
                    role = payload.get("role")
                    if role in ("prefill", "decode", "unified"):
                        tier = role
                except (ValueError, AttributeError):
                    pass
            return False, draining, tier, {}

    def _scrape(self, state: EndpointState) -> None:
        """Parse the replica's /metrics for the load gauges the P2C
        router and the autoscaler consume.  Best-effort: a failed
        scrape keeps the previous numbers (readiness already answered
        the aliveness question this pass)."""
        try:
            with urllib.request.urlopen(
                    state.endpoint.url + "/metrics",
                    timeout=self._probe_timeout_s) as resp:
                parsed = parse_metrics(resp.read().decode())
        except Exception as e:
            log.debug("scrape of %s failed: %s", state.name, e)
            return
        inflight = sample_value(parsed, "kft_serving_inflight") or 0.0
        queue = sum(v for _, v in
                    parsed.get("kft_serving_queue_depth", ()))
        # The unlabeled aggregate sorts first in the rendered series;
        # replicas without a decode engine simply lack the metric.
        ratio = sample_value(parsed, "kft_serving_cached_token_ratio")
        spill = sample_value(parsed, "kft_serving_kv_spill_ratio")
        with state._lock:
            state.inflight = inflight
            state.queue_depth = queue
            if ratio is not None:
                state.cached_token_ratio = ratio
            if spill is not None:
                state.kv_spill_ratio = spill

    def _export_gauges(self) -> None:
        counts: Dict[str, int] = {}
        for state in self.all():
            label = state.state_label()
            counts[label] = counts.get(label, 0) + 1
        gauge = REGISTRY.gauge(ENDPOINTS_GAUGE, ENDPOINTS_HELP)
        for label in ("routable", "draining", "ejected", "down",
                      "not_ready"):
            gauge.set(counts.get(label, 0), state=label)
        # Per-replica cache effectiveness on the ROUTER's /metrics too:
        # one scrape of the router shows the whole fleet's hit rates.
        # Departed replicas' series are zeroed (the engine-close
        # convention) — the prom registry has no series removal, and a
        # scaled-down pod's last ratio must not render as live forever.
        ratio = REGISTRY.gauge(
            "kft_router_cached_token_ratio",
            "per-replica engine prefix-cache hit ratio, by endpoint")
        current = set()
        for state in self.all():
            current.add(state.name)
            ratio.set(state.cached_token_ratio, endpoint=state.name)
        for name in self._ratio_exported - current:
            ratio.set(0.0, endpoint=name)
        self._ratio_exported = current

    # -- router/autoscaler surface ----------------------------------------

    def all(self) -> List[EndpointState]:
        with self._lock:
            return list(self._states.values())

    def routable(self) -> List[EndpointState]:
        return [s for s in self.all() if s.routable()]

    def total_load(self) -> float:
        """Summed scraped in-flight + queue depth across READY replicas
        — the autoscaler's utilization numerator (draining/ejected
        replicas are capacity leaving the fleet, not load to plan
        for).  Each replica's pair is read under its state lock: the
        scrape writes both fields in one locked section, and a torn
        read (new inflight + previous pass's queue depth) would feed
        the autoscaler a load that never existed."""
        total = 0.0
        for s in self.all():
            with s._lock:
                if s.ready:
                    total += s.inflight + s.queue_depth
        return total

    def ready_count(self) -> int:
        count = 0
        for s in self.all():
            with s._lock:
                count += bool(s.ready)
        return count

    def describe(self) -> List[Dict[str, Any]]:
        """JSON-able endpoint table (the router's /fleet/endpoints
        debug route)."""
        out = []
        for s in self.all():
            label = s.state_label()  # takes the state lock itself
            with s._lock:
                out.append({
                    "name": s.name, "url": s.endpoint.url,
                    "state": label,
                    "tier": s.tier,
                    "inflight": s.inflight,
                    "queue_depth": s.queue_depth,
                    "local_inflight": s.local_inflight,
                    "cached_token_ratio": s.cached_token_ratio,
                    "kv_spill_ratio": s.kv_spill_ratio,
                    "adapters": {m: sorted(d) for m, d
                                 in s.adapters.items()},
                    "breaker_failures": s.breaker.failure_count(),
                    "breaker_state": s.breaker.state(),
                })
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.refresh()
                except Exception:
                    log.exception("endpoint refresh failed")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fleet-endpoints")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
