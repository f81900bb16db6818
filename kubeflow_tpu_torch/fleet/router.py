"""Load-aware HTTP router for a fleet of model-server replicas (the
port's copy of kubeflow_tpu/fleet/router.py, stdlib only).

A reverse proxy for the serving REST contract (serving/http.py routes:
predict/classify/stats/metadata) with the behaviors a fleet needs that
a dumb round-robin LB lacks:

  balancing   power-of-two-choices: pick two random routable replicas,
              send to the lower-scored one (scraped in-flight + queue
              depth + router-local outstanding).  P2C gets most of the
              benefit of full least-loaded without herding every router
              onto one stale-scrape "winner".
  deadlines   a request's ``deadline_ms`` becomes an absolute policy-
              clock budget at arrival; each forwarded attempt carries
              the REMAINING budget (rewritten ``deadline_ms``) and a
              matching socket timeout, and an expired budget answers
              504 without burning a replica slot.
  retries     a bounded retry budget (token bucket refilled by a
              fraction of admitted requests) retries on a DIFFERENT
              replica: 429 Overloaded sheds (the replica refused it),
              connection-refused failures (nothing was sent), and any
              GET transport failure.
  replay      every proxied model POST (:predict/:classify/:generate)
              carries an idempotency key — client-supplied
              x-kft-idempotency-key or router-minted — so a transport
              failure after bytes reached a replica is REPLAYABLE: the
              replica's dedup cache answers a completed duplicate and
              attaches an in-flight one (never a double execution),
              and an unanswered request re-executes on a different
              replica.  Replays spend the retry budget plus a
              per-request cap (``max_replays``).  POSTs outside the
              model routes keep the old never-replay 502.
  failover    a :generate STREAM that dies mid-generation replays with
              a ``resume_tokens`` payload (prompt + tokens already
              delivered) when the upstream advertised determinism
              (greedy, `resumable`) — the engine re-admits it as one
              chunked prefill and emits only the suffix — or replays
              from scratch and SKIPS the delivered prefix when a
              sampling seed was recorded (`seeded`); the router
              splices the streams so the client sees one gapless,
              duplicate-free token sequence.  Unseeded sampling
              streams keep today's truncation/502 semantics.  The
              dead replica is force-ejected immediately.
  Retry-After when every candidate shed, the router answers 429 with
              the SMALLEST Retry-After observed — the earliest instant
              any replica predicted it would have room.
  ejection    request failures feed the registry's per-endpoint breaker
              (consecutive failures -> jittered-backoff ejection with
              half-open probe recovery, see fleet/endpoints.py), so a
              dead replica leaves rotation within one probe interval.
  drain       a draining replica (/readyz 503 "draining") receives no
              new work but keeps its in-flight — rolling restarts lose
              zero accepted requests.
  tiering     with BOTH a prefill and a decode pool routable (replicas
              advertise --role on /readyz), a :generate pipelines:
              one prefill replica computes the prompt's KV pages
              (:prefill), the handoff payload rides the body, and the
              stream dispatches to decode-tier replicas only — each
              pool runs at its own roofline (prefill compute-bound,
              decode HBM-bound) and keeps its collectives on its own
              links.  Any prefill-leg failure falls back to the
              untiered path; an exhausted decode pool sheds typed 429
              Overloaded (capacity, not fleet death).  Unified
              replicas keep today's path — strictly additive.

Metrics: kft_router_requests_total{outcome,code},
kft_router_retries_total{reason}, kft_router_retry_budget_exhausted_
total, kft_router_replays_total{outcome}, kft_router_resume_tokens,
kft_router_tier_requests_total{tier}, kft_router_request_seconds,
kft_router_adapter_affinity_total{outcome},
plus the registry's endpoint-state gauges and ejection counters.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.fleet.endpoints import EndpointRegistry, EndpointState
from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

REQUESTS_TOTAL = "kft_router_requests_total"
REQUESTS_HELP = "router requests by outcome and upstream status code"
RETRIES_TOTAL = "kft_router_retries_total"
RETRIES_HELP = "cross-replica retries by reason"
BUDGET_EXHAUSTED_TOTAL = "kft_router_retry_budget_exhausted_total"
BUDGET_EXHAUSTED_HELP = "retries skipped because the budget was empty"
LATENCY_SECONDS = "kft_router_request_seconds"
LATENCY_HELP = "router end-to-end request latency"
REPLAYS_TOTAL = "kft_router_replays_total"
REPLAYS_HELP = ("idempotent-POST replays by outcome: ok/failed = a "
                "replayed request completed/did not, cap_exceeded/"
                "budget_exhausted/not_replayable = a wanted replay "
                "was denied")
RESUME_DEPTH = "kft_router_resume_tokens"
RESUME_DEPTH_HELP = ("tokens already delivered to the client when a "
                     "mid-generation failover resumed")
FETCH_TOTAL = "kft_router_kv_fetch_total"
FETCH_HELP = (
    "failover KV-fetch attempts by outcome: ok = a surviving "
    "peer answered with session pages attached to the replay body, "
    "miss = peers answered but none holds the session, error = every "
    "asked peer failed transport/status, none = no routable peer to "
    "ask — every non-ok outcome falls back to recompute-resume")
ADAPTER_AFFINITY_TOTAL = "kft_router_adapter_affinity_total"
ADAPTER_AFFINITY_HELP = (
    "adapter-affinity picks for model@adapter requests: hit = "
    "a replica already advertising the adapter resident was preferred, "
    "miss = no routable replica advertises it (plain P2C; the chosen "
    "replica hot-loads on admission)")
TIER_REQUESTS_TOTAL = "kft_router_tier_requests_total"
TIER_REQUESTS_HELP = (
    "disaggregated :generate dispatches by tier: prefill = a "
    "prefill-pool handoff attempt, decode = a decode-pool stream "
    "dispatch, unified = the single-tier path (no tiered topology, "
    "or fallback after a prefill failure)")
_RESUME_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                   256.0, 512.0)
# The idempotency-key header: accepted from clients, minted otherwise,
# forwarded verbatim on every attempt of one request (matching
# serving/http.py IDEMPOTENCY_HEADER — duplicated literal to keep the
# fleet layer import-free of the serving package).
IDEMPOTENCY_HEADER = "x-kft-idempotency-key"

# Proxied routes: everything under /model/... plus the replicas' own
# health surface is ROUTED; the router's own health/metrics live on
# distinct paths so a fleet of routers is itself probeable.
_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding",
                "te", "trailer", "upgrade", "proxy-authorization",
                "proxy-authenticate", "host", "content-length"}


class _UpstreamPool:
    """Keep-alive connection pool, one stack per replica URL.

    A fresh TCP connect plus a new handler thread on the replica costs
    ~3.5 ms p50 on loopback (measured) — pure hop tax on every proxied
    request.  Persistent HTTP/1.1 connections amortize both; the pool
    is bounded per endpoint and a connection is only returned after a
    complete, non-close response."""

    def __init__(self, per_endpoint: int = 16):
        self._lock = threading.Lock()
        self._conns: Dict[str, List[http.client.HTTPConnection]] = {}
        self._per_endpoint = per_endpoint

    def get(self, url: str) -> Optional[http.client.HTTPConnection]:
        with self._lock:
            stack = self._conns.get(url)
            return stack.pop() if stack else None

    def put(self, url: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            stack = self._conns.setdefault(url, [])
            if len(stack) < self._per_endpoint:
                stack.append(conn)
                return
        conn.close()

    def close_endpoint(self, url: str) -> None:
        """Drop every pooled connection to one replica (called on
        ejection: a conn pooled before a crash is guaranteed stale)."""
        with self._lock:
            stack = self._conns.pop(url, [])
        for conn in stack:
            conn.close()

    def close(self) -> None:
        with self._lock:
            conns = [c for stack in self._conns.values()
                     for c in stack]
            self._conns.clear()
        for conn in conns:
            conn.close()


class _RetryBudget:
    """Token bucket: every admitted request deposits ``ratio`` tokens
    (capped), every retry withdraws one — so retries are bounded to a
    fraction of live traffic and a brown-out cannot double itself
    through retry amplification."""

    def __init__(self, ratio: float = 0.2, cap: float = 10.0,
                 initial: Optional[float] = None):
        self._lock = threading.Lock()
        self._ratio = ratio
        self._cap = cap
        self._tokens = cap if initial is None else initial

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self._cap, self._tokens + self._ratio)

    def withdraw(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def snapshot(self) -> Dict[str, float]:
        """Remaining/cap for the status surfaces (`fleet status`)."""
        with self._lock:
            return {"tokens": round(self._tokens, 2),
                    "cap": self._cap}


class FleetRouter:
    """Routing core, transport-independent (the HTTP handler and the
    tests both drive handle())."""

    def __init__(self, registry: EndpointRegistry, *,
                 max_tries: int = 3,
                 try_timeout_s: float = 120.0,
                 retry_budget_ratio: float = 0.2,
                 retry_budget_cap: float = 10.0,
                 max_replays: int = 2,
                 rng: Optional[random.Random] = None,
                 pool_status=None):
        self.registry = registry
        # Optional zero-arg callable returning the shared chip pool's
        # accounting (train/serve colocation): surfaced verbatim on
        # /fleet/endpoints for the `fleet status` footer.
        self.pool_status = pool_status
        self.max_tries = max(1, int(max_tries))
        # Per-request replay cap: transport failures AFTER bytes
        # reached a replica may re-execute at most this many times on
        # other replicas (0 restores the never-replay 502 semantics);
        # each replay also spends a retry-budget token.
        self.max_replays = max(0, int(max_replays))
        self.try_timeout_s = try_timeout_s
        self.budget = _RetryBudget(retry_budget_ratio, retry_budget_cap)
        self._pool = _UpstreamPool()
        # Probe-driven ejections must purge the pool too: connections
        # pooled before a crash are guaranteed stale, and handing one
        # to the replica's first post-recovery request would turn a
        # never-executed POST into a non-retryable 502.
        registry.on_eject = \
            lambda state: self._pool.close_endpoint(state.endpoint.url)
        self._rng = rng or random.Random()
        self._draining = threading.Event()
        self._requests = REGISTRY.counter(REQUESTS_TOTAL, REQUESTS_HELP)
        self._retries = REGISTRY.counter(RETRIES_TOTAL, RETRIES_HELP)
        self._exhausted = REGISTRY.counter(BUDGET_EXHAUSTED_TOTAL,
                                           BUDGET_EXHAUSTED_HELP)
        self._latency = REGISTRY.histogram(LATENCY_SECONDS, LATENCY_HELP)
        self._replays = REGISTRY.counter(REPLAYS_TOTAL, REPLAYS_HELP)
        self._resume_hist = REGISTRY.histogram(
            RESUME_DEPTH, RESUME_DEPTH_HELP, buckets=_RESUME_BUCKETS)
        self._tier_requests = REGISTRY.counter(TIER_REQUESTS_TOTAL,
                                               TIER_REQUESTS_HELP)
        self._fetches = REGISTRY.counter(FETCH_TOTAL, FETCH_HELP)
        self._affinity = REGISTRY.counter(ADAPTER_AFFINITY_TOTAL,
                                          ADAPTER_AFFINITY_HELP)

    # -- balancing ---------------------------------------------------------

    def pick(self, exclude: Tuple[str, ...] = (),
             tiers: Optional[Tuple[str, ...]] = None,
             adapter: Optional[Tuple[str, str]] = None) -> \
            Optional[EndpointState]:
        """Power-of-two-choices among routable endpoints not already
        tried this request: two uniform draws, lower load score wins
        (one candidate short-circuits; zero returns None).  ``tiers``
        restricts candidates to those disaggregation tiers (None =
        any — the single-tier path).  ``adapter`` = (model, name) for
        ``model@adapter`` requests: replicas whose last /readyz
        advertised the adapter resident are preferred — P2C runs INSIDE
        that subset, so affinity never overrides load balancing among
        warm replicas — and when none advertises it, the pick falls
        back to the full pool (the chosen replica hot-loads on
        admission)."""
        candidates = [s for s in self.registry.routable()
                      if s.name not in exclude
                      and (tiers is None
                           or getattr(s, "tier", "unified") in tiers)]
        if not candidates:
            return None
        if adapter is not None:
            model, name = adapter
            warm = [s for s in candidates
                    if s.has_adapter(model, name)]
            self._affinity.inc(outcome="hit" if warm else "miss")
            if warm:
                candidates = warm
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        return a if a.score() <= b.score() else b

    @staticmethod
    def _path_adapter(path: str) -> Optional[Tuple[str, str]]:
        """(model, adapter) from a ``/model/<base>@<adapter>:verb``
        path, or None for plain model names — the affinity key the
        pick() preference consumes."""
        if not path.startswith("/model/"):
            return None
        name = path[len("/model/"):].split(":", 1)[0]
        if "/" in name or "@" not in name:
            return None
        base, _, adapter = name.partition("@")
        return (base, adapter) if base and adapter else None

    def _tier_topology(self) -> bool:
        """True when the fleet has BOTH a routable prefill pool and a
        routable decode pool — the precondition for pipelining a
        :generate across tiers.  Anything less (mixed-version fleet,
        a whole tier down at dispatch time) keeps the single-tier
        path, so disaggregation is strictly additive."""
        tiers = {getattr(s, "tier", "unified")
                 for s in self.registry.routable()}
        return "prefill" in tiers and "decode" in tiers

    # -- request handling --------------------------------------------------

    def handle(self, method: str, path: str, body: bytes,
               headers: Dict[str, str]) -> Tuple[int, Dict[str, str],
                                                 bytes]:
        """Proxy one request; returns (status, headers, body).

        The response is whatever the chosen replica answered (verbatim,
        minus hop-by-hop headers) or a router-synthesized 429/502/503/
        504 when no replica could take the request."""
        t0 = time.perf_counter()
        span = self._root_span(method, path, headers)
        try:
            status, out_headers, out_body, outcome = self._route(
                method, path, body, headers, span)
        except BaseException:
            # A crashed route is exactly the trace tail sampling
            # promises to keep: end the root as an error (completing
            # the trace) before the handler's blanket 500 swallows it.
            span.end(status="error")
            raise
        self._requests.inc(outcome=outcome, code=str(status))
        self._latency.observe(time.perf_counter() - t0)
        # "recovered" (ok only after >= 1 replay) rides the error
        # retention tier: a failed-then-recovered request is exactly
        # the trace an incident review needs, even though the client
        # saw success.
        span.end(status=outcome, code=status)
        return status, out_headers, out_body

    # -- shared span sites (span names are unique per module) --------------

    def _root_span(self, method: str, path: str, headers):
        """Root (or continued) span of the distributed trace: each
        forward attempt becomes a child whose traceparent rides the
        proxied request, so the replica's server span joins THIS
        trace.  Tail sampling keeps every non-ok outcome."""
        return tracing.start_span(
            "router.request", parent=tracing.extract(headers),
            attrs={"method": method, "path": path})

    def _attempt_span(self, parent, state: EndpointState,
                      dead: Optional[str] = None,
                      resume_tokens: Optional[int] = None):
        """One upstream attempt: an ordinary forward, or — when
        ``dead`` names the replica whose mid-generation death this
        attempt recovers from — a replay annotated with the resume
        depth."""
        if dead is None:
            return tracing.start_span(
                "router.forward", parent=parent,
                attrs={"replica": state.name})
        return tracing.start_span(
            "router.replay", parent=parent,
            attrs={"replica": state.name, "dead": dead,
                   "resume_tokens": int(resume_tokens or 0)})

    # -- idempotency keys --------------------------------------------------

    @staticmethod
    def _replayable_path(method: str, path: str) -> bool:
        """Model POSTs are replay-safe under an idempotency key:
        predict is pure (the dedup cache de-duplicates same-replica
        retries; a cross-replica re-execution delivers at most one
        response to the client) and :generate failover is handled by
        the streaming path.  Any other POST keeps the never-replay
        502."""
        return method == "POST" and path.startswith("/model/") and (
            path.endswith(":predict") or path.endswith(":classify")
            or path.endswith(":generate"))

    def _idem_key(self, headers: Dict[str, str]):
        """(key, headers-with-key): the client's key when supplied
        (any case), else a freshly minted one — every attempt of one
        request forwards the SAME key, which is what lets a replica's
        dedup cache recognize a replay."""
        key = None
        for k, v in headers.items():
            if k.lower() == IDEMPOTENCY_HEADER:
                key = v
                break
        if key is None:
            key = uuid.uuid4().hex
        fwd = {k: v for k, v in headers.items()
               if k.lower() != IDEMPOTENCY_HEADER}
        fwd[IDEMPOTENCY_HEADER] = key
        return key, fwd

    def _route(self, method, path, body, headers,
               span=tracing.NULL_SPAN):
        self.budget.deposit()
        deadline, body = self._extract_deadline(method, path, body)
        replayable = self._replayable_path(method, path)
        if replayable:
            _, headers = self._idem_key(headers)
        tried: List[str] = []
        retry_after_hints: List[float] = []
        last_error = "no endpoints"
        idempotent = method == "GET"
        replays = 0
        dead: Optional[str] = None
        affinity = self._path_adapter(path)
        for _ in range(self.max_tries + self.max_replays):
            if deadline is not None \
                    and faults.monotonic() >= deadline:
                if replays:
                    self._replays.inc(outcome="failed")
                return 504, {}, _jerr("deadline expired in router"), \
                    "deadline_exceeded"
            state = self.pick(exclude=tuple(tried), adapter=affinity)
            if state is None:
                break
            tried.append(state.name)
            fwd_span = self._attempt_span(span, state, dead=dead)
            dead = None
            fwd_headers = headers
            if fwd_span:
                # The forward span's id becomes the replica's remote
                # parent — per ATTEMPT (replacing any client-supplied
                # header, whatever its case), so a retry's replica
                # spans hang under the attempt that carried them.
                fwd_headers = {
                    k: v for k, v in headers.items()
                    if k.lower() != tracing.TRACEPARENT}
                fwd_headers[tracing.TRACEPARENT] = \
                    fwd_span.traceparent()
            verdict = self._forward_once(state, method, path, body,
                                         fwd_headers, deadline)
            kind = verdict[0]
            if kind == "response":
                _, status, resp_headers, resp_body = verdict
                fwd_span.end(
                    status="shed" if status == 429 else
                    "upstream_error" if status >= 500 else "ok",
                    code=status)
                if status == 429:
                    hint = _parse_retry_after(resp_headers)
                    if hint is not None:
                        retry_after_hints.append(hint)
                    last_error = "overloaded"
                    if self._grant_retry("overloaded"):
                        continue
                    break
                outcome = "ok" if status < 500 else "upstream_error"
                if replays:
                    self._replays.inc(
                        outcome="ok" if status < 500 else "failed")
                    if status < 500:
                        outcome = "recovered"
                return status, resp_headers, resp_body, outcome
            # kind == "connect" (nothing sent) or "transport" (bytes
            # were sent: GETs and keyed model POSTs may be replayed;
            # anything else keeps the never-replay 502).
            last_error = verdict[1]
            fwd_span.end(status=kind, error=last_error)
            if kind == "connect" or (kind == "transport" and idempotent):
                if self._grant_retry(kind):
                    continue
                break
            if kind == "transport" and replayable:
                if replays >= self.max_replays:
                    self._replays.inc(outcome="cap_exceeded")
                    break
                if not self._grant_retry("replay"):
                    self._replays.inc(outcome="budget_exhausted")
                    break
                # Chaos hook: scripted replay-path failures (the
                # failover layer itself under test).
                faults.fire("router.replay")
                replays += 1
                dead = state.name
                continue
            break
        if replays:
            self._replays.inc(outcome="failed")
        if last_error == "overloaded":
            hint = min(retry_after_hints) if retry_after_hints else 1.0
            return 429, {"Retry-After": f"{max(1, round(hint))}"}, \
                _jerr("all replicas overloaded"), "shed"
        if last_error == "no endpoints":
            return 503, {}, _jerr("no routable replicas"), \
                "no_endpoints"
        return 502, {}, _jerr(f"upstream failed: {last_error}"), \
            "upstream_error"

    def _grant_retry(self, reason: str) -> bool:
        if not self.budget.withdraw():
            self._exhausted.inc()
            return False
        self._retries.inc(reason=reason)
        return True

    # -- streaming failover (the :generate proxy) --------------------------

    def handle_stream(self, path: str, body: bytes,
                      headers: Dict[str, str], sink) -> \
            Optional[Tuple[int, Dict[str, str], bytes]]:
        """Proxy one streaming :generate POST with mid-generation
        failover.  ``sink`` carries the client side: ``start()`` sends
        the 200 chunked header once, ``write_line(dict)`` one NDJSON
        line, and ``started`` says whether any byte left.  Returns a
        plain (status, headers, body) triple when the request failed
        BEFORE streaming began (the caller answers it like any routed
        response), else None — everything was written to the sink."""
        t0 = time.perf_counter()
        span = self._root_span("POST", path, headers)
        try:
            verdict, code, outcome = self._stream_route(
                path, body, headers, sink, span)
        except BaseException:
            span.end(status="error")
            raise
        self._requests.inc(outcome=outcome, code=str(code))
        self._latency.observe(time.perf_counter() - t0)
        span.end(status=outcome, code=code)
        return verdict

    def _stream_route(self, path, body, headers, sink, span):
        """Returns (plain_response_or_None, status_code, outcome)."""
        self.budget.deposit()
        deadline, body = self._extract_deadline("POST", path, body)
        _, headers = self._idem_key(headers)
        # Disaggregated topology: with BOTH tiers routable, pipeline
        # prefill-then-decode — the prefill pool computes the prompt's
        # KV pages, the payload rides the :generate body, and the
        # stream dispatches to the decode pool only.  Any prefill-leg
        # failure falls back to the untiered path (strictly additive).
        tiered = False
        if self._tier_topology():
            try:
                body, tiered = self._tiered_prefill(
                    path, body, headers, deadline, span)
            except faults.FaultInjected as e:
                log.warning("tier dispatch fault injected: %s", e)
        if not tiered:
            self._tier_requests.inc(tier="unified")
        tried: List[str] = []
        retry_after_hints: List[float] = []
        delivered: List[int] = []   # tokens forwarded to the client
        meta: Optional[Dict] = None  # first upstream meta line
        replays = 0
        dead: Optional[str] = None
        last_error = "no endpoints"
        affinity = self._path_adapter(path)

        def fail(status, message, outcome, extra_headers=None):
            """Terminal failure: a plain routed response while nothing
            has streamed, else a terminal error line — the status line
            is long gone and the NDJSON error line is the only honest
            signal left on an open stream."""
            if replays:
                self._replays.inc(outcome="failed")
            if sink.started:
                sink.write_line({"error": message, "code": status})
                return None, status, outcome
            return (status, extra_headers or {},
                    _jerr(message)), status, outcome

        for _ in range(self.max_tries + self.max_replays):
            if deadline is not None \
                    and faults.monotonic() >= deadline:
                return fail(504, "deadline expired in router",
                            "deadline_exceeded")
            state = self.pick(exclude=tuple(tried),
                              tiers=("decode",) if tiered else None,
                              adapter=affinity)
            if state is None:
                if tiered:
                    # The decode pool is exhausted (every decode
                    # replica tried, ejected, or down) while prefill
                    # capacity exists: that is OVERLOAD of one tier,
                    # not fleet death — shed typed 429 so the client
                    # retries into recovered capacity, never hangs on
                    # a half-finished handoff.
                    return fail(
                        429, "no routable decode-tier replicas",
                        "shed", extra_headers={"Retry-After": "1"})
                break
            tried.append(state.name)
            if tiered:
                self._tier_requests.inc(tier="decode")
            att_span = self._attempt_span(
                span, state, dead=dead,
                resume_tokens=len(delivered) if dead else None)
            dead = None
            fwd_headers = headers
            if att_span:
                fwd_headers = {
                    k: v for k, v in headers.items()
                    if k.lower() != tracing.TRACEPARENT}
                fwd_headers[tracing.TRACEPARENT] = \
                    att_span.traceparent()
            verdict = self._stream_attempt(
                state, path, body, fwd_headers, deadline, sink,
                delivered, meta)
            kind = verdict[0]
            if kind == "done":
                _, code = verdict
                att_span.end(status="ok" if code < 500 else
                             "upstream_error", code=code)
                outcome = "ok" if code < 500 else "upstream_error"
                if replays:
                    self._replays.inc(
                        outcome="ok" if code < 500 else "failed")
                    if code < 500:
                        outcome = "recovered"
                return None, code, outcome
            if kind == "response":
                # The replica answered a non-200 before any stream
                # began on THIS attempt: ordinary routed-response
                # semantics (429 retries on the budget).
                _, status, resp_headers, resp_body = verdict
                att_span.end(
                    status="shed" if status == 429 else
                    "upstream_error" if status >= 500 else "ok",
                    code=status)
                if status == 429:
                    hint = _parse_retry_after(resp_headers)
                    if hint is not None:
                        retry_after_hints.append(hint)
                    last_error = "overloaded"
                    if self._grant_retry("overloaded"):
                        continue
                    break
                if sink.started:
                    # A resume attempt was REFUSED (e.g. 400) after
                    # the client already holds a prefix: terminal
                    # error line.
                    return fail(status, "resume refused upstream",
                                "upstream_error")
                outcome = "ok" if status < 500 else "upstream_error"
                if replays:
                    self._replays.inc(
                        outcome="ok" if status < 500 else "failed")
                    if status < 500:
                        outcome = "recovered"
                return (status, resp_headers, resp_body), status, \
                    outcome
            if kind == "broken":
                # Transport death after bytes reached the replica; the
                # verdict carries the freshest meta (an attempt that
                # died before its meta line leaves the previous one
                # standing).
                _, detail, got_meta, streamed = verdict
                if got_meta is not None:
                    meta = got_meta
                last_error = detail
                att_span.end(status="transport", error=detail)
                if streamed:
                    # Proof of death, not weather: a replica whose 200
                    # stream broke mid-generation leaves rotation NOW
                    # (plus its pooled connections — all stale).
                    if state.force_eject():
                        self._pool.close_endpoint(state.endpoint.url)
                # Nothing delivered yet => a fresh attempt is always
                # safe (the client holds no prefix to contradict).
                # With tokens delivered, only a deterministic stream
                # may continue: greedy (resume payload) or an
                # explicitly seeded sample (from-scratch skip-splice).
                # Unseeded sampling keeps the documented 502.
                can_failover = (
                    not delivered
                    or bool(meta and meta.get("resumable"))
                    or bool(meta and meta.get("seeded")))
                if not can_failover:
                    self._replays.inc(outcome="not_replayable")
                    return fail(502,
                                f"upstream died mid-generation, not "
                                f"replayable: {detail}",
                                "upstream_error")
                if replays >= self.max_replays:
                    self._replays.inc(outcome="cap_exceeded")
                    break
                if not self._grant_retry("replay"):
                    self._replays.inc(outcome="budget_exhausted")
                    break
                # Chaos hook: the replay/failover decision point.
                faults.fire("router.replay")
                replays += 1
                dead = state.name
                if delivered:
                    self._resume_hist.observe(float(len(delivered)))
                if meta and meta.get("resumable"):
                    # Resume-by-fetch: before the recompute
                    # resume, ask surviving peers for the session's
                    # spilled/parked KV pages; on a hit the payload
                    # rides the replay body and the survivor imports
                    # instead of re-prefilling.  Any failure leaves
                    # the body untouched — recompute-resume is always
                    # correct, fetch only makes it cheap.
                    body = self._fetch_resume(
                        path, body, delivered, headers, deadline,
                        span, tiered)
                continue
            # kind == "connect": nothing was sent — an ordinary retry.
            last_error = verdict[1]
            att_span.end(status="connect", error=last_error)
            if self._grant_retry("connect"):
                continue
            break
        if last_error == "overloaded":
            hint = min(retry_after_hints) if retry_after_hints else 1.0
            return fail(
                429, "all replicas overloaded", "shed",
                extra_headers={"Retry-After": f"{max(1, round(hint))}"})
        if last_error == "no endpoints":
            return fail(503, "no routable replicas", "no_endpoints")
        return fail(502, f"upstream failed: {last_error}",
                    "upstream_error")

    def _tiered_prefill(self, path, body, headers, deadline, parent):
        """The prefill leg of a tiered :generate: POST the prompt to
        one prefill-tier replica's :prefill route and fold the
        answered ``kv_handoff`` payload (a wire-encoded block-page
        list — the router never decodes it) into the :generate body.
        Returns (body, True) on success; ANY failure — no prefill
        replica, transport death, non-200, a prompt too short to
        cover one page — returns the original body with False and the
        caller runs the untiered path.  One attempt by design: the
        fallback is always correct, so the prefill leg never burns
        the retry budget the decode stream may need."""
        # Chaos hook: the tier-routing decision point (raise = tiered
        # dispatch failure — the :generate must fall back to the
        # untiered path, never hang or 500).
        faults.fire("router.tier_dispatch")
        state = self.pick(tiers=("prefill",),
                          adapter=self._path_adapter(path))
        if state is None:
            return body, False
        self._tier_requests.inc(tier="prefill")
        span = tracing.start_span(
            "router.prefill", parent=parent,
            attrs={"replica": state.name})
        fwd_headers = headers
        if span:
            fwd_headers = {
                k: v for k, v in headers.items()
                if k.lower() != tracing.TRACEPARENT}
            fwd_headers[tracing.TRACEPARENT] = span.traceparent()
        prefill_path = path[:-len(":generate")] + ":prefill"
        verdict = self._forward_once(state, "POST", prefill_path,
                                     body, fwd_headers, deadline)
        if verdict[0] != "response":
            span.end(status=verdict[0], error=verdict[1])
            return body, False
        _, status, _, payload = verdict
        if status != 200:
            span.end(status="upstream_error" if status >= 500
                     else "ok", code=status)
            return body, False
        reply = _json_obj(payload)
        handoff = reply.get("kv_handoff") if reply else None
        request = _json_obj(body) if handoff else None
        if not isinstance(handoff, dict) or request is None:
            span.end(status="ok", code=status)
            return body, False
        request["kv_handoff"] = handoff
        span.end(status="ok", code=status,
                 tokens_covered=int(handoff.get("tokens_covered", 0)))
        return json.dumps(request).encode(), True

    def _stream_attempt(self, state: EndpointState, path, body,
                        headers, deadline, sink, delivered, meta):
        """One upstream streaming attempt.  Verdicts:
        ("done", code) — terminal line forwarded, stream complete;
        ("response", status, headers, body) — non-200 answer;
        ("connect", detail) — nothing sent;
        ("broken", detail, meta_or_None, streamed) — transport death
        after bytes reached the replica; ``meta`` is the upstream meta
        line if this attempt got that far (the caller's failover
        decision input) and ``streamed`` says whether the 200 stream
        had begun (a true mid-generation death, force-eject material).

        Forwards token lines to ``sink`` AS RECEIVED, extending
        ``delivered`` in place: on a resume the upstream emits only
        the suffix; on a seeded from-scratch replay the upstream
        re-emits everything and the first len(delivered) tokens are
        SKIPPED (same seed => same stream), so the client never sees
        a duplicate or a gap either way."""
        send_body = body
        mode = "fresh"
        if delivered:
            if meta and meta.get("resumable"):
                mode = "resume"
                send_body = self._rewrite_resume(body, delivered)
            else:
                mode = "replay"  # seeded: re-run and skip the prefix
        timeout = self.try_timeout_s
        if deadline is not None:
            remaining = deadline - faults.monotonic()
            if remaining <= 0:
                return "connect", "deadline expired"
            timeout = min(timeout, remaining)
            send_body = _rewrite_deadline(send_body, remaining)
        url = state.endpoint.url
        conn = self._pool.get(url)
        if conn is None:
            parsed = urllib.parse.urlsplit(url)
            conn = http.client.HTTPConnection(
                parsed.hostname, parsed.port, timeout=timeout)
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        fwd_headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_HEADERS}
        state.enter()
        got_meta = None
        streamed = False
        try:
            faults.fire("router.forward")
            conn.request("POST", path, body=send_body or None,
                         headers=fwd_headers)
            resp = conn.getresponse()
            if resp.status != 200:
                payload = resp.read()
                resp_headers = _copy_headers(resp.headers)
                if resp.will_close:
                    conn.close()
                else:
                    self._pool.put(url, conn)
                if resp.status >= 500:
                    self._note_failure(state)
                else:
                    state.note_success()
                return ("response", resp.status, resp_headers, payload)
            streamed = True
            skip = len(delivered) if mode == "replay" else 0
            while True:
                line = resp.readline()
                if not line:
                    raise http.client.IncompleteRead(b"")
                line = line.strip()
                if not line:
                    continue
                msg = json.loads(line)
                if "meta" in msg:
                    got_meta = msg["meta"]
                    if not sink.started:
                        sink.start()
                        sink.write_line(msg)
                    continue
                if "tokens" in msg:
                    toks = [int(t) for t in msg["tokens"]]
                    if skip:
                        drop = min(skip, len(toks))
                        toks = toks[drop:]
                        skip -= drop
                    if toks:
                        delivered.extend(toks)
                        sink.write_line({"tokens": toks})
                    continue
                if "done" in msg:
                    state.note_success()
                    sink.write_line({"done": True,
                                     "tokens_emitted": len(delivered)})
                    resp.read()  # drain to EOF so the conn can pool
                    self._pool.put(url, conn)
                    return ("done", 200)
                if "error" in msg:
                    # A replica-side terminal verdict (e.g. deadline
                    # expiry mid-generation) is an ANSWER, not a
                    # death: forward it and finish.
                    code = int(msg.get("code", 500))
                    state.note_success()
                    if not sink.started:
                        sink.start()
                    sink.write_line(msg)
                    resp.read()
                    self._pool.put(url, conn)
                    return ("done", code)
        except (ConnectionRefusedError, faults.FaultInjected) as e:
            conn.close()
            self._note_failure(state)
            if streamed:
                return ("broken", f"{state.name}: {e}",
                        got_meta or meta, True)
            return ("connect", f"{state.name}: {e}")
        except (http.client.HTTPException, ConnectionError,
                TimeoutError, OSError, ValueError) as e:
            # Bytes reached the replica (request sent), so every
            # failure here is the "died mid-request" class the
            # failover loop arbitrates; ValueError covers a torn JSON
            # line from a mid-write crash — same failure, later byte.
            conn.close()
            self._note_failure(state)
            detail = f"{state.name}: {type(e).__name__}: {e}"
            return ("broken", detail, got_meta or meta, streamed)
        finally:
            state.exit()

    @staticmethod
    def _rewrite_resume(body: bytes, delivered: List[int]) -> bytes:
        """Resume payload: prompt + tokens the client already holds.
        The engine re-admits the union as one chunked prefill (cached
        blocks alias for free) and emits only the suffix."""
        try:
            payload = json.loads(body)
        except ValueError:
            return body
        if not isinstance(payload, dict):
            return body
        payload["resume_tokens"] = list(delivered)
        return json.dumps(payload).encode()

    def _fetch_resume(self, path, body, delivered, headers, deadline,
                      parent, tiered):
        """The fetch leg of resume-by-fetch: POST the full
        context (prompt + delivered tokens) to up to two surviving
        peers' :fetch_kv route and fold the first non-null
        ``kv_handoff`` into the :generate body — _rewrite_resume's
        json round-trip carries it to the survivor, whose engine
        imports the pages and chunk-prefills only the uncovered
        suffix.  Returns the (possibly rewritten) body; ANY failure
        returns it untouched and the replay recomputes.  Never burns
        the retry budget: like the prefill leg, the fallback is
        always correct."""
        request = _json_obj(body)
        if request is None or request.get("kv_handoff") is not None:
            return body
        context = list(request.get("tokens") or []) + list(delivered)
        if not context:
            return body
        fetch_path = path[:-len(":generate")] + ":fetch_kv"
        fetch_body = json.dumps({"tokens": context}).encode()
        asked = failed = 0
        tried: List[str] = []
        tiers = ("decode",) if tiered else None
        while asked < 2:
            state = self.pick(exclude=tuple(tried), tiers=tiers)
            if state is None:
                break
            tried.append(state.name)
            asked += 1
            span = tracing.start_span(
                "router.fetch_kv", parent=parent,
                attrs={"replica": state.name})
            verdict = self._forward_once(state, "POST", fetch_path,
                                         fetch_body, headers, deadline)
            if verdict[0] != "response" or verdict[1] != 200:
                failed += 1
                span.end(status="transport" if verdict[0] != "response"
                         else "upstream_error",
                         error=str(verdict[1]))
                continue
            reply = _json_obj(verdict[3])
            handoff = reply.get("kv_handoff") if reply else None
            if not isinstance(handoff, dict):
                span.end(status="ok", code=200)
                continue
            span.end(status="ok", code=200,
                     tokens_covered=int(
                         handoff.get("tokens_covered", 0)))
            self._fetches.inc(outcome="ok")
            request["kv_handoff"] = handoff
            return json.dumps(request).encode()
        if not asked:
            self._fetches.inc(outcome="none")
        elif failed == asked:
            self._fetches.inc(outcome="error")
        else:
            self._fetches.inc(outcome="miss")
        return body

    def _forward_once(self, state: EndpointState, method, path, body,
                      headers, deadline):
        """One attempt against one replica over a pooled keep-alive
        connection.  Returns a verdict tuple: ("response", status,
        headers, body) when the replica answered, ("connect", detail)
        when the request provably never executed (retry-safe for any
        method), or ("transport", detail) when bytes may have been
        processed (failure semantics: non-idempotent work must not be
        replayed).

        A reused keep-alive connection that dies before any response
        bytes is classified "transport", NOT "connect": RFC 7230
        §6.3.1 would permit treating it as a close race, but the same
        signature is produced by a replica crashing MID-GENERATION on
        our request, and the never-replay guarantee for non-idempotent
        work is absolute — so only GETs (which _route retries on any
        transport failure) benefit from the ambiguity."""
        send_body = body
        timeout = self.try_timeout_s
        if deadline is not None:
            remaining = deadline - faults.monotonic()
            if remaining <= 0:
                return "connect", "deadline expired"
            timeout = min(timeout, remaining)
            if method == "POST" and body:
                send_body = _rewrite_deadline(body, remaining)
        url = state.endpoint.url
        conn = self._pool.get(url)
        reused = conn is not None
        if conn is None:
            parsed = urllib.parse.urlsplit(url)
            conn = http.client.HTTPConnection(
                parsed.hostname, parsed.port, timeout=timeout)
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        fwd_headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_HEADERS}
        state.enter()
        try:
            # Chaos hook: scripted connection failures land before the
            # socket, exactly like kube.request's.
            faults.fire("router.forward")
            conn.request(method, path, body=send_body or None,
                         headers=fwd_headers)
            resp = conn.getresponse()
            payload = resp.read()
            resp_headers = _copy_headers(resp.headers)
            if resp.will_close:
                conn.close()
            else:
                self._pool.put(url, conn)
            # An HTTP status is an ANSWER — the replica is alive.  429
            # is a healthy replica protecting itself; 5xx counts
            # against the breaker (the replica is failing requests).
            if resp.status >= 500:
                self._note_failure(state)
            else:
                state.note_success()
            return "response", resp.status, resp_headers, payload
        except (ConnectionRefusedError, faults.FaultInjected) as e:
            conn.close()
            self._note_failure(state)
            return "connect", f"{state.name}: {e}"
        except (http.client.RemoteDisconnected, ConnectionResetError,
                BrokenPipeError) as e:
            conn.close()
            self._note_failure(state)
            detail = "reused conn" if reused else "fresh conn"
            return "transport", \
                f"{state.name} ({detail}): {type(e).__name__}: {e}"
        except (http.client.HTTPException, ConnectionError,
                TimeoutError, OSError) as e:
            conn.close()
            self._note_failure(state)
            return "transport", f"{state.name}: {e}"
        finally:
            state.exit()

    def _note_failure(self, state: EndpointState) -> None:
        if state.note_failure():
            # Ejected: every pooled connection predates the failure
            # streak and is guaranteed stale.
            self._pool.close_endpoint(state.endpoint.url)

    def close(self) -> None:
        self._pool.close()

    @staticmethod
    def _extract_deadline(method, path, body):
        """Pull ``deadline_ms`` out of a predict/classify POST body and
        convert to an absolute policy-clock instant.  Returns
        (deadline_or_None, body) — the body is returned untouched (the
        per-attempt rewrite happens at forward time with the budget
        remaining THEN)."""
        if method != "POST" or not body or b"deadline_ms" not in body:
            return None, body
        try:
            deadline_ms = json.loads(body).get("deadline_ms")
            deadline_ms = float(deadline_ms)
        except (ValueError, TypeError):
            return None, body
        if deadline_ms <= 0:
            return None, body
        return faults.monotonic() + deadline_ms / 1e3, body

    # -- router health -----------------------------------------------------

    def begin_drain(self) -> None:
        self._draining.set()

    def is_ready(self) -> bool:
        return not self._draining.is_set() \
            and bool(self.registry.routable())

    def draining(self) -> bool:
        return self._draining.is_set()


def _jerr(message: str) -> bytes:
    return json.dumps({"error": message}).encode()


def _json_obj(data: bytes):
    """Parse a JSON object, or None (malformed / not an object) —
    the tiered-prefill leg's tolerant decode: junk means 'fall back
    to the untiered path', never an exception."""
    try:
        obj = json.loads(data)
    except (ValueError, TypeError):
        return None
    return obj if isinstance(obj, dict) else None


def _copy_headers(headers) -> Dict[str, str]:
    out = {}
    for key in ("Content-Type", "Retry-After"):
        value = headers.get(key)
        if value is not None:
            out[key] = value
    return out


def _parse_retry_after(headers: Dict[str, str]) -> Optional[float]:
    try:
        return float(headers.get("Retry-After", ""))
    except (TypeError, ValueError):
        return None


def _rewrite_deadline(body: bytes, remaining_s: float) -> bytes:
    """Propagate the REMAINING budget to the replica: a retried request
    must not restart its deadline from scratch, and the replica's own
    queue sweep needs the true time left."""
    try:
        payload = json.loads(body)
    except ValueError:
        return body
    if not isinstance(payload, dict):
        return body
    payload["deadline_ms"] = max(1.0, remaining_s * 1e3)
    return json.dumps(payload).encode()


class StreamSink:
    """The client side of a proxied :generate stream: chunked NDJSON
    over the handler's socket.  ``start()`` is idempotent and lazy —
    the router delays the 200 until the upstream proved it can stream,
    so pre-stream failures still answer ordinary status codes."""

    def __init__(self, handler):
        self._h = handler
        self.started = False

    def start(self) -> None:
        if self.started:
            return
        self._h.send_response(200)
        self._h.send_header("Content-Type", "application/x-ndjson")
        self._h.send_header("Transfer-Encoding", "chunked")
        self._h.end_headers()
        self.started = True

    def write_line(self, payload: Dict) -> None:
        self.start()
        data = json.dumps(payload).encode() + b"\n"
        self._h.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self._h.wfile.flush()

    def finish(self) -> None:
        if self.started:
            self._h.wfile.write(b"0\r\n\r\n")
            self._h.wfile.flush()


class _Handler(BaseHTTPRequestHandler):
    router: FleetRouter  # bound by make_router_server

    # Client-side keep-alive (every response carries Content-Length);
    # the upstream side pools its own persistent connections.
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("router: " + fmt, *args)

    def _respond(self, status: int, headers: Dict[str, str],
                 body: bytes) -> None:
        self.send_response(status)
        if "Content-Type" not in headers:
            headers = dict(headers, **{
                "Content-Type": "application/json"})
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _drain_body(self) -> None:
        """Read and discard an un-proxied request's body: with
        keep-alive an unread body desyncs the client connection."""
        length = int(self.headers.get("Content-Length", 0))
        if length:
            self.rfile.read(length)

    def _dispatch(self, method: str) -> None:
        router = self.router
        if self.path in ("/healthz", "/readyz", "/metrics",
                         "/fleet/endpoints", "/debug/traces"):
            self._drain_body()
        if self.path == "/healthz":
            self._respond(200, {}, json.dumps(
                {"status": "ok", "role": "router"}).encode())
            return
        if self.path == "/readyz":
            if router.is_ready():
                self._respond(200, {}, json.dumps(
                    {"status": "ready",
                     "replicas": len(router.registry.routable())}
                ).encode())
            else:
                self._respond(503, {}, json.dumps(
                    {"status": "draining" if router.draining()
                     else "no routable replicas"}).encode())
            return
        if self.path == "/metrics":
            data = REGISTRY.render().encode()
            self._respond(200, {"Content-Type":
                                "text/plain; version=0.0.4"}, data)
            return
        if self.path == "/fleet/endpoints":
            # Endpoint table plus the router-wide failover budget —
            # the `kubeflow-tpu fleet status` payload.
            payload = {
                "endpoints": router.registry.describe(),
                "retry_budget": router.budget.snapshot(),
                "max_replays": router.max_replays,
            }
            if router.pool_status is not None:
                try:
                    pool = router.pool_status()
                except Exception:
                    pool = None
                if pool:
                    payload["pool"] = pool
            self._respond(200, {}, json.dumps(payload).encode())
            return
        if self.path == "/debug/traces":
            # Tail-sampled request traces (router root + forward
            # spans; replica spans too when the store is shared, as in
            # the hermetic e2e).  Served on the router port so one
            # scrape target covers health, metrics, and traces.
            self._respond(200, {}, json.dumps(
                tracing.snapshot()).encode())
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        if method == "POST" and self.path.endswith(":generate") \
                and self.path.startswith("/model/"):
            # Streaming generate: the router splices upstream streams
            # across mid-generation failover; the sink writes chunked
            # NDJSON to THIS connection as lines arrive.
            sink = StreamSink(self)
            try:
                plain = router.handle_stream(
                    self.path, body, dict(self.headers.items()), sink)
            except ConnectionError:
                return  # the client went away; nothing left to say
            except Exception as e:  # noqa: BLE001 — proxy must not die
                log.exception("router stream handler error")
                if sink.started:
                    sink.finish()
                    return
                plain = (500, {}, _jerr(f"{type(e).__name__}: {e}"))
            if plain is not None:
                self._respond(*plain)
            else:
                sink.finish()
            return
        try:
            status, headers, payload = router.handle(
                method, self.path, body, dict(self.headers.items()))
        except Exception as e:  # noqa: BLE001 — the proxy must not die
            log.exception("router handler error")
            status, headers, payload = 500, {}, _jerr(
                f"{type(e).__name__}: {e}")
        self._respond(status, headers, payload)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_router_server(
    router: FleetRouter, port: int = 8080, host: str = "0.0.0.0",
) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the router's HTTP front on a daemon thread; returns
    (httpd, thread)."""
    handler = type("BoundRouterHandler", (_Handler,),
                   {"router": router})
    httpd = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="fleet-router-http")
    thread.start()
    return httpd, thread
