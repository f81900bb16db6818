"""Model server core: the port of kubeflow_tpu/serving/model_server.py.

``ModelServer`` watches a model base path for numbered versions, serves
the latest, hot-swaps when a new version lands, and caps in-flight
requests per model.  ``MicroBatcher`` coalesces concurrent single-row
requests into padded device batches; ``BucketedLMBatcher`` lets
mixed-length LM prompts share one batch by left-padding at dispatch to
the smallest bucket covering the longest member.

The continuous-batching DecodeEngine (serving/engine.py) plugs in as a
batcher; ``SHED_TOTAL``/``EXPIRED_TOTAL`` and ``locked_snapshot`` are the
names it shares with the batchers.  Through it the server also runs the
disaggregated prefill tier (``prefill_handoff``), streams generation
(``generate_stream``) and serves the engine's host spill tier to peers
(``fetch_kv``); ``role`` advertises the server's tier.  A request name
``model@adapter`` serves the adapter ``adapter`` of ``model`` through
the model's engine (serving/adapters.py); a model without an engine
refuses it with ``AdapterNotFound`` (a 404), never decoding base
weights for a tenant.

``reload`` runs under a per-model ``_ReloadBreaker`` (the adapter
registry's loads use one too): a failed load opens it for a jittered,
doubling backoff on the policy clock, and the last good version keeps
serving.  ``predict(..., idem_key=)`` dedups retried requests through
``_DedupCache``.  Under a trace context set by the transport, admission
stamps a ``server.admission`` span and the MicroBatcher
``batcher.queue_wait`` and ``batcher.dispatch`` spans;
``refresh_gauges`` pushes the load gauges the ``/metrics`` scrape reads.
Deadlines, backoffs and batch aging read ``faults.monotonic()``, the
skewable policy clock, as the JAX package's do; ``loader.load`` and
``batcher.dispatch`` are fault sites.  Metric names and label sets are
the JAX package's.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.serving.adapters import (
    AdapterNotFound,
    split_model_adapter,
)
from kubeflow_tpu_torch.serving.errors import (  # noqa: F401 -- re-exported
    BatcherClosed,
    DeadlineExceeded,
    Overloaded,
)
from kubeflow_tpu_torch.serving.export import list_versions, load_version
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

# The request counter and latency histogram the REST face writes.
REQUESTS_TOTAL = "kft_serving_requests_total"
REQUESTS_HELP = "serving requests by model/route/outcome (REST + gRPC)"
LATENCY_SECONDS = "kft_serving_request_seconds"
LATENCY_HELP = "serving request latency by route (REST + gRPC)"
# Fault-layer series shared by every batching plane (MicroBatcher,
# BucketedLMBatcher, DecodeEngine), one series per batcher label.
SHED_TOTAL = "kft_serving_shed_total"
SHED_HELP = "admissions refused at the queue/in-flight caps, by batcher"
EXPIRED_TOTAL = "kft_serving_deadline_expired_total"
EXPIRED_HELP = "requests failed by their deadline, by batcher"
RELOAD_FAILURES_TOTAL = "kft_serving_reload_failures_total"
RELOAD_FAILURES_HELP = "model (re)load attempts that raised, by model"
BREAKER_OPEN = "kft_serving_reload_breaker_open"
BREAKER_OPEN_HELP = "1 while a model's reload circuit breaker is open"
# Scrape-refreshed load gauges (refresh_gauges).
INFLIGHT_GAUGE = "kft_serving_inflight"
INFLIGHT_HELP = ("requests in flight (transport + predict); unlabeled "
                 "= process total, model= per-model predict calls")
QUEUE_GAUGE = "kft_serving_queue_depth"
QUEUE_HELP = "pending entries in a model's batching plane, by model"
READY_GAUGE = "kft_serving_ready"
READY_HELP = "1 when /readyz would say ready (models loaded, not draining)"
CACHED_RATIO_GAUGE = "kft_serving_cached_token_ratio"
CACHED_RATIO_HELP = ("fraction of prompt tokens served from the engine "
                     "prefix cache; unlabeled = process aggregate, "
                     "model= per-model")
SPILL_RATIO_GAUGE = "kft_serving_kv_spill_ratio"
SPILL_RATIO_HELP = ("host spill-tier occupancy / host_spill_blocks "
                    "(0 when the tier is disabled), by model; "
                    "unlabeled = process aggregate")
DEDUP_HITS_TOTAL = "kft_serving_dedup_hits_total"
DEDUP_HITS_HELP = ("requests answered from the idempotency dedup "
                   "cache (completed result or in-flight attach), "
                   "by model")


def locked_snapshot(lock, data: Dict[str, Any],
                    extra: Optional[Callable[[], Dict[str, Any]]] = None):
    """Copy mutable stats counters under their owning lock: returns
    (dict(data), extra() or {}) taken atomically, so a stats read never
    sees a half-updated cycle."""
    with lock:
        return dict(data), (extra() if extra is not None else {})


@dataclasses.dataclass
class LoadedModel:
    name: str
    version: int
    predict: Callable[[Dict[str, Any]], Dict[str, Any]]
    meta: Dict[str, Any]


class _ReloadBreaker:
    """Exponential-backoff circuit breaker for one model's (re)loads.

    A corrupt checkpoint directory must not hot-loop the version
    watcher: after a load failure the breaker OPENS for a jittered,
    exponentially-growing backoff during which reload() skips the disk
    entirely (the last-good version keeps serving).  When the backoff
    expires the breaker goes HALF-OPEN: exactly one trial load runs;
    success closes it, failure re-opens with a doubled backoff.  A NEW
    latest version (different from the one that failed) resets the
    breaker immediately — the breaker guards the corrupt artifact, not
    the model name.

    The backoff clock is faults.monotonic() (the skewable policy
    clock), so chaos tests drive the open -> half-open -> closed walk
    without wall-clock sleeps."""

    def __init__(self, base_s: float = 0.5, cap_s: float = 60.0,
                 rng: Optional[random.Random] = None):
        self._base_s = base_s
        self._cap_s = cap_s
        # OS-seeded by default: each replica must walk a DIFFERENT
        # jitter sequence or concurrent replicas watching one shared
        # model path retry in lockstep.  Tests needing a fixed walk
        # pass their own rng.
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.failures = 0
        self.open_until = 0.0
        self.failing_version: Optional[int] = None
        self._half_open = False

    def allow(self, version: int) -> bool:
        """May a load of ``version`` run now?  Claims the single
        half-open trial slot when the backoff has expired."""
        with self._lock:
            if self.failures == 0:
                return True
            if version != self.failing_version:
                self._reset_locked()
                return True
            if self._half_open:
                return False  # a trial is already in flight
            if faults.monotonic() < self.open_until:
                return False
            self._half_open = True
            return True

    def record_failure(self, version: int) -> None:
        with self._lock:
            self.failures += 1
            self.failing_version = version
            self._half_open = False
            backoff = min(self._cap_s,
                          self._base_s * (2 ** (self.failures - 1)))
            # Full jitter up to +25%: concurrent replicas watching one
            # shared model path must not retry in lockstep.
            backoff *= 1.0 + 0.25 * self._rng.random()
            self.open_until = faults.monotonic() + backoff

    def record_success(self) -> None:
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self.failures = 0
        self.open_until = 0.0
        self.failing_version = None
        self._half_open = False

    @property
    def open(self) -> bool:
        with self._lock:
            return self.failures > 0


class _DedupCache:
    """Bounded, TTL'd idempotency-key -> result cache.

    One entry per key: the FIRST request to present a key becomes the
    primary and executes; concurrent duplicates attach to its entry
    and wait on its event; later duplicates of a COMPLETED key are
    answered from the cached result — so a connection that dies after
    the replica finished no longer forces a client-visible failure or
    a double execution when the request is retried with the same key.

    Failures are never cached: ``fail`` resolves attached waiters with
    the error and drops the entry, so a later retry re-executes (a
    transient Overloaded must not be replayed from cache for the TTL).
    Completed entries expire after ``ttl_s`` on the skewable policy
    clock and are LRU-bounded at ``capacity``; in-flight entries are
    pinned (waiters hold references) and never evicted."""

    def __init__(self, capacity: int = 1024, ttl_s: float = 120.0):
        self.capacity = max(1, int(capacity))
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def begin(self, key: str) -> Tuple[str, dict]:
        """Claim or join ``key``: ("new", entry) makes the caller the
        primary (it MUST finish/fail the entry), ("inflight", entry)
        attaches to a live execution, ("done", entry) hands back the
        cached result."""
        with self._lock:
            self._sweep_locked()
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                verdict = "done" if entry["event"].is_set() \
                    else "inflight"
                return verdict, entry
            entry = {"event": threading.Event(), "result": None,
                     "err": None, "done_at": None}
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                victim = next(
                    (k for k, e in self._entries.items()
                     if e["event"].is_set()), None)
                if victim is None:
                    break  # everything in flight: pinned
                del self._entries[victim]
            return "new", entry

    def finish(self, key: str, entry: dict, result: Any) -> None:
        with self._lock:
            entry["result"] = result
            entry["done_at"] = faults.monotonic()
        entry["event"].set()

    def fail(self, key: str, entry: dict, exc: BaseException) -> None:
        with self._lock:
            entry["err"] = exc
            if self._entries.get(key) is entry:
                del self._entries[key]
        entry["event"].set()

    def _sweep_locked(self) -> None:
        if self.ttl_s <= 0:
            return
        now = faults.monotonic()
        stale = [k for k, e in self._entries.items()
                 if e["done_at"] is not None
                 and now - e["done_at"] > self.ttl_s]
        for k in stale:
            del self._entries[k]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ModelServer:
    """Serves N named models, each from a versioned base path, on one
    device (``device=None`` means CUDA; see kubeflow_tpu_torch.device).

    ``role`` is the disaggregated-serving tier this server advertises on
    /readyz: "prefill" servers answer :prefill with KV handoff pages,
    "decode" servers import them and stream, "unified" (the default)
    serves the single-tier path.  It is an advertisement, not a gate:
    every server answers every route."""

    def __init__(self, poll_interval_s: float = 2.0,
                 reload_backoff_s: float = 0.5,
                 reload_backoff_cap_s: float = 60.0,
                 max_inflight: int = 0,
                 overload_retry_after_s: float = 1.0,
                 dedup_capacity: int = 1024,
                 dedup_ttl_s: float = 120.0,
                 device: DeviceLike = None, role: str = "unified"):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be unified/prefill/decode, got {role!r}")
        self.role = role
        self.device = resolve_device(device)
        self._models: Dict[str, Dict[int, LoadedModel]] = {}
        self._base_paths: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._poll_interval_s = poll_interval_s
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._batcher_factories: Dict[str, Callable] = {}
        self._batchers: Dict[str, Any] = {}
        # Reload circuit breakers, one per model (see _ReloadBreaker).
        self._reload_backoff_s = reload_backoff_s
        self._reload_backoff_cap_s = reload_backoff_cap_s
        self._breakers: Dict[str, _ReloadBreaker] = {}
        self._draining = threading.Event()
        self._inflight = 0
        # Per-model cap over every path, the direct one included (it has
        # no batcher queue to bound it).  0 = unbounded.
        self._max_inflight = max(0, int(max_inflight))
        self._overload_retry_after_s = overload_retry_after_s
        self._inflight_by_model: Dict[str, int] = {}
        # Idempotency-key result dedup: the REST face passes the
        # x-kft-idempotency-key header through to predict().
        self._dedup = _DedupCache(dedup_capacity, dedup_ttl_s)

    # -- loading ----------------------------------------------------------

    def add_model(self, name: str, base_path: str) -> None:
        with self._lock:
            self._base_paths[name] = base_path
            self._models.setdefault(name, {})
        self.reload(name)

    def reload(self, name: str) -> bool:
        """Scan the base path; load a new latest version and drop stale
        ones.  Returns True if the served version changed.

        A load failure raises to the caller AND trips the model's circuit
        breaker: until its jittered exponential backoff expires, further
        reload() calls of the same version return False without touching
        the loader, so the version watcher cannot hot-loop on a bad
        artifact while the last good version keeps serving."""
        base = self._base_paths[name]
        versions = list_versions(base)
        if not versions:
            log.warning("no versions for model %r under %s", name, base)
            return False
        latest = versions[-1]
        with self._lock:
            if latest in self._models[name]:
                return False
            breaker = self._breakers.get(name)
            if breaker is None:
                breaker = self._breakers[name] = _ReloadBreaker(
                    self._reload_backoff_s, self._reload_backoff_cap_s)
        if not breaker.allow(latest):
            return False
        try:
            faults.fire("loader.load")
            predict, meta = load_version(base, latest, device=self.device)
        except Exception:
            breaker.record_failure(latest)
            REGISTRY.counter(
                RELOAD_FAILURES_TOTAL, RELOAD_FAILURES_HELP).inc(
                    model=name)
            REGISTRY.gauge(BREAKER_OPEN, BREAKER_OPEN_HELP).set(
                1, model=name)
            log.warning(
                "load of %r v%d failed; breaker open until +%.1fs "
                "(failure #%d), last-good version keeps serving",
                name, latest,
                max(0.0, breaker.open_until - faults.monotonic()),
                breaker.failures)
            raise
        breaker.record_success()
        REGISTRY.gauge(BREAKER_OPEN, BREAKER_OPEN_HELP).set(0, model=name)
        with self._lock:
            model = LoadedModel(name=name, version=latest, predict=predict,
                                meta=meta)
            self._models[name][latest] = model
            # Keep only the latest (TF-Serving's default version policy).
            for v in [v for v in self._models[name] if v != latest]:
                del self._models[name][v]
            old_batcher = self._batchers.pop(name, None)
            factory = self._batcher_factories.get(name)
        self._swap_batcher(name, factory, model, old_batcher)
        log.info("model %r now serving version %d", name, latest)
        return True

    def _swap_batcher(self, name, factory, model, old_batcher) -> None:
        """Close the old batcher, then build and install the new one
        (outside the server lock: close blocks on in-flight requests).
        Requests landing in the gap take the direct predict path; a
        factory that returns None disables batching for the model."""
        if old_batcher is not None:
            old_batcher.close()
        if factory is None or model is None:
            return
        batcher = factory(model)
        if batcher is not None:
            with self._lock:
                displaced = self._batchers.get(name)
                self._batchers[name] = batcher
            if displaced is not None and displaced is not batcher:
                displaced.close()  # lost a swap race; don't leak it

    def start_watcher(self) -> None:
        """Background version polling: the hot-swap path."""
        if self._watcher is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self._poll_interval_s):
                for name in list(self._base_paths):
                    try:
                        self.reload(name)
                    except Exception:  # noqa: BLE001 -- watcher must live
                        log.exception("reload of %r failed", name)

        self._watcher = threading.Thread(target=run, daemon=True,
                                         name="version-watcher")
        self._watcher.start()

    def enable_batching(self, name: str,
                        factory: Callable[[LoadedModel], Any]) -> None:
        """Coalesce concurrent predict() calls for ``name`` through a
        batcher built by ``factory(loaded_model)``, rebuilt around every
        newly-loaded version.  Explicit-version requests bypass it."""
        with self._lock:
            self._batcher_factories[name] = factory
            model = None
            versions = self._models.get(name)
            if versions:
                model = versions[max(versions)]
            old_batcher = self._batchers.pop(name, None)
        self._swap_batcher(name, factory, model, old_batcher)

    def stop(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5)
            self._watcher = None
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.close()

    # -- queries ----------------------------------------------------------

    def get(self, name: str, version: Optional[int] = None) -> LoadedModel:
        with self._lock:
            if name not in self._models or not self._models[name]:
                raise KeyError(f"model {name!r} not loaded")
            versions = self._models[name]
            if version is None:
                return versions[max(versions)]
            if version not in versions:
                raise KeyError(f"model {name!r} has no version {version}; "
                               f"serving {sorted(versions)}")
            return versions[version]

    def models(self) -> Dict[str, List[int]]:
        with self._lock:
            return {n: sorted(v) for n, v in self._models.items()}

    def has_model(self, name: str) -> bool:
        """Whether ``name`` (or the base of ``model@adapter``) is served."""
        base, _ = split_model_adapter(name)
        with self._lock:
            return base in self._models

    def adapter_info(self) -> Dict[str, List[Dict[str, Any]]]:
        """Resident adapters per engine-served model (name, digest, slot
        index, pins) for the /readyz advertisement.  Models without an
        adapter registry are omitted."""
        with self._lock:
            batchers = dict(self._batchers)
        out: Dict[str, List[Dict[str, Any]]] = {}
        for name, batcher in batchers.items():
            info_fn = getattr(batcher, "adapter_info", None)
            if info_fn is None:
                continue
            info = info_fn()
            if info:
                out[name] = info
        return out

    def _resolve_adapter(self, name: str, inputs: Dict[str, Any]
                         ) -> Tuple[str, Dict[str, Any]]:
        """Split a ``model@adapter`` request name: the BASE name drives
        every lookup, in-flight count and batcher route (one model, one
        engine, one set of programs), while the adapter rides
        ``inputs["adapter"]`` for the engine to resolve against its
        registry at admission.  Plain names pass through untouched."""
        base, adapter = split_model_adapter(name)
        if adapter:
            inputs = dict(inputs)
            inputs["adapter"] = adapter
        return base, inputs

    def batcher_stats(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            batcher = self._batchers.get(name)
        return batcher.stats() if batcher is not None else None

    # -- readiness / drain ------------------------------------------------

    def begin_drain(self) -> None:
        """Flip /readyz not-ready (SIGTERM); accepted requests still run."""
        self._draining.set()

    def draining(self) -> bool:
        return self._draining.is_set()

    def is_ready(self) -> bool:
        if self._draining.is_set():
            return False
        with self._lock:
            return any(self._models.values())

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def enter_request(self) -> None:
        """Transport-level in-flight bracket (body read and parse
        included), so a drain cannot conclude while a request parses."""
        with self._lock:
            self._inflight += 1

    def exit_request(self) -> None:
        with self._lock:
            self._inflight -= 1

    def refresh_gauges(self) -> None:
        """Push the live load signals into the metrics registry: called
        at scrape time by the /metrics route, so the in-flight, queue,
        readiness, prefix-cache and spill gauges are current at the
        instant of the scrape."""
        with self._lock:
            total = self._inflight
            per_model = {n: self._inflight_by_model.get(n, 0)
                         for n in self._models}
        inflight = REGISTRY.gauge(INFLIGHT_GAUGE, INFLIGHT_HELP)
        inflight.set(total)
        for name, count in per_model.items():
            inflight.set(count, model=name)
        queue = REGISTRY.gauge(QUEUE_GAUGE, QUEUE_HELP)
        ratio = REGISTRY.gauge(CACHED_RATIO_GAUGE, CACHED_RATIO_HELP)
        spill = REGISTRY.gauge(SPILL_RATIO_GAUGE, SPILL_RATIO_HELP)
        cached_total = prompt_total = 0
        spill_used = spill_cap = 0
        any_engine = any_spill = False
        for name in per_model:
            stats = self.batcher_stats(name) or {}
            queue.set(stats.get("queue_depth", 0) or 0, model=name)
            if "cached_token_ratio" in stats:
                any_engine = True
                ratio.set(stats["cached_token_ratio"], model=name)
                cached_total += stats.get("cached_prompt_tokens", 0)
                prompt_total += stats.get("prompt_tokens", 0)
            cap = stats.get("host_spill_blocks", 0) or 0
            if cap:
                any_spill = True
                used = stats.get("host_tier_used", 0) or 0
                spill.set(round(used / cap, 4), model=name)
                spill_used += used
                spill_cap += cap
        if any_spill:
            spill.set(round(spill_used / spill_cap, 4))
        if any_engine:
            # The unlabeled aggregate resets with its engines: a reload
            # rebuilds the engine with an empty cache.
            ratio.set(round(cached_total / prompt_total, 4)
                      if prompt_total else 0.0)
        REGISTRY.gauge(READY_GAUGE, READY_HELP).set(
            1 if self.is_ready() else 0)

    @staticmethod
    def _single_row(inputs: Dict[str, Any]) -> bool:
        """True when every input leaf carries exactly one example -- the
        only shape a batcher entry can represent."""
        for v in inputs.values():
            if isinstance(v, str):
                continue  # routing metadata ("adapter"), not a leaf
            shape = getattr(v, "shape", None)
            if shape is None:
                shape = np.asarray(v).shape
            if len(shape) == 0 or shape[0] != 1:
                return False
        return True

    def predict(self, name: str, inputs: Dict[str, Any],
                version: Optional[int] = None,
                deadline: Optional[float] = None,
                idem_key: Optional[str] = None) -> Dict[str, Any]:
        """``deadline`` is an absolute faults.monotonic() instant,
        enforced in the batcher queues and at entry to the direct path.
        ``name`` may be ``model@adapter``.

        ``idem_key`` (the x-kft-idempotency-key header) dedups retried
        requests: the first presentation executes, an in-flight duplicate
        attaches to that execution, and a completed duplicate is answered
        from the TTL'd result cache."""
        name, inputs = self._resolve_adapter(name, inputs)
        if idem_key:
            return self._predict_deduped(name, inputs, version,
                                         deadline, idem_key)
        return self._predict_admitted(name, inputs, version, deadline)

    def _predict_deduped(self, name, inputs, version, deadline,
                         idem_key):
        verdict, entry = self._dedup.begin(idem_key)
        if verdict != "new":
            with self._lock:
                label = name if name in self._models else "_unknown_"
            REGISTRY.counter(DEDUP_HITS_TOTAL, DEDUP_HITS_HELP).inc(
                model=label)
            if verdict == "inflight":
                # Attach to the primary (no second execution, no second
                # in-flight slot), bounded by OUR deadline.
                timeout = None if deadline is None else max(
                    0.0, deadline - faults.monotonic())
                if not entry["event"].wait(timeout):
                    raise DeadlineExceeded(
                        f"deadline expired waiting on the in-flight "
                        f"twin of idempotency key {idem_key!r}")
            if entry["err"] is not None:
                raise entry["err"]
            return entry["result"]
        try:
            result = self._predict_admitted(name, inputs, version,
                                            deadline)
        except BaseException as exc:
            # Failures are not cached: waiters get the error, the key
            # frees, and a later retry re-executes.
            self._dedup.fail(idem_key, entry, exc)
            raise
        self._dedup.finish(idem_key, entry, result)
        return result

    def _predict_admitted(self, name: str, inputs: Dict[str, Any],
                          version: Optional[int],
                          deadline: Optional[float]) -> Dict[str, Any]:
        # Admission child span (trace context set by the transport): a
        # shed admission records status="shed", so the trace is kept.
        ctx = tracing.current_ctx()
        t_adm = time.perf_counter() if ctx is not None else 0.0
        try:
            with self._lock:
                if self._max_inflight and self._inflight_by_model.get(
                        name, 0) >= self._max_inflight:
                    REGISTRY.counter(SHED_TOTAL, SHED_HELP).inc(
                        batcher=f"{name}-inflight")
                    raise Overloaded(
                        f"model {name!r} at its in-flight cap "
                        f"({self._max_inflight})",
                        retry_after_s=self._overload_retry_after_s)
                self._inflight += 1
                self._inflight_by_model[name] = \
                    self._inflight_by_model.get(name, 0) + 1
        except Overloaded:
            self._record_admission(ctx, name, t_adm, status="shed")
            raise
        self._record_admission(ctx, name, t_adm)
        try:
            return self._predict(name, inputs, version, deadline)
        finally:
            self._exit_model(name)

    def _record_admission(self, ctx, name: str, t_adm: float,
                          status: str = "ok") -> None:
        """The one server.admission stamping site: shed and admitted
        verdicts both land here."""
        if ctx is not None:
            tracing.record_span(
                "server.admission", ctx, t_adm, time.perf_counter(),
                status=status, attrs={"model": name})

    def _predict(self, name: str, inputs: Dict[str, Any],
                 version: Optional[int],
                 deadline: Optional[float]) -> Dict[str, Any]:
        if deadline is not None and faults.monotonic() >= deadline:
            raise DeadlineExceeded(
                f"deadline expired before dispatch of {name!r}")
        if version is None:
            converted = {k: v if isinstance(v, str) or hasattr(v, "shape")
                         else np.asarray(v) for k, v in inputs.items()}
            # Bounded retry: a hot-swap or drain can close the batcher
            # between lookup and submit; the second lap takes the
            # replacement, and no replacement falls through to the direct
            # path, so an accepted request is never dropped.
            for _ in range(2):
                with self._lock:
                    batcher = self._batchers.get(name)
                if batcher is None or not self._single_row(converted):
                    break
                if inputs.get("adapter") and not hasattr(batcher,
                                                         "adapter_info"):
                    break  # a static batcher decodes base weights only
                accepts = getattr(batcher, "accepts", None)
                if accepts is not None and not accepts(converted):
                    break  # e.g. a prompt beyond the largest bucket
                try:
                    return batcher.submit(converted, deadline=deadline)
                except BatcherClosed:
                    continue
        model = self.get(name, version)
        if inputs.get("adapter"):
            # The direct path and the static batchers run the BASE weights
            # only: answering an adapter request with base output would be
            # a wrong-tenant response, worse than failing.
            raise AdapterNotFound(
                f"adapter {inputs['adapter']!r} requires the "
                f"continuous-batching engine; model {name!r} fell "
                f"through to the direct path")
        if deadline is not None and faults.monotonic() >= deadline:
            raise DeadlineExceeded(
                f"deadline expired before direct dispatch of {name!r}")
        return model.predict(inputs)

    def _engine_call(self, name: str, method: str, route: str):
        """The bound ``method`` of ``name``'s decode engine: KeyError (404)
        on unknown names, ValueError (400) when the model has no
        engine."""
        self.get(name)
        with self._lock:
            batcher = self._batchers.get(name)
        fn = getattr(batcher, method, None)
        if fn is None:
            raise ValueError(
                f"model {name!r} has no decode engine ({route} requires "
                "the continuous-batching engine)")
        return fn

    def _enter_model(self, name: str) -> None:
        with self._lock:
            self._inflight += 1
            self._inflight_by_model[name] = \
                self._inflight_by_model.get(name, 0) + 1

    def _exit_model(self, name: str) -> None:
        with self._lock:
            self._inflight -= 1
            self._inflight_by_model[name] -= 1

    def prefill_handoff(self, name: str, inputs: Dict[str, Any],
                        deadline: Optional[float] = None) -> Dict[str, Any]:
        """Disaggregated serving, prefill tier (the :prefill route): the
        prompt's chunked prefill on ``name``'s engine, returned with its
        finished KV pages (``kv_handoff``) for a decode tier to import.
        Bracketed in the in-flight counts like a predict."""
        name, inputs = self._resolve_adapter(name, inputs)
        export_fn = self._engine_call(name, "prefill_export", ":prefill")
        self._enter_model(name)
        try:
            return export_fn(inputs, deadline=deadline)
        finally:
            self._exit_model(name)

    def fetch_kv(self, name: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """The host spill tier's page fetch (:fetch_kv): ``tokens``' longest
        match in ``name``'s engine host tier, in the engine's export
        form, or a miss.  A pure host-memory read with no in-flight
        bracket: a drain must not wait on a peer's failover fetch, and
        the fetch keeps answering while this replica drains.  An adapter in
        ``name`` is dropped: a variant's pages are addressed by the
        ``adapter_digest`` input."""
        name, _ = split_model_adapter(name)
        return self._engine_call(name, "fetch_kv", ":fetch_kv")(inputs)

    def generate_stream(self, name: str, inputs: Dict[str, Any],
                        deadline: Optional[float] = None):
        """Streaming generation (the :generate route): (meta, iterator)
        from ``name``'s engine (see DecodeEngine.submit_stream).  The
        iterator is bracketed in the in-flight counts from its first
        iteration, so a drain waits for live streams; callers exhaust or
        close() it."""
        name, inputs = self._resolve_adapter(name, inputs)
        stream_fn = self._engine_call(name, "submit_stream", ":generate")
        meta, stream = stream_fn(inputs, deadline=deadline)

        def bracketed():
            self._enter_model(name)
            try:
                yield from stream
            finally:
                self._exit_model(name)

        return meta, bracketed()


class MicroBatcher:
    """Coalesce concurrent requests into padded device batches.

    Callers block in ``submit`` until their row comes back.  Batches are
    padded to the next size in ``allowed_batch_sizes``.  ``in_flight``
    runner threads each collect a batch and run predict, so one batch is
    assembled while another runs.  Rows group by shape signature, or by
    ``group_key`` with ``collate``/``finish`` hooks (all or none) that
    build the batch and restore each row's own shape.

    ``kft_serving_batch_size`` records each dispatched batch's occupied
    size (declared at construction, so an idle batcher scrapes zeros),
    and sheds and deadline expiries count in the shared series, all by
    ``batcher=name``.  A traced request gets a ``batcher.queue_wait``
    span for its time in the queue and a ``batcher.dispatch`` span for
    the cycle it rode.  Batch aging and deadlines read the policy clock.
    """

    def __init__(
        self,
        predict: Callable[[Dict[str, Any]], Dict[str, Any]],
        *,
        max_batch_size: int = 8,
        batch_timeout_s: float = 0.005,
        allowed_batch_sizes: Optional[List[int]] = None,
        in_flight: int = 2,
        max_queue_depth: int = 0,
        overload_retry_after_s: float = 1.0,
        name: str = "default",
        group_key: Optional[Callable[[Dict[str, Any]], Any]] = None,
        collate: Optional[Callable] = None,
        finish: Optional[Callable] = None,
    ):
        hooks = {"group_key": group_key, "collate": collate,
                 "finish": finish}
        given = [k for k, v in hooks.items() if v is not None]
        if given and len(given) != len(hooks):
            raise ValueError(
                f"MicroBatcher batch-assembly hooks are all-or-none: got "
                f"{sorted(given)} without {sorted(set(hooks) - set(given))}")
        self._predict = predict
        self._group_key = group_key
        self._collate = collate
        self._finish = finish
        self.allowed = sorted(allowed_batch_sizes or [1, 2, 4, 8])
        self.max_batch_size = min(max_batch_size, self.allowed[-1])
        self.batch_timeout_s = batch_timeout_s
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.overload_retry_after_s = overload_retry_after_s
        self._name = name
        self._lock = threading.Lock()
        self._flusher = threading.Condition(self._lock)
        # Pending entries per group; each group ages against its own
        # oldest entry.
        self._groups: Dict[Any, List[dict]] = {}
        self._next_deadline: Optional[float] = None
        self._stopped = False
        self._pending_total = 0
        self._batch_sizes: Dict[int, int] = {}
        self._requests = 0
        self._shed = 0
        self._expired = 0
        self._size_hist = REGISTRY.histogram(
            "kft_serving_batch_size",
            "occupied micro-batch size at dispatch, by batcher",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
        ).declare(batcher=name)
        self._shed_ctr = REGISTRY.counter(SHED_TOTAL, SHED_HELP)
        self._expired_ctr = REGISTRY.counter(EXPIRED_TOTAL, EXPIRED_HELP)
        self._runners = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"microbatcher-{i}")
            for i in range(max(1, in_flight))
        ]
        for r in self._runners:
            r.start()

    def submit(self, inputs: Dict[str, Any],
               deadline: Optional[float] = None) -> Dict[str, Any]:
        """One logical request of batch-dim 1 ([1, ...] rows)."""
        # Trace context captured on the caller's thread (the transport
        # set it); the runners stamp spans from these perf readings.
        trace_ctx = tracing.current_ctx()
        entry = {"inputs": inputs, "t": faults.monotonic(),
                 "deadline": deadline, "trace": trace_ctx,
                 "t_perf": time.perf_counter()
                 if trace_ctx is not None else 0.0,
                 "event": threading.Event(), "out": None, "err": None}
        if deadline is not None and faults.monotonic() >= deadline:
            with self._lock:
                self._expired += 1
            self._expired_ctr.inc(batcher=self._name)
            raise DeadlineExceeded(
                f"deadline expired before batcher {self._name!r} admission")
        if self._group_key is not None:
            sig = self._group_key(inputs)
        else:
            sig = self._shape_sig(inputs)
            for key, shape, _ in sig:
                if not shape or shape[0] != 1:
                    raise ValueError(
                        f"MicroBatcher.submit takes one row per call: input "
                        f"{key!r} has shape {shape}; submit rows separately")
        with self._lock:
            if self._stopped:
                raise BatcherClosed(f"batcher {self._name!r} is closed")
            if self.max_queue_depth \
                    and self._pending_total >= self.max_queue_depth:
                self._shed += 1
                self._shed_ctr.inc(batcher=self._name)
                raise Overloaded(
                    f"batcher {self._name!r} queue full "
                    f"({self._pending_total} pending)",
                    retry_after_s=self.overload_retry_after_s)
            self._groups.setdefault(sig, []).append(entry)
            self._pending_total += 1
            self._flusher.notify()
        entry["event"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hist = dict(sorted(self._batch_sizes.items()))
            requests = self._requests
            out = {"queue_depth": self._pending_total, "shed": self._shed,
                   "deadline_expired": self._expired}
        batches = sum(hist.values())
        out.update(requests=requests, batches=batches,
                   batch_size_hist=hist,
                   mean_batch_size=round(requests / batches, 2)
                   if batches else 0.0)
        return out

    def close(self) -> None:
        """Refuse new work and fail queued, undispatched entries with
        BatcherClosed (ModelServer.predict retries the replacement or the
        direct path); dispatched batches complete normally."""
        with self._lock:
            self._stopped = True
            queued = [e for q in self._groups.values() for e in q]
            self._groups.clear()
            self._pending_total = 0
            self._flusher.notify_all()
        err = BatcherClosed(f"batcher {self._name!r} is closed")
        for e in queued:
            e["err"] = err
            e["event"].set()
        for r in self._runners:
            r.join(timeout=5)

    @staticmethod
    def _shape_sig(inputs: Dict[str, Any]):
        sig = []
        for k, v in sorted(inputs.items()):
            a = np.asarray(v)
            sig.append((k, a.shape, a.dtype.str))
        return tuple(sig)

    def _take_batch_locked(self, expired: List[dict]) -> Optional[List[dict]]:
        """Pop the next dispatchable group, or None when none is ready.

        A group is dispatchable when full, when its oldest entry has aged
        past batch_timeout_s, or at shutdown; among those the oldest head
        goes first, so a busy majority shape cannot starve a minority
        one.  Entries past their deadline move into ``expired``.
        """
        # One policy clock for request deadlines and batch aging: a
        # seeded skew ages queued entries as it expires deadlines.
        now = faults.monotonic()
        best_sig, best_t = None, None
        self._next_deadline = None

        def note_wake(at: float) -> None:
            if self._next_deadline is None or at < self._next_deadline:
                self._next_deadline = at

        for sig in list(self._groups):
            q = self._groups[sig]
            keep = []
            for e in q:
                d = e["deadline"]
                if d is not None and d <= now:
                    expired.append(e)
                    continue
                keep.append(e)
                if d is not None:
                    note_wake(d)
            if len(keep) != len(q):
                self._pending_total -= len(q) - len(keep)
                if not keep:
                    del self._groups[sig]
                    continue
                self._groups[sig] = q = keep
            ready_at = q[0]["t"] + self.batch_timeout_s
            if (len(q) >= self.max_batch_size or ready_at <= now
                    or self._stopped):
                if best_t is None or q[0]["t"] < best_t:
                    best_sig, best_t = sig, q[0]["t"]
            else:
                note_wake(ready_at)
        if best_sig is None:
            return None
        q = self._groups[best_sig]
        batch, rest = q[:self.max_batch_size], q[self.max_batch_size:]
        if rest:
            self._groups[best_sig] = rest
        else:
            del self._groups[best_sig]
        self._pending_total -= len(batch)
        return batch

    def _record_queue_wait(self, entries: List[dict],
                           status: str = "ok") -> None:
        """The one batcher.queue_wait stamping site: dispatched and
        deadline-expired entries both land here."""
        if not any(e["trace"] is not None for e in entries):
            return
        now_perf = time.perf_counter()
        for e in entries:
            if e["trace"] is not None:
                tracing.record_span(
                    "batcher.queue_wait", e["trace"], e["t_perf"],
                    now_perf, status=status,
                    attrs={"batcher": self._name})

    def _run(self) -> None:
        while True:
            expired: List[dict] = []
            with self._lock:
                batch = None
                while batch is None and not expired:
                    if not self._groups:
                        if self._stopped:
                            return
                        self._flusher.wait()
                        continue
                    batch = self._take_batch_locked(expired)
                    if batch is None and not expired:
                        self._flusher.wait(
                            timeout=None if self._next_deadline is None
                            else max(0.0, self._next_deadline
                                     - faults.monotonic()))
                self._expired += len(expired)
                if batch is not None:
                    # stats() and the scrapeable histogram record the
                    # same quantity at the same site.
                    self._batch_sizes[len(batch)] = \
                        self._batch_sizes.get(len(batch), 0) + 1
                    self._requests += len(batch)
                    self._size_hist.observe(float(len(batch)),
                                            batcher=self._name)
            if expired:
                self._expired_ctr.inc(len(expired), batcher=self._name)
                err = DeadlineExceeded(
                    f"deadline expired in batcher {self._name!r} queue")
                self._record_queue_wait(expired,
                                        status="deadline_expired")
                for e in expired:
                    e["err"] = err
                    e["event"].set()
            if batch is not None:
                self._record_queue_wait(batch)
                self._process(batch)

    def _pad_size(self, n: int) -> int:
        for size in self.allowed:
            if n <= size:
                return size
        return self.allowed[-1]

    def _process(self, batch: List[dict]) -> None:
        try:
            # Chaos hook: a scripted stall simulates a wedged dispatch, a
            # scripted raise takes the device-failure path to waiters.
            faults.fire("batcher.dispatch")
            t0 = time.perf_counter()
            n = len(batch)
            size = self._pad_size(n)
            metas: Optional[List[Any]] = None
            if self._collate is not None:
                stacked, metas = self._collate([e["inputs"] for e in batch])
            else:
                stacked = {
                    k: np.concatenate([np.asarray(e["inputs"][k])
                                       for e in batch], axis=0)
                    for k in batch[0]["inputs"]
                }
            if size > n:
                stacked = {k: np.concatenate([v] + [v[:1]] * (size - n),
                                             axis=0)
                           for k, v in stacked.items()}
            host = {k: np.asarray(v)
                    for k, v in self._predict(stacked).items()}
            for i, e in enumerate(batch):
                row = {k: v[i:i + 1] for k, v in host.items()}
                if metas is not None:
                    row = self._finish(row, metas[i])
                e["out"] = row
                e["event"].set()
            t1 = time.perf_counter()
            # The whole dispatch cycle each traced row rode, with the
            # occupied and padded batch sizes.
            for e in batch:
                if e["trace"] is not None:
                    tracing.record_span(
                        "batcher.dispatch", e["trace"], t0, t1,
                        attrs={"batcher": self._name, "batch_size": n,
                               "padded_to": size})
        except Exception as exc:  # noqa: BLE001 -- delivered to waiters
            # Rows already delivered keep their results.
            for e in batch:
                if not e["event"].is_set():
                    e["err"] = exc
                    e["event"].set()


class BucketedLMBatcher:
    """Mixed-length LM batching: one queue per band, pad at dispatch.

    models/generate.py masks left-pad keys and offsets rope, so a padded
    row with its real length in ``prompt_len`` decodes exactly as alone,
    which makes any two prompts batch-compatible.  A batch pads to the
    smallest bucket covering its longest member.  ``max_promotion_factor``
    partitions the buckets into bands whose largest/smallest ratio stays
    within the factor, and only requests of one band share a batch, so a
    short prompt never pays more than factor x its own bucket's KV span
    per decode step.  ``None`` keeps a single queue.
    """

    # Output keys aligned to the padded position axis, stripped per row.
    _POSITIONAL_KEYS = ("tokens",)

    def __init__(
        self,
        predict: Callable[[Dict[str, Any]], Dict[str, Any]],
        *,
        buckets: Optional[List[int]] = None,
        pad_token: int = 0,
        max_promotion_factor: Optional[float] = 4.0,
        **batcher_kwargs,
    ):
        self.buckets = sorted(buckets or [32, 64, 128, 256, 512, 1024])
        self.pad_token = pad_token
        self._band: Dict[int, int] = {}
        if max_promotion_factor is None:
            self._band = {b: 0 for b in self.buckets}
        else:
            band, band_min = -1, None
            for b in self.buckets:
                if band_min is None or b > band_min * max_promotion_factor:
                    band, band_min = band + 1, b
                self._band[b] = band
        self._inner = MicroBatcher(
            predict,
            group_key=lambda inputs: (
                "lm", self._band[self.bucket_for(
                    np.asarray(inputs["tokens"]).shape[-1])]),
            collate=self._collate,
            finish=self._strip,
            **batcher_kwargs)

    def _collate(self, rows: List[Dict[str, Any]]):
        """Stack raw single-row submissions, left-padding every prompt to
        the batch bucket.  A per-request ``max_new_tokens`` rides the row
        meta, and _strip trims the completion to it."""
        tokens = [np.asarray(r["tokens"]) for r in rows]
        lengths = [t.shape[1] for t in tokens]
        bucket = self.bucket_for(max(lengths))
        padded = [
            np.concatenate(
                [np.full((1, bucket - n), self.pad_token, t.dtype), t],
                axis=1) if bucket > n else t
            for t, n in zip(tokens, lengths)
        ]
        stacked = {
            "tokens": np.concatenate(padded, axis=0),
            "prompt_len": np.asarray(lengths, np.int32),
        }
        meta = [
            (bucket - n, n,
             max(1, int(np.asarray(r["max_new_tokens"]).reshape(())))
             if r.get("max_new_tokens") is not None else None)
            for r, n in zip(rows, lengths)
        ]
        return stacked, meta

    @classmethod
    def _strip(cls, row: Dict[str, Any], meta) -> Dict[str, Any]:
        pad, prompt_len, new = meta

        def cut(v):
            if pad:
                v = v[:, pad:]
            if new is not None:
                v = v[:, : prompt_len + new]
            return v

        return {k: (cut(v) if k in cls._POSITIONAL_KEYS else v)
                for k, v in row.items()}

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def accepts(self, inputs: Dict[str, Any]) -> bool:
        """Prompts beyond the largest bucket, and seeded requests (all
        rows of a batch share one sample stream), take the direct path."""
        if inputs.get("seed") is not None:
            return False
        tokens = np.asarray(inputs.get("tokens", ()))
        length = tokens.shape[-1] if tokens.ndim else 0
        return bool(length and length <= self.buckets[-1])

    def submit(self, inputs: Dict[str, Any],
               deadline: Optional[float] = None) -> Dict[str, Any]:
        """One prompt: tokens [t] or [1, t]."""
        tokens = np.asarray(inputs["tokens"])
        if tokens.ndim == 1:
            tokens = tokens[None]
        n, length = tokens.shape
        if n != 1:
            raise ValueError(
                f"BucketedLMBatcher.submit takes one prompt per call (got "
                f"batch dim {n}); submit rows separately")
        self.bucket_for(length)  # reject oversize up front
        row = {"tokens": tokens}
        if inputs.get("max_new_tokens") is not None:
            row["max_new_tokens"] = inputs["max_new_tokens"]
        return self._inner.submit(row, deadline=deadline)

    def stats(self) -> Dict[str, Any]:
        return self._inner.stats()

    def close(self) -> None:
        self._inner.close()
