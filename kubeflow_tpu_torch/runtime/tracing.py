"""Distributed request tracing: spans, W3C propagation, tail sampling.

The port's copy of kubeflow_tpu/runtime/tracing.py (stdlib only), on
the port's metrics registry and fault clock.  Of the serving surface,
the decode engine stamps spans on it so far; the REST trace routes are
not ported yet (ROADMAP queue 1, item 9).

Aggregates (`/metrics`, ``stats()``) say THAT p99 moved; this module
says WHERE one request spent its time.  A request entering the fleet
router starts (or continues) a trace; the ``traceparent`` header (W3C
Trace Context, the one-line wire format every tracing backend speaks)
carries the trace across the proxy hop; the model server, batchers,
and decode engine stamp child spans for admission, queue wait, prefix
copy, prefill chunks, and decode participation.  Completed traces land
in a bounded in-process :class:`TraceStore` with TAIL sampling — the
keep/drop decision happens when the trace's local root span ends, so
errored, shed, and deadline-expired requests are always retained and
slow requests are kept by a rolling latency threshold, while the happy
path is sampled at a configurable rate.  Stores are served as JSON on
``/debug/traces`` (model server REST port, router port, operator
metrics port) and rendered by ``kubeflow-tpu trace list|show``.

Design rules:

  * stdlib-only, thread-safe, and NEAR-ZERO cost while disabled: every
    entry point checks one module global; hot loops (the engine step
    loop) never create live span objects — spans are stamped at drain
    time from ``time.perf_counter`` readings already taken.
  * span DURATIONS are measured with ``time.perf_counter`` (a duration
    must not bend under an injected clock skew); span START times are
    anchored to the wall clock once at import so traces from different
    processes line up; every POLICY decision (tail-sampling threshold
    aging, open-trace expiry) reads the skewable
    ``testing.faults.monotonic()`` policy clock — the same clock
    discipline the analyzer enforces on the serving planes
    (docs/user_guide.md §10.1).
"""

from __future__ import annotations

import collections
import contextlib
import random
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.testing import faults

TRACEPARENT = "traceparent"

# Client-fault statuses: an ANSWER to a bad request (404/400), not a
# serving incident — these sample like healthy traffic instead of
# riding the always-keep error tier, or a scanner probing
# /model/<junk>:predict would LRU-flush the incident traces the store
# exists to keep.  The status still lands verbatim on the span/trace.
CLIENT_FAULT_STATUSES = frozenset({"not_found", "invalid_argument"})

SPANS_TOTAL = "kft_trace_spans_total"
SPANS_HELP = "spans recorded into the trace store"
SPANS_DROPPED_TOTAL = "kft_trace_spans_dropped_total"
SPANS_DROPPED_HELP = "spans discarded (tail-sampled out / bounds), by reason"
RETAINED_TOTAL = "kft_trace_retained_total"
RETAINED_HELP = "traces kept by tail sampling, by reason"
STORE_TRACES = "kft_trace_store_traces"
STORE_TRACES_HELP = "completed traces currently held in the trace store"

# Wall anchor: wall_time = _WALL_ANCHOR + perf_counter reading.  Taken
# once so every span start in this process shares one consistent epoch
# mapping; the stamp leaves the process in /debug/traces JSON.
# kft: allow=clock-discipline — wall anchor for human-readable stamps
_WALL_ANCHOR = time.time() - time.perf_counter()

# OS-seeded: trace ids must differ across replicas (a fixed seed would
# collide every replica's first trace onto one id).
_IDS = random.Random()
_ID_LOCK = threading.Lock()


def new_trace_id() -> str:
    with _ID_LOCK:
        value = _IDS.getrandbits(128)
    return f"{value or 1:032x}"  # all-zero is invalid per W3C


def new_span_id() -> str:
    with _ID_LOCK:
        value = _IDS.getrandbits(64)
    return f"{value or 1:016x}"


class SpanContext(NamedTuple):
    """Propagatable identity of a span: what a child needs to parent
    itself.  ``remote`` marks a context that crossed a process hop
    (extracted from a ``traceparent`` header) — a span started under a
    remote parent is this process's LOCAL ROOT and drives the tail-
    sampling decision when it ends."""

    trace_id: str
    span_id: str
    remote: bool = False


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(value: Optional[str]) -> \
        Optional[Tuple[str, str, int]]:
    """W3C traceparent -> (trace_id, span_id, flags), or None on any
    malformation (a bad header must start a fresh trace, not crash the
    request)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[:4]
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, flag_bits


class TraceStore:
    """Bounded in-process store of completed traces, tail-sampled.

    Spans accumulate per trace_id in an OPEN buffer; when the trace's
    local root span completes, the verdict is taken in order:

      error   root status != "ok" (shed / deadline_expired / error):
              ALWAYS kept — the traces an incident needs;
      slow    root duration over the rolling latency threshold (the
              ``slow_percentile`` of recent root durations inside
              ``slow_window_s``, armed once ``min_slow_samples`` have
              been seen);
      sampled everything else keeps with probability ``sample_rate``.

    Everything is bounded: kept traces (LRU ring of ``capacity``),
    spans per trace, the dropped-id memory, and the duration window.
    Threshold aging and open-trace expiry read the skewable policy
    clock (``faults.monotonic``); durations themselves come from the
    caller's ``perf_counter`` readings."""

    def __init__(self, capacity: int = 128, sample_rate: float = 0.05,
                 max_spans_per_trace: int = 256,
                 slow_window_s: float = 300.0,
                 slow_percentile: float = 0.9,
                 min_slow_samples: int = 16,
                 max_open_age_s: float = 600.0,
                 rng: Optional[random.Random] = None):
        self.capacity = max(1, int(capacity))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self.slow_window_s = slow_window_s
        self.slow_percentile = slow_percentile
        self.min_slow_samples = max(1, int(min_slow_samples))
        self.max_open_age_s = max_open_age_s
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._open: Dict[str, dict] = {}
        self._kept: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._dropped: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()
        # (policy-clock stamp, duration_s) of recent root completions,
        # windowed PER ROOT NAME: one store holds traces of very
        # different kinds (a scheduler plan pass runs microseconds, a
        # job lifecycle runs minutes), and a shared window would let
        # the fast kind's p90 mark every slow kind's trace "slow" —
        # retaining 100% of healthy job traces and evicting the error
        # traces the store exists to keep.  Names are code-controlled
        # literals, so the key cardinality is bounded by construction.
        self._durations: Dict[str, "collections.deque"] = {}
        self._spans_ctr = REGISTRY.counter(SPANS_TOTAL, SPANS_HELP)
        self._dropped_ctr = REGISTRY.counter(SPANS_DROPPED_TOTAL,
                                             SPANS_DROPPED_HELP)
        self._retained_ctr = REGISTRY.counter(RETAINED_TOTAL,
                                              RETAINED_HELP)
        self._gauge = REGISTRY.gauge(STORE_TRACES, STORE_TRACES_HELP)
        self._gauge.set(0)

    # -- span intake -------------------------------------------------------

    def add(self, span: Dict[str, Any]) -> None:
        tid = span["trace_id"]
        self._spans_ctr.inc()
        with self._lock:
            kept = self._kept.get(tid)
            if kept is not None:
                # Late spans of a retained trace (the router root ends
                # after the replica's) still land in the entry.
                if len(kept["spans"]) < self.max_spans_per_trace:
                    kept["spans"].append(span)
                else:
                    self._dropped_ctr.inc(reason="overflow")
                return
            if tid in self._dropped:
                self._dropped_ctr.inc(reason="sampled")
                return
            entry = self._open.get(tid)
            if entry is None:
                if len(self._open) >= 4 * self.capacity:
                    self._sweep_open_locked()
                entry = self._open[tid] = {"spans": []}
            # The age stamp REFRESHES on every appended span: aging
            # exists to reap traces whose root will never complete
            # (crashed requests), not to strip spans from a trace that
            # is still actively accumulating them.
            entry["t"] = faults.monotonic()
            if len(entry["spans"]) < self.max_spans_per_trace:
                entry["spans"].append(span)
            else:
                self._dropped_ctr.inc(reason="overflow")

    def complete(self, trace_id: str, status: str,
                 duration_s: float, name: str = "") -> Optional[str]:
        """A local root span of ``trace_id`` ended: take the tail-
        sampling verdict.  Returns the retention reason (``error`` /
        ``slow`` / ``sampled``) or None when the trace was dropped.
        ``name`` (the root span's name) selects the rolling-latency
        window the duration is judged against and joins.  First
        verdict wins — a second local root completing the same trace
        (router + replica sharing one store in hermetic runs) only
        contributes its duration sample."""
        pnow = faults.monotonic()
        with self._lock:
            # Verdict against the window of PRIOR completions — this
            # root's own duration joins the window after, or it would
            # drag the percentile toward itself and un-slow itself.
            threshold = self._slow_threshold_locked(pnow, name)
            window = self._durations.setdefault(
                name, collections.deque(maxlen=512))
            window.append((pnow, duration_s))
            if trace_id in self._kept:
                return self._kept[trace_id]["retained"]
            is_error = (status != "ok"
                        and status not in CLIENT_FAULT_STATUSES)
            if trace_id in self._dropped:
                if not is_error:
                    return None
                # An errored root under a previously-dropped id (a
                # client reusing one traceparent across requests): the
                # always-keep tier OUTRANKS the drop memory — un-drop
                # and retain whatever spans have arrived since.
                del self._dropped[trace_id]
            reason = None
            if is_error:
                reason = "error"
            elif duration_s > threshold:
                # STRICTLY above the rolling percentile: a constant-
                # latency workload (every duration == the threshold)
                # must sample normally, not retain everything as slow.
                reason = "slow"
            elif self._rng.random() < self.sample_rate:
                reason = "sampled"
            entry = self._open.pop(trace_id, None) or {"spans": []}
            if reason is None:
                self._dropped[trace_id] = pnow
                while len(self._dropped) > 4 * self.capacity:
                    self._dropped.popitem(last=False)
                if entry["spans"]:
                    self._dropped_ctr.inc(len(entry["spans"]),
                                          reason="sampled")
                return None
            self._kept[trace_id] = {
                "trace_id": trace_id, "retained": reason,
                "status": status,
                "duration_ms": round(duration_s * 1e3, 3),
                "completed_at": pnow, "spans": entry["spans"],
            }
            while len(self._kept) > self.capacity:
                # Preference-ordered eviction: sampled happy-path
                # traces go first, then slow ones, and error-retained
                # incident traces only when nothing else is left —
                # sustained healthy traffic must not flush the very
                # traces the always-keep tier exists for.  O(capacity)
                # scan, only on overflow.
                victim = None
                for tier in ("sampled", "slow"):
                    victim = next(
                        (tid for tid, e in self._kept.items()
                         if e["retained"] == tier), None)
                    if victim is not None:
                        break
                if victim is None:
                    victim = next(iter(self._kept))
                evicted = self._kept.pop(victim)
                self._dropped_ctr.inc(len(evicted["spans"]),
                                      reason="evicted")
            self._sweep_open_locked(pnow)
            self._gauge.set(len(self._kept))
        self._retained_ctr.inc(reason=reason)
        return reason

    def _sweep_open_locked(self, pnow: Optional[float] = None) -> None:
        """Expire open traces whose local root never completed (policy
        clock) — a crashed request must not pin its buffer forever."""
        pnow = faults.monotonic() if pnow is None else pnow
        for tid in [t for t, e in self._open.items()
                    if pnow - e["t"] > self.max_open_age_s]:
            entry = self._open.pop(tid)
            self._dropped_ctr.inc(len(entry["spans"]), reason="aged")

    def _slow_threshold_locked(self, pnow: float,
                               name: str = "") -> float:
        window = self._durations.get(name)
        if window is None:
            return float("inf")
        while window and pnow - window[0][0] > self.slow_window_s:
            window.popleft()
        if len(window) < self.min_slow_samples:
            return float("inf")
        durs = sorted(d for _, d in window)
        return durs[min(len(durs) - 1,
                        int(len(durs) * self.slow_percentile))]

    # -- read surface ------------------------------------------------------

    def traces(self) -> List[Dict[str, Any]]:
        """Retained traces, newest first, spans sorted by start."""
        with self._lock:
            kept = [dict(entry, spans=list(entry["spans"]))
                    for entry in self._kept.values()]
        out = []
        for entry in reversed(kept):
            spans = sorted(entry["spans"],
                           key=lambda s: s.get("start_s", 0.0))
            roots = [s for s in spans if not s.get("parent_id")]
            root_name = (roots[0]["name"] if roots
                         else spans[0]["name"] if spans else "")
            out.append({
                "trace_id": entry["trace_id"],
                "root": root_name,
                "status": entry["status"],
                "retained": entry["retained"],
                "duration_ms": entry["duration_ms"],
                "spans": spans,
            })
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/traces payload."""
        with self._lock:
            open_count = len(self._open)
        return {
            "enabled": True,
            "capacity": self.capacity,
            "sample_rate": self.sample_rate,
            "open_traces": open_count,
            "traces": self.traces(),
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._kept)


# -- module tracer state ---------------------------------------------------

# The one enable/disable switch every entry point reads.  Library
# default is DISABLED (zero overhead for embedders and tests); the
# serving/router/operator entrypoints enable it from their flags.
_STORE: Optional[TraceStore] = None
_TLS = threading.local()


class _NullSpan:
    """The disabled-path span: every method a no-op, falsy, shareable."""

    __slots__ = ()
    ctx = None

    def __bool__(self) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    def end(self, status: str = "ok", **attrs) -> None:
        pass

    def traceparent(self) -> str:
        return ""


NULL_SPAN = _NullSpan()


class Span:
    """A live span: created by :func:`start_span`, finished by
    ``end()`` (which records it and — for local roots — triggers the
    store's tail-sampling verdict)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "_start_perf", "_local_root", "_ended")

    def __init__(self, name: str, trace_id: str, parent_id:
                 Optional[str], local_root: bool,
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs or {})
        self._start_perf = time.perf_counter()
        self._local_root = local_root
        self._ended = False

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, remote=False)

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, status: str = "ok", **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        store = _STORE
        if store is None:
            return
        end_perf = time.perf_counter()
        if attrs:
            self.attrs.update(attrs)
        duration = end_perf - self._start_perf
        store.add({
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": round(_WALL_ANCHOR + self._start_perf, 6),
            "duration_ms": round(duration * 1e3, 3),
            "status": status,
            "attrs": self.attrs,
        })
        if self._local_root:
            store.complete(self.trace_id, status, duration,
                           name=self.name)


def enable(sample_rate: float = 0.05, capacity: int = 128,
           **store_kwargs) -> TraceStore:
    """Install a fresh global trace store and return it."""
    global _STORE
    _STORE = TraceStore(capacity=capacity, sample_rate=sample_rate,
                        **store_kwargs)
    return _STORE


def add_cli_args(ap, dashes: bool = False) -> None:
    """The one definition of the tracing flags every daemon entrypoint
    shares (serving, router, operator).  ``dashes`` picks the flag
    spelling convention (--trace-sample-rate vs --trace_sample_rate);
    argparse normalizes both to the same dests."""
    sep = "-" if dashes else "_"
    ap.add_argument(f"--no{sep}tracing", action="store_true",
                    help="disable distributed tracing (spans + the "
                         "tail-sampled /debug/traces store)")
    ap.add_argument(f"--trace{sep}sample{sep}rate", type=float,
                    default=0.05,
                    help="tail-sampling keep probability for healthy "
                         "traces (errored/shed/deadline-expired and "
                         "rolling-threshold-slow traces are always "
                         "kept)")
    ap.add_argument(f"--trace{sep}capacity", type=int, default=128,
                    help="completed traces held in the in-process "
                         "store served at /debug/traces")


def enable_from_args(args) -> Optional[TraceStore]:
    """Apply :func:`add_cli_args` flags; returns the store, or None
    when --no-tracing was passed."""
    if args.no_tracing:
        return None
    return enable(sample_rate=args.trace_sample_rate,
                  capacity=args.trace_capacity)


def disable() -> None:
    global _STORE
    _STORE = None


def enabled() -> bool:
    return _STORE is not None


def store() -> Optional[TraceStore]:
    return _STORE


def snapshot() -> Dict[str, Any]:
    st = _STORE
    if st is None:
        return {"enabled": False, "traces": []}
    return st.snapshot()


def current_ctx() -> Optional[SpanContext]:
    """The thread's current span context (set by :func:`use_span`), or
    None when tracing is disabled or no span is active.  This is how
    admission code (engine/batcher ``submit``, which runs on the
    transport thread) picks up the server span without any signature
    change."""
    if _STORE is None:
        return None
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use_span(span):
    """Bind ``span`` as the thread's current context for the block
    (no-op for the null span)."""
    ctx = getattr(span, "ctx", None)
    if ctx is None:
        yield
        return
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield
    finally:
        _TLS.ctx = prev


def start_span(name: str, parent=None,
               attrs: Optional[Dict[str, Any]] = None):
    """Begin a live span.  ``parent`` may be a :class:`Span`, a
    :class:`SpanContext` (e.g. from :func:`extract`), or None (a new
    trace).  A span with no parent, or a REMOTE parent, is this
    process's local root: its ``end()`` drives tail sampling."""
    if _STORE is None:
        return NULL_SPAN
    ctx = getattr(parent, "ctx", parent)
    if ctx is None:
        return Span(name, new_trace_id(), None, True, attrs)
    return Span(name, ctx.trace_id, ctx.span_id, bool(ctx.remote),
                attrs)


def new_root_ctx() -> Optional[SpanContext]:
    """A fresh root context for DRAIN-TIME stamped traces (the job
    lifecycle): children record against it incrementally and the root
    span itself is stamped at the end via ``record_span(root=True)``."""
    if _STORE is None:
        return None
    return SpanContext(new_trace_id(), new_span_id(), remote=False)


def record_span(name: str, ctx: Optional[SpanContext],
                start_perf: float, end_perf: float,
                status: str = "ok",
                attrs: Optional[Dict[str, Any]] = None,
                root: bool = False) -> Optional[Dict[str, Any]]:
    """Stamp a completed span from two ``perf_counter`` readings the
    caller already took — the hot-loop-friendly path: no live object,
    no clock reads inside the timed region.  With ``root=True`` the
    span takes ``ctx.span_id`` itself (parent None) and completes the
    trace."""
    store_ = _STORE
    if store_ is None or ctx is None:
        return None
    duration = max(0.0, end_perf - start_perf)
    span = {
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id if root else new_span_id(),
        "parent_id": None if root else ctx.span_id,
        "name": name,
        "start_s": round(_WALL_ANCHOR + start_perf, 6),
        "duration_ms": round(duration * 1e3, 3),
        "status": status,
        "attrs": dict(attrs or {}),
    }
    store_.add(span)
    if root:
        store_.complete(ctx.trace_id, status, duration, name=name)
    return span


def extract(headers) -> Optional[SpanContext]:
    """Incoming-edge propagation: a ``traceparent`` in ``headers``
    (anything with ``.get`` — a dict, an http.client message) becomes
    a REMOTE parent context; absent/malformed -> None (fresh trace).
    HTTP header names are case-insensitive on the wire and proxies
    commonly re-case them, so a plain-dict miss falls back to a
    case-insensitive scan (email.Message .get is already
    case-insensitive)."""
    if _STORE is None or headers is None:
        return None
    value = headers.get(TRACEPARENT)
    if value is None and isinstance(headers, dict):
        for key, candidate in headers.items():
            if key.lower() == TRACEPARENT:
                value = candidate
                break
    parsed = parse_traceparent(value)
    if parsed is None:
        return None
    trace_id, span_id, _ = parsed
    return SpanContext(trace_id, span_id, remote=True)
