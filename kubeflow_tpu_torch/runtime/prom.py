"""Prometheus text-format metrics (exposition format 0.0.4): the port's
copy of kubeflow_tpu/runtime/prom.py (stdlib only; the port imports
nothing of the JAX package).

The registry's API is the one the port has set since it was first
copied: counters, gauges and histograms whose ``value()`` reads one
series (a histogram's observation count).  The exposition is JAX's:
``Registry.render()`` writes the text the model server's ``GET
/metrics`` answers, ``parse_metrics`` and ``sample_value`` read it back,
and ``serve_metrics`` serves a registry on a port of its own.

Usage:
    REGISTRY.counter("kft_requests_total", "...").inc(model="m")
    REGISTRY.gauge("kft_jobs", "...").set(3, phase="Running")
    REGISTRY.histogram("kft_latency_seconds", "...").observe(0.2)
    text = REGISTRY.render()
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    """Label-value escaping per exposition format 0.0.4 — one bad value
    must not corrupt the whole scrape."""
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _render(self) -> List[str]:
        # Snapshot under the lock, format outside it: the lock pays one
        # dict copy, not the string work.
        with self._lock:
            values = sorted(self._values.items())
        return [
            f"{self.name}{_fmt_labels(k)} {v}" for k, v in values
        ] or [f"{self.name} 0"]


class Counter(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "gauge")

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def labelsets(self) -> List[Dict[str, str]]:
        """Every label combination this gauge has been set with: what a
        control loop zeroes before re-exporting a sparse snapshot (a
        drained queue bucket must scrape as 0, not hold its last
        value)."""
        with self._lock:
            return [dict(key) for key in self._values]


class Histogram(_Metric):
    """Bucketed observations per label set; ``value()`` reads a series'
    observation count."""

    def __init__(self, name: str, help_: str,
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def declare(self, **labels) -> "Histogram":
        """Create a label series at zero counts before it observes, so
        an idle series scrapes as real zeros rather than 'no data'."""
        key = _label_key(labels)
        with self._lock:
            self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            self._sums.setdefault(key, 0.0)
            self._values.setdefault(key, 0.0)
        return self

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._values[key] = float(counts[-1])

    def _render(self) -> List[str]:
        # Snapshot bucket counts AND the sum under the metric lock in
        # one motion (list() copies each per-series count vector), then
        # format OUTSIDE it: a concurrent observe() between reading a
        # series' counts and its sum would otherwise scrape a torn pair
        # — a _count that disagrees with _sum breaks every rate()/avg
        # recording rule downstream — and string formatting has no
        # business extending the writers' critical section.
        with self._lock:
            snapshot = [(key, list(counts), self._sums[key])
                        for key, counts in sorted(self._counts.items())]
        out: List[str] = []
        if not snapshot:
            # A registered-but-unobserved histogram must scrape as
            # zero counts, not as a missing series — 'no data' is
            # indistinguishable from 'scrape broken' on a dashboard.
            # This bare-name guarantee only holds for UNLABELED
            # histograms; labeled series get it via declare().
            for b in self.buckets:
                out.append(f'{self.name}_bucket{{le="{b}"}} 0')
            out.append(f'{self.name}_bucket{{le="+Inf"}} 0')
            out.append(f"{self.name}_sum 0.0")
            out.append(f"{self.name}_count 0")
            return out
        for key, counts, total in snapshot:
            # le labels built outside the f-string expressions:
            # backslash escapes inside an f-string expression are a
            # SyntaxError before Python 3.12, and serving must run
            # on 3.10.
            for i, b in enumerate(self.buckets):
                le = 'le="%s"' % b
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, le)} {counts[i]}")
            le_inf = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(key, le_inf)} {counts[-1]}")
            out.append(
                f"{self.name}_sum{_fmt_labels(key)} {total}")
            out.append(
                f"{self.name}_count{_fmt_labels(key)} {counts[-1]}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help_: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"{name} already registered as {m.kind}")
            elif "buckets" in kwargs and tuple(
                    sorted(kwargs["buckets"])) != m.buckets:
                raise ValueError(
                    f"{name} already registered with buckets {m.buckets}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_UNESCAPE = re.compile(r"\\(.)")
_ESCAPES = {"n": "\n", "\\": "\\", '"': '"'}


def _unescape(value: str) -> str:
    """Single-pass inverse of _escape: sequential str.replace passes
    would re-scan their own output (r'\\\\n' — a literal backslash
    then 'n' — must NOT become backslash+newline)."""
    return _UNESCAPE.sub(
        lambda m: _ESCAPES.get(m.group(1), m.group(0)), value)


def parse_metrics(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                     float]]]:
    """Parse exposition-format text back into samples.

    Returns ``{metric_name: [(labels, value), ...]}``.  The inverse of
    ``Registry.render`` for the three line shapes this module emits —
    what the fleet autoscaler uses to read ``kft_serving_*`` gauges off
    replica ``/metrics`` scrapes without a prometheus client dependency.
    Unparseable lines are skipped (a half-written scrape must degrade,
    not crash the control loop)."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        try:
            value = float(m["value"])
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL.findall(m["labels"] or "")}
        out.setdefault(m["name"], []).append((labels, value))
    return out


def sample_value(parsed: Dict[str, List[Tuple[Dict[str, str], float]]],
                 name: str, **labels: str) -> Optional[float]:
    """Sample of ``name`` matching ``labels``: an EXACT label-set match
    wins when one exists, else the first sample whose labels are a
    superset of ``labels`` (None when the series is absent).

    The superset fallback is what lets callers read a known series
    without naming every label — but on its own it returned whichever
    superset rendered FIRST: asking for ``metric(model="lm")`` when
    both ``{model="lm"}`` and ``{model="lm", adapter="a"}`` exist must
    answer the aggregate series, not an arbitrary refinement of it."""
    fallback = None
    for sample_labels, value in parsed.get(name, ()):
        if all(sample_labels.get(k) == str(v)
               for k, v in labels.items()):
            if len(sample_labels) == len(labels):
                return value
            if fallback is None:
                fallback = value
    return fallback


def serve_metrics(port: int, registry: Optional[Registry] = None,
                  host: str = "0.0.0.0", json_routes=None):
    """Start a daemon-thread HTTP server exposing /metrics.

    Returns (httpd, thread); pass port from the daemon's --metrics-port.
    ``json_routes`` maps extra paths to zero-arg callables whose return
    value is served as JSON — how the operator exposes its scheduler
    queue (``/queue``) on the same port the scrape already hits.
    """
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or REGISTRY
    routes = dict(json_routes or {})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path in routes:
                try:
                    # dumps inside the try: a non-serializable payload
                    # must also degrade to the 500 body, not kill the
                    # connection mid-handler.
                    data = _json.dumps(routes[self.path]()).encode()
                except Exception as exc:  # surface, don't kill the server
                    data = _json.dumps({"error": str(exc)}).encode()
                    self.send_response(500)
                else:
                    self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            data = reg.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="metrics-http")
    thread.start()
    return httpd, thread
