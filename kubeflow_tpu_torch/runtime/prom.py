"""Minimal metrics registry (counters, gauges, histograms): the part of
the JAX package's kubeflow_tpu/runtime/prom.py that the port sets,
copied (host-only; the port imports nothing of the JAX package): the
supervisor's ``kft_train_*``, the checkpoint manager's
``kft_checkpoint_*`` (runtime/checkpoint.py), the decode engine's
``kft_engine_*`` and the shared ``kft_serving_shed_total`` and
``kft_serving_deadline_expired_total`` (serving/engine.py), and the
trace store's ``kft_trace_*`` (runtime/tracing.py).  The Prometheus
exposition and the /metrics route are not ported yet (ROADMAP queue 1,
item 9).

Usage:
    REGISTRY.counter("kft_requests_total", "...").inc(model="m")
    REGISTRY.gauge("kft_jobs", "...").set(3, phase="Running")
    REGISTRY.histogram("kft_latency_seconds", "...").observe(0.2)
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


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
        """Create a label series at zero counts before it observes."""
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


REGISTRY = Registry()
