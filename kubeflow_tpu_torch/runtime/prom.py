"""Minimal metrics registry (counters and gauges): the part of the JAX
package's kubeflow_tpu/runtime/prom.py that the training side sets,
copied (host-only; the port imports nothing of the JAX package): the
supervisor's ``kft_train_*`` and the checkpoint manager's
``kft_checkpoint_saves_total``, ``kft_checkpoint_failures_total`` and
``kft_checkpoint_verify_failures_total`` (runtime/checkpoint.py).  The
Prometheus exposition and the /metrics server come with the serving
surface (ROADMAP queue 1, item 3).

Usage:
    REGISTRY.counter("kft_requests_total", "...").inc(model="m")
    REGISTRY.gauge("kft_jobs", "...").set(3, phase="Running")
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


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


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help_: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"{name} already registered as {m.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)


REGISTRY = Registry()
