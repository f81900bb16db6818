"""Training metrics: step time, throughput, MFU.  A copy of the JAX
package's kubeflow_tpu/runtime/metrics.py (host-only; the port imports
nothing of the JAX package).

The reference had *no* metrics subsystem (SURVEY.md §5: "No Prometheus, no
metrics endpoints"); observability was TensorBoard-or-nothing.  Here the
north-star metrics from BASELINE.md — images(or tokens)/sec/chip, MFU, and
gang-schedule-to-running p50 — are first-party, emitted as structured JSON
lines any scraper (or bench.py) can consume.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import statistics
import sys
import time
from typing import Deque, Dict, List, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Timer:
    """Wall-clock step timer with warmup discard.

    The first steps include one-off start-up (the CUDA context, kernel
    builds, cuBLAS handles); steady-state stats must exclude them or MFU
    is garbage.
    """

    warmup_steps: int = 2
    window: int = 50
    _samples: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=50), repr=False
    )
    _seen: int = 0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._seen += 1
        if self._seen > self.warmup_steps:
            self._samples.append(dt)
        return dt

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self._samples) if self._samples else float("nan")

    @property
    def p50_s(self) -> float:
        return statistics.median(self._samples) if self._samples else float("nan")

    @property
    def steady_samples(self) -> int:
        return len(self._samples)


def mfu(
    flops_per_step: float,
    step_time_s: float,
    n_chips: int,
    peak_flops_per_chip: float,
) -> float:
    """Model FLOPs Utilization: achieved model FLOPs / peak hardware FLOPs.

    ``flops_per_step`` counts the model's useful FLOPs for one optimizer step
    (fwd+bwd, global batch), NOT hardware FLOPs — rematerialisation does not
    inflate MFU.
    """
    if step_time_s <= 0 or n_chips <= 0:
        return float("nan")
    return flops_per_step / (step_time_s * n_chips * peak_flops_per_chip)


@dataclasses.dataclass
class MetricsLogger:
    """Structured metric emission: one JSON object per line.

    Heir (and inversion) of the reference's logging story: operator glog
    flags + test-side GCS log shipping (SURVEY.md §5 "metrics/logging") —
    here the training runtime itself reports.
    """

    stream: object = dataclasses.field(default=None)
    static: Dict[str, object] = dataclasses.field(default_factory=dict)
    history: List[Dict[str, object]] = dataclasses.field(default_factory=list)

    def emit(self, **fields: object) -> Dict[str, object]:
        rec = {"ts": time.time(), **self.static, **fields}
        self.history.append(rec)
        out = self.stream if self.stream is not None else sys.stderr
        print(json.dumps(rec), file=out, flush=True)
        return rec

    def step(
        self,
        step: int,
        step_time_s: float,
        examples_per_step: int,
        *,
        flops_per_step: Optional[float] = None,
        n_chips: int = 1,
        peak_flops_per_chip: Optional[float] = None,
        loss: Optional[float] = None,
        **extra: object,
    ) -> Dict[str, object]:
        fields: Dict[str, object] = {
            "event": "train_step",
            "step": step,
            "step_time_s": round(step_time_s, 6),
            "examples_per_sec": round(examples_per_step / step_time_s, 3)
            if step_time_s > 0 else None,
            "examples_per_sec_per_chip": round(
                examples_per_step / step_time_s / n_chips, 3)
            if step_time_s > 0 else None,
        }
        if loss is not None:
            fields["loss"] = float(loss)
        if flops_per_step and peak_flops_per_chip:
            fields["mfu"] = round(
                mfu(flops_per_step, step_time_s, n_chips, peak_flops_per_chip), 4
            )
        fields.update(extra)
        return self.emit(**fields)
