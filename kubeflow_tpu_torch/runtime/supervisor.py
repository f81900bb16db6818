"""Training supervisor: bounded restart-with-backoff around Trainer.fit.

A copy of the JAX package's kubeflow_tpu/runtime/supervisor.py (host-only;
the port imports nothing of the JAX package), with the two exception types
it catches copied beside it: ``DataError`` (the JAX package's
data/loader.py) and ``CheckpointError`` (its runtime/checkpoint.py).

  - ``run()`` calls ``Trainer.fit`` and, on a restartable fault
    (:data:`RESTARTABLE`: injected step faults, typed data-pipeline
    exhaustion, a failed async checkpoint save, a detected stall),
    restarts it — bounded by ``max_restarts``, with capped jittered
    backoff on the policy clock.  The port's trainer has no checkpoint
    manager yet (ROADMAP queue 1, item 6), so a restart starts again
    from init, as the JAX supervisor does without one.
  - a heartbeat is stamped on ``faults.monotonic()`` at every fit call
    boundary (Trainer.fit's ``on_step``), and a step-time watchdog
    compares the CURRENT dispatch age against a rolling window of
    recent call-boundary gaps: when the age exceeds
    ``stall_factor`` x the window median, the stall is flagged
    (``kft_train_stalled`` gauge, ``kft_train_heartbeat_age_seconds``)
    and the next call boundary raises :class:`StallDetected`, which the
    restart loop treats like any other fault.

All timing here is policy (restart backoff, stall deadlines, heartbeat
age) and reads ``faults.monotonic()``, so seeded clock-skew scenarios
exercise every deadline in microseconds of wall time.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
from collections import deque
from typing import Any, Callable, Deque, Iterable, List, Optional, Tuple

from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)


class DataError(RuntimeError):
    """The input pipeline failed past its transient-retry budget: the
    typed signal the supervisor converts into a supervised restart —
    distinguishable from a programming error, which propagates raw."""


class CheckpointError(RuntimeError):
    """A background async checkpoint save failed; the supervisor restarts
    from the last verified step instead of training on past a dead
    checkpoint path."""


class StallDetected(RuntimeError):
    """The step-time watchdog flagged the current dispatch as stalled;
    raised at the next call boundary to trigger a supervised restart."""


class RestartBudgetExceeded(RuntimeError):
    """The supervisor spent its restart budget; the last fault is the
    ``__cause__``."""


# Faults the supervisor restarts on: a closed, typed set.  Everything
# else (assertion bugs, OOM, keyboard interrupt) propagates — restarting
# on arbitrary exceptions would mask real defects.
RESTARTABLE: Tuple[type, ...] = (
    faults.FaultInjected, DataError, CheckpointError, StallDetected)


@dataclasses.dataclass
class TrainSupervisor:
    """Crash-safe wrapper around one Trainer's ``fit``.

    trainer: a :class:`~kubeflow_tpu_torch.runtime.train.Trainer`.
    max_restarts: restart budget across the whole ``run()`` call;
      exceeding it raises :class:`RestartBudgetExceeded` from the last
      fault.
    backoff_s / backoff_max_s: capped jittered exponential backoff
      between restart attempts, waited on the policy clock.
    stall_factor: current dispatch age > stall_factor x the rolling
      median of recent call-boundary gaps => stall.  The window needs
      ``min_window`` samples before any stall verdict, and the
      threshold never drops below ``min_stall_s``.
    heartbeat_s: watchdog poll period (also the refresh cadence of
      ``kft_train_heartbeat_age_seconds``).
    """

    trainer: Any
    max_restarts: int = 3
    backoff_s: float = 1.0
    backoff_max_s: float = 30.0
    stall_factor: float = 10.0
    min_stall_s: float = 1.0
    heartbeat_s: float = 5.0
    window: int = 32
    min_window: int = 5
    restartable: Tuple[type, ...] = RESTARTABLE

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._beat: Optional[float] = None
        self._gaps: Deque[float] = deque(maxlen=self.window)
        self._stalled = False
        self._restarts = 0
        self._steps: List[int] = []
        self._rng = random.Random()
        self._age_gauge = REGISTRY.gauge(
            "kft_train_heartbeat_age_seconds",
            "policy-clock age of the last train call boundary")
        self._stalled_gauge = REGISTRY.gauge(
            "kft_train_stalled",
            "1 while the current dispatch exceeds the stall threshold")

    # -- observability -----------------------------------------------------

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    def stats(self) -> dict:
        now = faults.monotonic()
        with self._lock:
            return {
                "restarts": self._restarts,
                "stalled": self._stalled,
                "heartbeat_age_s": (now - self._beat
                                    if self._beat is not None else None),
                "window": len(self._gaps),
                "last_step": self._steps[-1] if self._steps else None,
            }

    # -- heartbeat + watchdog ----------------------------------------------

    def _stall_threshold_locked(self) -> Optional[float]:
        if len(self._gaps) < self.min_window:
            return None
        ordered = sorted(self._gaps)
        median = ordered[len(ordered) // 2]
        return max(self.min_stall_s, self.stall_factor * median)

    def _on_step(self, step: int,
                 user_cb: Optional[Callable[[int], None]]) -> None:
        """Trainer.fit call boundary: stamp the heartbeat, record the
        gap, and raise if the watchdog flagged the dispatch that just
        returned."""
        now = faults.monotonic()
        with self._lock:
            if self._beat is not None:
                gap = now - self._beat
                threshold = self._stall_threshold_locked()
                if threshold is not None and gap > threshold:
                    self._stalled = True
                else:
                    self._gaps.append(gap)
            self._beat = now
            self._steps.append(step)
            stalled = self._stalled
        self._age_gauge.set(0.0)
        if user_cb is not None:
            user_cb(step)
        if stalled:
            raise StallDetected(
                f"dispatch before step {step} exceeded the stall "
                f"threshold (factor {self.stall_factor} over the "
                f"rolling window)")

    def _watchdog(self, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            now = faults.monotonic()
            with self._lock:
                if self._beat is None:
                    continue
                age = now - self._beat
                threshold = self._stall_threshold_locked()
                if threshold is not None and age > threshold:
                    self._stalled = True
                stalled = self._stalled
            self._age_gauge.set(age)
            self._stalled_gauge.set(1.0 if stalled else 0.0)

    # -- restart loop ------------------------------------------------------

    def _backoff(self, attempt: int) -> None:
        faults.policy_backoff(attempt, self.backoff_s,
                              self.backoff_max_s, self._rng)

    def run(self, data_factory: Callable[[], Iterable[Any]],
            num_steps: int, *,
            on_step: Optional[Callable[[int], None]] = None,
            **fit_kwargs) -> Any:
        """Supervised ``trainer.fit(data_factory(), num_steps, ...)``.

        ``data_factory`` builds a FRESH data iterable per attempt.
        ``on_step`` chains after the supervisor's heartbeat callback.
        Returns the final TrainState.
        """
        restarts_total = REGISTRY.counter(
            "kft_train_restarts_total",
            "supervised in-process training restarts")
        stop = threading.Event()
        watchdog = threading.Thread(
            target=self._watchdog, args=(stop,),
            name="kft-train-watchdog", daemon=True)
        watchdog.start()
        boundary = lambda step: self._on_step(step, on_step)  # noqa: E731
        try:
            while True:
                with self._lock:
                    self._stalled = False
                    self._gaps.clear()
                    self._beat = faults.monotonic()
                self._stalled_gauge.set(0.0)
                try:
                    return self.trainer.fit(
                        data_factory(), num_steps,
                        on_step=boundary, **fit_kwargs)
                except self.restartable as e:
                    with self._lock:
                        self._restarts += 1
                        attempt = self._restarts
                    reason = ("stall" if isinstance(e, StallDetected)
                              else "data" if isinstance(e, DataError)
                              else "checkpoint"
                              if isinstance(e, CheckpointError)
                              else "step")
                    if attempt > self.max_restarts:
                        raise RestartBudgetExceeded(
                            f"restart budget ({self.max_restarts}) "
                            f"spent; last fault: {e}") from e
                    restarts_total.inc(reason=reason)
                    log.warning(
                        "supervised restart %d/%d after %s fault: %s",
                        attempt, self.max_restarts, reason, e)
                    # Clear the failed attempt's heartbeat + verdict
                    # BEFORE the backoff, so the watchdog never reads a
                    # stale beat against an old window.
                    with self._lock:
                        self._beat = None
                        self._gaps.clear()
                        self._stalled = False
                    self._stalled_gauge.set(0.0)
                    self._age_gauge.set(0.0)
                    self._backoff(attempt)
        finally:
            stop.set()
            watchdog.join(timeout=5.0)

    @property
    def steps_seen(self) -> List[int]:
        """Call-boundary step indices across every attempt, in order."""
        with self._lock:
            return list(self._steps)
