"""Preemption: victim selection and the anti-livelock rate limiter.

A higher-priority job that cannot fit may evict running lower-priority
work — but eviction is the most expensive verb the control plane has
(a whole gang's progress since its last checkpoint), so the policy
here is deliberately narrow:

  * victims must hold the SAME slice type the preemptor needs (claims
    are per-type; evicting an h100-32 gang frees nothing for an
    h100-8 ask);
  * victims are strictly LOWER priority — an equal-priority job can
    never be evicted, which kills the direct A-evicts-B-evicts-A
    livelock by construction;
  * among eligible victims, evict the lowest priority first and, at
    equal priority, the job holding the FEWEST chips (cheapest restart
    first); stop as soon as enough capacity frees;
  * a whole-cluster rate limit bounds eviction churn: two priority
    tiers flapping (high jobs arriving as fast as lows resume) can
    cost at most ``max_preemptions`` evictions per ``window_s``.

The victim is not killed outright: the reconciler gives it a
``grace_period_s`` checkpoint window (the SIGTERM contract — see
``PreemptionConfig``) and re-enqueues it ``resumable``, so on
re-admission the trainer's ``CheckpointManager.restore_or_init``
continues from the latest saved step instead of step 0.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List

from kubeflow_tpu_torch.testing import faults


@dataclasses.dataclass
class PreemptionConfig:
    """Knobs for the eviction path.

    ``grace_period_s`` is the checkpoint-on-SIGTERM window: the
    reconciler holds the victim in ``Preempting`` (pods alive, claim
    held) for this long before tearing the gang down, so an in-flight
    ``CheckpointManager.save`` can land.  It is a *policy* clock
    (``faults.monotonic``): tests and chaos runs skew it instead of
    sleeping through it.
    """

    enable: bool = True
    grace_period_s: float = 30.0
    # Whole-cluster eviction budget: at most max_preemptions evictions
    # per sliding window_s.
    max_preemptions: int = 4
    window_s: float = 300.0
    # Grace window when the preemptor is a SERVING claim
    # (scheduler/colocate.py): a traffic spike cannot wait out the full
    # training grace, and the victim's checkpoint cadence — not the
    # window — bounds lost work, so serving evictions drain short.
    serving_grace_period_s: float = 5.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreemptionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown preemption config keys {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**d)


def pick_victims(running: List[Any], preemptor: Any,
                 free: int) -> List[Any]:
    """Choose a minimal victim set for ``preemptor`` (a JobView).

    ``running`` are candidate JobViews already filtered to the
    preemptor's slice type and not mid-preemption; ``free`` is the
    currently free slice count of that type.  Returns ``[]`` when no
    lower-priority set can free enough capacity — partial eviction
    would burn checkpoints without unblocking anyone.
    """
    eligible = [v for v in running
                if v.priority_value < preemptor.priority_value]
    # Lowest priority first; cheapest gang (fewest chips) first within
    # a priority tier; stable on enqueue order via sort stability.
    eligible.sort(key=lambda v: (v.priority_value, v.chips))
    victims: List[Any] = []
    freed = free
    for v in eligible:
        if freed >= preemptor.count:
            break
        victims.append(v)
        freed += v.count
    if freed < preemptor.count:
        return []
    return victims


class PreemptionRateLimiter:
    """Sliding-window eviction budget on the skewable policy clock.

    Locked: ``record`` runs on the reconcile loop while ``in_window``
    is read from /queue status requests on HTTP server threads — an
    unlocked prune-and-rebind would drop a recorded eviction and let
    the budget overshoot."""

    def __init__(self, max_preemptions: int = 4, window_s: float = 300.0):
        self.max_preemptions = max(0, int(max_preemptions))
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events: List[float] = []

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        self._events = [t for t in self._events if t > cutoff]

    def allow(self, n: int = 1) -> bool:
        """True when ``n`` more evictions fit the window — the budget
        is per evicted GANG, so a multi-victim wave must fit whole
        (partial eviction frees nothing, see pick_victims)."""
        now = faults.monotonic()
        with self._lock:
            self._prune_locked(now)
            return len(self._events) + n <= self.max_preemptions

    def record(self) -> None:
        now = faults.monotonic()
        with self._lock:
            self._prune_locked(now)
            self._events.append(now)

    def in_window(self) -> int:
        now = faults.monotonic()
        with self._lock:
            self._prune_locked(now)
            return len(self._events)
