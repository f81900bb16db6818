"""Gang scheduler: all-or-nothing admission of jobs onto slice inventory.

The hard part the reference never solved (SURVEY.md §7): it created plain
pods and let the default scheduler place them one by one
(kubeflow/openmpi/workloads.libsonnet:10-26 with an optional
``schedulerName`` param) — partial placement of an MPI gang deadlocked
until timeout.  A gang of GPU hosts joined into one process group makes
partial placement *meaningless*: the gang is one indivisible machine
(the port's copy of kubeflow_tpu/operator/gang.py, stdlib only).  This
scheduler therefore admits a job only when its full slice demand is
free, holds FIFO order per queue (no starvation by smaller later
jobs), and records the gang-schedule-to-running latency that
BASELINE.md tracks as a north-star metric.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from kubeflow_tpu_torch.testing import faults


@dataclasses.dataclass
class SliceClaim:
    job: str
    slice_type: str
    count: int
    admitted_at: float


class GangScheduler:
    """Inventory-based admission over {slice_type: capacity}.

    The inventory abstracts GKE node-pools of GPU gang shapes: capacity is how
    many whole slices of each shape exist.  ``offer`` either admits the
    job (claiming all its slices atomically) or queues it.
    """

    def __init__(self, inventory: Dict[str, int]):
        self._lock = threading.RLock()
        self.capacity = dict(inventory)
        self.claims: Dict[str, SliceClaim] = {}
        self.queue: List[dict] = []  # FIFO of pending offers
        self.metrics: List[dict] = []

    def free(self, slice_type: str) -> int:
        with self._lock:
            used = sum(c.count for c in self.claims.values()
                       if c.slice_type == slice_type)
            return self.capacity.get(slice_type, 0) - used

    def offer(self, job: str, slice_type: str, count: int = 1,
              queue: str = "default") -> bool:
        """Try to admit `job`; returns True if admitted now.

        FIFO per queue: a job behind an unsatisfiable head waits even if
        it would fit — the same head-of-line rule volcano/kueue use by
        default, preventing large-job starvation.
        """
        with self._lock:
            if job in self.claims:
                return True
            entry = {"job": job, "slice_type": slice_type, "count": count,
                     "queue": queue, "enqueued_at": faults.monotonic()}
            if not any(e["job"] == job for e in self.queue):
                self.queue.append(entry)
            self._drain_locked()
            return job in self.claims

    def release(self, job: str) -> None:
        with self._lock:
            self.claims.pop(job, None)
            self.queue = [e for e in self.queue if e["job"] != job]
            self._drain_locked()

    def admitted(self, job: str) -> bool:
        with self._lock:
            return job in self.claims

    def claim_count(self, job: str) -> int:
        """Slices held by ``job``'s live claim (0 when not admitted)."""
        with self._lock:
            claim = self.claims.get(job)
            return claim.count if claim else 0

    def resize(self, job: str, count: int) -> bool:
        """Grow or shrink an existing claim in place (elastic serving
        claims — scheduler/colocate.py).  Atomic like ``offer``: a grow
        succeeds only when the delta fits the free pool right now;
        callers route non-fitting grows through the policy plan (which
        may preempt) instead of retrying here.  A shrink always
        succeeds and immediately re-drains the FIFO so released slices
        backfill pending gangs in the same pass."""
        if count < 1:
            raise ValueError("resize to < 1 slice; use release()")
        with self._lock:
            claim = self.claims.get(job)
            if claim is None:
                return False
            delta = count - claim.count
            if delta > 0 and self.free(claim.slice_type) < delta:
                return False
            claim.count = count
            if delta < 0:
                self._drain_locked()
            return True

    def unsatisfiable(self, job: str) -> bool:
        """True if the job's demand exceeds TOTAL capacity — it can never
        be admitted no matter what finishes.  The reconciler consumes this
        to fail the job (Failed/UnsatisfiableResources) and release it,
        unwedging the per-queue FIFO behind it."""
        with self._lock:
            for e in self.queue:
                if e["job"] == job:
                    return bool(e.get("unsatisfiable"))
            return False

    def position(self, job: str) -> Optional[int]:
        with self._lock:
            for i, e in enumerate(self.queue):
                if e["job"] == job:
                    return i
            return None

    def _drain_locked(self) -> None:
        """Admit queue heads while capacity allows (per-queue FIFO).
        Caller holds ``self._lock`` (the ``_locked`` contract)."""
        blocked_queues = set()
        remaining = []
        for entry in self.queue:
            q = entry["queue"]
            if q in blocked_queues:
                remaining.append(entry)
                continue
            if self.capacity.get(entry["slice_type"], 0) < entry["count"]:
                # Can never fit: fail fast by leaving it queued but flagged.
                entry["unsatisfiable"] = True
                blocked_queues.add(q)
                remaining.append(entry)
                continue
            if self.free(entry["slice_type"]) >= entry["count"]:
                now = faults.monotonic()
                self.claims[entry["job"]] = SliceClaim(
                    job=entry["job"], slice_type=entry["slice_type"],
                    count=entry["count"], admitted_at=now,
                )
                self.metrics.append({
                    "event": "gang_admitted",
                    "job": entry["job"],
                    "queue_wait_s": now - entry["enqueued_at"],
                })
            else:
                blocked_queues.add(q)
                remaining.append(entry)
        self.queue = remaining

    def queue_wait_p50_s(self) -> Optional[float]:
        with self._lock:
            waits = sorted(m["queue_wait_s"] for m in self.metrics)
            if not waits:
                return None
            return waits[len(waits) // 2]


class NodeQuarantine:
    """Failure-domain attribution for gang placement: a node that eats
    repeated ``WorkerFailed`` pods within a sliding window is
    quarantined for a cooldown.

    Gangs are indivisible, so one flapping host kills the WHOLE
    gang every restart — without attribution the job burns its entire
    restart budget on the same bad hardware (the failure mode
    heterogeneity-aware schedulers assume away: Gavel-style policies
    expect jobs that detect bad nodes and restart cheaply).  The
    reconciler notes each failed pod's ``spec.nodeName`` here; once a
    node accumulates ``threshold`` failures inside ``window_s``, it is
    excluded from placement (node anti-affinity on every pod the
    reconciler creates) until ``cooldown_s`` elapses.  All timing is
    on the policy clock (``faults.monotonic``), so flap/cooldown
    scenarios run in microseconds under seeded skew.
    """

    def __init__(self, *, threshold: int = 3, window_s: float = 600.0,
                 cooldown_s: float = 1800.0):
        self._lock = threading.Lock()
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self._failures: Dict[str, Deque[float]] = {}
        self._until: Dict[str, float] = {}

    def note_failure(self, node: str) -> bool:
        """Record one worker failure attributed to ``node``.  Returns
        True exactly when this failure TRIPS the quarantine (the
        caller records the event once, not per failure)."""
        if not node:
            return False  # unscheduled/unattributed pod: nothing to blame
        now = faults.monotonic()
        with self._lock:
            if node in self._until and now < self._until[node]:
                return False  # already quarantined; don't re-trip
            window = self._failures.setdefault(node, deque())
            window.append(now)
            while window and window[0] < now - self.window_s:
                window.popleft()
            if len(window) >= self.threshold:
                self._until[node] = now + self.cooldown_s
                window.clear()
                return True
            return False

    def _prune_locked(self, now: float) -> None:
        for node in [n for n, t in self._until.items() if now >= t]:
            del self._until[node]

    def quarantined(self) -> List[str]:
        """Currently quarantined nodes (cooldown unexpired), sorted —
        what the reconciler excludes from placement and exports as
        ``kft_operator_quarantined_nodes``."""
        now = faults.monotonic()
        with self._lock:
            self._prune_locked(now)
            return sorted(self._until)

    def is_quarantined(self, node: str) -> bool:
        now = faults.monotonic()
        with self._lock:
            self._prune_locked(now)
            return node in self._until
