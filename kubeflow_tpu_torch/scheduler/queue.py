"""Pending-queue bookkeeping and the ClusterScheduler facade.

The reconcile loop is level-triggered and stateless per pass; the
queue here is the one piece of scheduler state that must PERSIST
across passes — when each job first became pending (fair FIFO
tie-breaks and the queue-wait metric both depend on it surviving the
poll loop), and the counters the ``kft_scheduler_*`` surface exports.

:class:`ClusterScheduler` is what the reconciler consults: it turns
the raw CR list into :class:`~kubeflow_tpu_torch.scheduler.policy.JobView`s,
asks the policy for a :class:`~kubeflow_tpu_torch.scheduler.policy.Plan`,
and owns metrics + the ``queue status`` JSON the CLI renders.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.scheduler import colocate, fuse
from kubeflow_tpu_torch.scheduler.policy import (
    ADMIT,
    PREEMPT,
    JobView,
    Plan,
    SchedulerConfig,
    SchedulingPolicy,
    job_view,
)
from kubeflow_tpu_torch.scheduler.preempt import PreemptionRateLimiter
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

# Queue-wait buckets: gang admission waits are seconds to hours, not
# request latencies.
_WAIT_BUCKETS = (0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 3600.0,
                 14400.0)


@dataclasses.dataclass
class _QueueEntry:
    enqueued_at: float


class SchedulerQueue:
    """Persistent pending-set bookkeeping (enqueue times + waits).

    ``_waits`` is a bounded window of the most recent admissions: the
    all-time distribution lives in the Prometheus histogram; the CLI
    percentiles should reflect the cluster NOW, and an unbounded list
    re-sorted per /queue request would grow for the operator's whole
    life."""

    WAIT_WINDOW = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _QueueEntry] = {}
        self._waits: "collections.deque[float]" = collections.deque(
            maxlen=self.WAIT_WINDOW)

    def touch(self, job: JobView) -> float:
        """Record (or refresh) a pending job; returns its stable
        enqueue time on the policy clock."""
        with self._lock:
            entry = self._entries.get(job.key)
            if entry is None:
                entry = _QueueEntry(enqueued_at=faults.monotonic())
                self._entries[job.key] = entry
            return entry.enqueued_at

    def note_admitted(self, key: str) -> Optional[float]:
        """Pending -> admitted: returns the queue wait (None if the
        job was never seen pending, e.g. admitted on its first pass
        before any plan)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            wait = max(0.0, faults.monotonic() - entry.enqueued_at)
            self._waits.append(wait)
            return wait

    def forget(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def prune(self, live_keys) -> None:
        """Drop entries whose CR vanished (deleted while queued)."""
        live = set(live_keys)
        with self._lock:
            for key in [k for k in self._entries if k not in live]:
                del self._entries[key]

    def wait_of(self, key: str) -> Optional[float]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            return max(0.0, faults.monotonic() - entry.enqueued_at)

    def wait_percentiles(self) -> Dict[str, Optional[float]]:
        with self._lock:
            waits = sorted(self._waits)
        if not waits:
            return {"p50": None, "p99": None}
        return {
            "p50": waits[len(waits) // 2],
            "p99": waits[min(len(waits) - 1,
                             int(len(waits) * 0.99))],
        }

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)


class ClusterScheduler:
    """The policy control plane the reconciler consults each pass.

    Sits ABOVE the :class:`~kubeflow_tpu_torch.operator.gang.GangScheduler`:
    the gang owns inventory accounting and atomic claims; this layer
    decides which offers to make, in what order, and which claims to
    revoke.  Single reconcile-thread discipline: ``plan`` and the
    ``note_*`` callbacks are called from the reconcile loop only;
    ``status()`` may be read from the HTTP status route concurrently.
    """

    # Pending phases from the policy's standpoint; anything admitted
    # in the gang is "running" regardless of pod readiness.
    _TERMINAL = ("Succeeded", "Failed")

    def __init__(self, gang, config: Optional[SchedulerConfig] = None):
        self.gang = gang
        self.config = config or SchedulerConfig()
        self.limiter = PreemptionRateLimiter(
            self.config.preemption.max_preemptions,
            self.config.preemption.window_s)
        self.policy = SchedulingPolicy(self.config, self.limiter)
        self.queue = SchedulerQueue()
        self._lock = threading.Lock()
        self._last_plan = Plan()
        self._last_views: Dict[str, JobView] = {}
        self._queue_warned: set = set()
        self._counters = {"admitted": 0, "backfilled": 0,
                          "preempted": 0, "resumed": 0}

    # -- the reconcile-loop surface ---------------------------------------

    def plan(self, cr_objs: List[dict]) -> Plan:
        """Build this pass's admission plan from the raw CR list.

        Unparseable specs are skipped here — the reconciler fails them
        with InvalidSpec through its own error path; the policy must
        not let one bad CR wedge the whole plan (hook site
        ``scheduler.admit`` lets the fault harness do exactly that on
        purpose).
        """
        # Per-pass trace span: one single-span trace per plan pass
        # (tail-sampled like everything else; a raising pass ends with
        # status "error" and is always retained), annotated with the
        # verdict counts — the operator-side analogue of the serving
        # path's request spans.
        span = tracing.start_span("scheduler.plan")
        try:
            plan = self._plan_inner(cr_objs)
        except BaseException:
            span.end(status="error")
            raise
        counts: Dict[str, int] = {}
        for decision in plan.decisions.values():
            counts[decision.action] = counts.get(decision.action, 0) + 1
        span.end(status="ok", **counts)
        return plan

    def _plan_inner(self, cr_objs: List[dict]) -> Plan:
        faults.fire("scheduler.admit")
        pending: List[JobView] = []
        running: List[JobView] = []
        views: Dict[str, JobView] = {}
        for cr_obj in cr_objs:
            if cr_obj.get("kind") != crd.KIND:
                continue
            try:
                spec = crd.TPUJobSpec.from_custom_resource(cr_obj)
            except ValueError:
                continue
            if spec.queue and spec.queue not in self._queue_warned:
                # The gang's per-queue FIFO lanes are superseded here:
                # ordering comes from tenant/priority labels.  Loud
                # once per lane name, because a user relying on
                # `queue:` separation gets different admission order
                # under the (default-on) policy layer.
                self._queue_warned.add(spec.queue)
                log.warning(
                    "TPUJob %s/%s sets spec.queue=%r, which the "
                    "multi-tenant scheduler ignores — use the %s / %s "
                    "labels (or run the operator with --no-scheduler "
                    "for gang-FIFO queue lanes)",
                    spec.namespace, spec.name, spec.queue,
                    "kubeflow-tpu.org/tenant",
                    "kubeflow-tpu.org/priority")
            view = job_view(cr_obj, spec, self.config)
            views[view.key] = view
            if view.phase in self._TERMINAL:
                continue
            if self.gang.admitted(view.key) or (
                    view.fused_gang
                    and self.gang.admitted(view.fused_gang)):
                running.append(view)
            else:
                view.fused_gang = ""   # stale stamp: gang released
                view.enqueued_at = self.queue.touch(view)
                pending.append(view)
        # Train/serve colocation: split admitted serving claims into a
        # held base view plus a pending grow-delta view BEFORE the
        # prune (the grow key's queue entry must survive it), so the
        # policy arbitrates the increment as ordinary high-priority
        # demand.
        pending, running, grow_views, serving_keys = colocate.fold(
            pending, running, self.gang, self.queue)
        self.queue.prune([v.key for v in pending])
        # Horizontal fusion: fold compatible pending singletons into
        # one gang view, regroup admitted fused members back into
        # theirs, then mirror the gang verdicts onto member keys so
        # the reconciler drives ordinary member CRs.
        pending, fused_pending = fuse.fold_pending(pending, self.gang)
        running, fused_running = fuse.fold_running(running, self.gang)
        free = {t: self.gang.free(t) for t in self.gang.capacity}
        plan = self.policy.plan(pending, running, free,
                                dict(self.gang.capacity))
        # Merge grow verdicts onto base keys and stamp the short
        # serving grace BEFORE mirroring, so a fused victim's members
        # inherit the override.
        colocated = colocate.finalize(
            plan, grow_views, serving_keys,
            self.config.preemption.serving_grace_period_s)
        if colocated:
            from kubeflow_tpu_torch.runtime.prom import REGISTRY

            REGISTRY.counter(
                "kft_scheduler_colocation_preemptions_total",
                "training gangs evicted for serving claims",
            ).inc(colocated)
        fuse.mirror_decisions(plan, fused_pending + fused_running)
        with self._lock:
            self._last_plan = plan
            self._last_views = views
        self._export_metrics(pending, running,
                             fused_pending + fused_running)
        return plan

    def note_admitted(self, key: str, backfilled: bool = False,
                      resumed: bool = False) -> None:
        wait = self.queue.note_admitted(key)
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        # View lookup joins the counter update under the lock:
        # plan() REBINDS _last_views under it, and the tenant label
        # must come from the same snapshot the caller's plan produced
        # (status() reads both under this lock too).
        with self._lock:
            view = self._last_views.get(key)
            self._counters["admitted"] += 1
            if backfilled:
                self._counters["backfilled"] += 1
            if resumed:
                self._counters["resumed"] += 1
        tenant = view.tenant if view else "default"
        REGISTRY.counter(
            "kft_scheduler_admitted_total",
            "jobs admitted through the policy layer").inc(tenant=tenant)
        if backfilled:
            REGISTRY.counter(
                "kft_scheduler_backfills_total",
                "jobs admitted ahead of blocked higher-priority work "
                "(provably no ETA delay)").inc(tenant=tenant)
        if resumed:
            REGISTRY.counter(
                "kft_scheduler_resumes_total",
                "preempted jobs re-admitted to resume from their "
                "latest checkpoint").inc(tenant=tenant)
        if wait is not None:
            REGISTRY.histogram(
                "kft_scheduler_queue_wait_seconds",
                "pending-to-admitted wait through the policy queue",
                buckets=_WAIT_BUCKETS).observe(wait)

    def note_preempted(self, key: str) -> None:
        with self._lock:
            view = self._last_views.get(key)
            self._counters["preempted"] += 1
        tenant = view.tenant if view else "default"
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        REGISTRY.counter(
            "kft_scheduler_preemptions_total",
            "gangs evicted for higher-priority work").inc(tenant=tenant)

    def forget(self, key: str) -> None:
        """Job reached a terminal phase (or its CR vanished)."""
        self.queue.forget(key)

    # -- observability -----------------------------------------------------

    def _export_metrics(self, pending: List[JobView],
                        running: List[JobView],
                        fused: List[JobView] = ()) -> None:
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        REGISTRY.gauge(
            "kft_scheduler_fused_gangs",
            "fused training gangs in the current plan "
            "(pending folds + admitted)").set(float(len(fused)))
        REGISTRY.gauge(
            "kft_scheduler_fused_members",
            "member jobs folded into fused gangs in the current "
            "plan").set(float(sum(len(f.members) for f in fused)))

        claim = REGISTRY.gauge(
            "kft_scheduler_serving_claim_chips",
            "chips held by admitted serving claims")
        for labels in claim.labelsets():
            claim.set(0, **labels)
        for job in running:
            # Post-fold base views carry the HELD count (what the
            # gang claim actually bills), not the CR's desired count.
            if job.workload == colocate.WORKLOAD_SERVING:
                claim.set(job.chips, claim=job.key)

        depth = REGISTRY.gauge(
            "kft_scheduler_queue_depth",
            "pending TPUJobs by tenant and priority class")
        by_bucket: Dict[tuple, int] = {}
        for job in pending:
            k = (job.tenant, job.priority)
            by_bucket[k] = by_bucket.get(k, 0) + 1
        # Zero stale series: a bucket that drained must scrape as 0,
        # not hold its last value.
        for labels in depth.labelsets():
            depth.set(0, **labels)
        for (tenant, priority), n in by_bucket.items():
            depth.set(n, tenant=tenant, priority=priority)

        used = REGISTRY.gauge(
            "kft_scheduler_quota_used_chips",
            "admitted chips by tenant and slice type")
        limit = REGISTRY.gauge(
            "kft_scheduler_quota_chips",
            "configured quota ceiling by tenant and slice type")
        usage = SchedulingPolicy._usage(running)
        for labels in used.labelsets():
            used.set(0, **labels)
        for (tenant, slice_type), chips in usage.items():
            used.set(chips, tenant=tenant, slice_type=slice_type)
        for tenant, per_type in self.config.quotas.items():
            for slice_type, chips in per_type.items():
                limit.set(chips, tenant=tenant, slice_type=slice_type)

    def status(self) -> dict:
        """The ``kubeflow-tpu queue status`` payload: every live job
        with its plan verdict, plus quota utilization and waits."""
        with self._lock:
            plan = self._last_plan
            views = dict(self._last_views)
        position = {key: i for i, key in enumerate(plan.order)}
        jobs: List[dict] = []
        for key, view in sorted(
                views.items(),
                key=lambda kv: (position.get(kv[0], len(position)),
                                kv[0])):
            if view.phase in self._TERMINAL:
                continue
            decision = plan.decisions.get(key)
            admitted = self.gang.admitted(key) or (
                view.fused_gang and self.gang.admitted(view.fused_gang))
            if admitted:
                state = ("Preempting"
                         if decision is not None
                         and decision.action == PREEMPT
                         else "Admitted")
            elif decision is None:
                state = "Pending"
            elif decision.action == ADMIT:
                state = "Admitting"
            else:
                state = decision.reason or "Pending"
            wait = self.queue.wait_of(key)
            # A fused member's chips column shows its SHARE of the
            # gang slice — the quantity its tenant is billed.
            chips = (view.chips / view.fused_members
                     if view.fused_members else view.chips)
            jobs.append({
                "job": key,
                "kind": ("serving-claim"
                         if view.workload == colocate.WORKLOAD_SERVING
                         else "train"),
                "tenant": view.tenant,
                "priority": view.priority,
                "slices": f"{view.count}x{view.slice_type}",
                "chips": chips,
                "state": state,
                "detail": (decision.message if decision else ""),
                "position": position.get(key),
                "wait_s": round(wait, 3) if wait is not None else None,
                "resumable": view.resumable,
                "preemptions": view.preemptions,
                "members": view.fused_members or None,
            })
        quotas = []
        # Fused-aware usage over LIVE claims (a job admitted during
        # the current sweep was still pending at plan time, so a
        # plan-time snapshot would under-bill): each fused member
        # bills its tenant its SHARE of the gang slice, a singleton
        # its whole gang.
        usage: Dict[Tuple[str, str], float] = {}
        for view in views.values():
            if view.phase in self._TERMINAL:
                continue
            if not (self.gang.admitted(view.key) or
                    (view.fused_gang and
                     self.gang.admitted(view.fused_gang))):
                continue
            share = (view.chips / view.fused_members
                     if view.fused_members else view.chips)
            slot = (view.tenant, view.slice_type)
            usage[slot] = usage.get(slot, 0) + share
        for tenant, per_type in sorted(self.config.quotas.items()):
            for slice_type, chips in sorted(per_type.items()):
                quotas.append({
                    "tenant": tenant, "slice_type": slice_type,
                    "used_chips": usage.get((tenant, slice_type), 0),
                    "quota_chips": chips})
        with self._lock:
            counters = dict(self._counters)
        return {
            "jobs": jobs,
            "quotas": quotas,
            "queue_wait": self.queue.wait_percentiles(),
            "counters": counters,
            "preemptions_in_window": self.limiter.in_window(),
            "pool": self.pool_status(),
        }

    def pool_status(self) -> dict:
        """Combined-pool chip accounting (train + serve on ONE
        inventory) — the fleet status footer's data source, stamped
        onto claim CR status by the reconciler each grant."""
        from kubeflow_tpu_torch.runtime.topology import parse_slice_type

        capacity = used = 0
        per_type: Dict[str, int] = {}
        for slice_type, count in self.gang.capacity.items():
            try:
                per = parse_slice_type(slice_type).chips
            except ValueError:
                per = 0
            per_type[slice_type] = per
            capacity += per * count
            used += per * (count - self.gang.free(slice_type))
        with self._lock:
            views = dict(self._last_views)
        serving = 0
        for key, view in views.items():
            if view.workload != colocate.WORKLOAD_SERVING:
                continue
            held = self.gang.claim_count(key)
            if held:
                serving += per_type.get(view.slice_type, 0) * held
        return {
            "capacity_chips": capacity,
            "used_chips": used,
            "free_chips": capacity - used,
            "serving_chips": serving,
            "training_chips": used - serving,
        }
