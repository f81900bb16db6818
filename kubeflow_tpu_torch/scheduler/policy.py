"""Admission policy: quotas, weighted-fair ordering, priority classes,
and conservative backfill.

Every reconcile pass the policy is handed the pending and admitted
jobs plus a free-inventory snapshot and produces a :class:`Plan` — a
pure function of its inputs (the single-threaded reconcile loop owns
the only mutation window), so every decision is unit-testable without
a cluster and replayable from a dump of its inputs.

Ordering discipline (the Gavel shape — policy above the placer):

  1. strict priority classes: a ``high`` job is considered before any
     ``normal`` job, regardless of tenants or arrival order;
  2. weighted fair sharing within a class: among equal-priority jobs
     the next candidate belongs to the tenant with the least admitted
     chips *per unit weight* (recomputed as the plan simulates
     admissions, so one greedy tenant interleaves rather than drains
     its whole backlog first);
  3. FIFO within a tenant at equal priority (stable tie-break on
     enqueue time).

Quota: per-tenant, per-slice-type admitted-chip caps.  A quota-blocked
job is SKIPPED — it neither consumes capacity nor blocks jobs behind
it (its tenant chose its backlog shape; making others pay for it is
exactly the head-of-line starvation this layer exists to remove).

Backfill (conservative, provable): a job may be admitted ahead of a
capacity-blocked higher-priority job only when doing so provably
cannot delay that job's earliest start.  Without trusted run-time
estimates the only provable cases are (a) the jumper asks for a
DIFFERENT slice type (disjoint pools: claiming h100-8 frees/starves
no h100-32), or (b) after the jump the blocked job's demand still fits the
remaining free pool (it was blocked by ordering, not capacity).  A
same-type jump past a capacity-blocked job is always denied: the
blocked job's ETA depends on released slices, and the jumper's claim
would join the set it must wait on.  EASY-style backfill with
durations is a policy extension point, not the default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.scheduler.preempt import (
    PreemptionConfig,
    PreemptionRateLimiter,
    pick_victims,
)
from kubeflow_tpu_torch.testing import faults

# CR metadata labels the policy reads (same group as the job labels
# the reconciler stamps on pods).
LABEL_TENANT = "kubeflow-tpu.org/tenant"
LABEL_PRIORITY = "kubeflow-tpu.org/priority"
# Opt-in marker for horizontal fusion (scheduler/fuse.py): singleton
# jobs sharing a family value assert same-architecture compatibility.
LABEL_FUSE_FAMILY = "kubeflow-tpu.org/fuse-family"
# Workload class of a CR: "" (ordinary training) or the values
# scheduler/colocate.py stamps on serving claims / prepull pods.
# Lives HERE so colocate can import it without policy ever importing
# colocate (one-way dependency).
LABEL_WORKLOAD = "kubeflow-tpu.org/workload"

DEFAULT_TENANT = "default"
DEFAULT_PRIORITY = "normal"
DEFAULT_PRIORITY_CLASSES = {"low": 0, "normal": 100, "high": 1000}

# Decision actions.
ADMIT = "admit"
WAIT = "wait"
PREEMPT = "preempt"
UNSATISFIABLE = "unsatisfiable"


@dataclasses.dataclass
class JobView:
    """One TPUJob as the policy sees it for a single plan pass."""

    key: str                 # namespace/name
    tenant: str
    priority: str            # class name (label value)
    priority_value: int
    slice_type: str
    count: int               # whole slices demanded
    chips: int               # total chips = slice chips * count
    phase: str = ""
    enqueued_at: float = 0.0
    resumable: bool = False
    preemptions: int = 0
    # Horizontal fusion (scheduler/fuse.py): ``family`` is the CR's
    # opt-in label; a FUSED view carries its member views in
    # ``members`` (then ``chips`` is the whole gang's slice, billed
    # per-member by :func:`tenant_shares`); a MEMBER view carries the
    # gang it belongs to in ``fused_gang`` plus the member count for
    # status rendering.
    family: str = ""
    members: Tuple["JobView", ...] = ()
    fused_gang: str = ""
    fused_members: int = 0
    # Workload class (scheduler/colocate.py): "serving" marks a
    # ServingClaim riding the TPUJob shape; "" is ordinary training.
    workload: str = ""


def tenant_shares(job: JobView) -> List[Tuple[str, float]]:
    """(tenant, chips) pairs a view bills against quota/fair-share.

    THE fused fair-share rule: a fused gang charges each member's
    tenant its per-member share of the slice — never one tenant for
    the whole gang.  Singletons bill themselves in full."""
    if job.members:
        share = job.chips / len(job.members)
        return [(m.tenant, share) for m in job.members]
    return [(job.tenant, job.chips)]


@dataclasses.dataclass
class SchedulerConfig:
    """Policy configuration, loadable from the operator's controller
    ConfigMap (``scheduler`` key) — see ``from_dict`` for the wire
    shape."""

    # tenant -> {slice_type -> max admitted chips}.  Missing tenant or
    # slice type = unlimited.
    quotas: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # tenant -> fair-share weight (default 1.0).
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    priority_classes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PRIORITY_CLASSES))
    enable_backfill: bool = True
    preemption: PreemptionConfig = dataclasses.field(
        default_factory=PreemptionConfig)

    def priority_value(self, name: str) -> int:
        """Unknown class names sort as the default class rather than
        erroring: a typo'd label must degrade a job's priority, not
        wedge the whole admission plan."""
        if name in self.priority_classes:
            return self.priority_classes[name]
        return self.priority_classes.get(DEFAULT_PRIORITY, 0)

    def weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, 1.0))
        return w if w > 0 else 1.0

    def quota_chips(self, tenant: str, slice_type: str) -> Optional[int]:
        per_type = self.quotas.get(tenant)
        if per_type is None:
            return None
        value = per_type.get(slice_type)
        return None if value is None else int(value)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SchedulerConfig":
        """Wire shape (operator ConfigMap ``scheduler`` key)::

            {"quotas": {"team-a": {"h100-8": 16}},
             "weights": {"team-a": 3.0},
             "priorityClasses": {"low": 0, "normal": 100, "high": 1000},
             "enableBackfill": true,
             "preemption": {"grace_period_s": 30,
                            "max_preemptions": 4, "window_s": 300}}
        """
        d = dict(d)
        preempt_cfg = d.pop("preemption", None)
        kwargs: Dict[str, Any] = {}
        aliases = {"priorityClasses": "priority_classes",
                   "enableBackfill": "enable_backfill"}
        for key, value in d.items():
            name = aliases.get(key, key)
            if name not in {f.name for f in dataclasses.fields(cls)}:
                raise ValueError(f"unknown scheduler config key {key!r}")
            kwargs[name] = value
        if "quotas" in kwargs:
            kwargs["quotas"] = {
                tenant: {st: int(n) for st, n in per_type.items()}
                for tenant, per_type in kwargs["quotas"].items()}
        if "weights" in kwargs:
            kwargs["weights"] = {t: float(w)
                                 for t, w in kwargs["weights"].items()}
        if "priority_classes" in kwargs:
            kwargs["priority_classes"] = {
                n: int(v) for n, v in kwargs["priority_classes"].items()}
        cfg = cls(**kwargs)
        if preempt_cfg is not None:
            cfg.preemption = PreemptionConfig.from_dict(preempt_cfg)
        return cfg


@dataclasses.dataclass
class Decision:
    action: str              # admit | wait | preempt | unsatisfiable
    reason: str = ""
    message: str = ""
    backfilled: bool = False
    preemptor: str = ""      # preempt decisions: who the slices go to
    # Mirrored member decisions (scheduler/fuse.py): the gang claim key
    # this member's admission rides on, every member key in the gang,
    # and whether THIS member leads pod materialization/teardown.
    fused_gang: str = ""
    fused_members: Tuple[str, ...] = ()
    fused_leader: bool = False
    # Grace-window override (scheduler/colocate.py): >= 0 replaces the
    # config grace_period_s for THIS victim — serving claims evict on
    # the short serving grace so cold-start overlaps the drain.
    grace_s: float = -1.0


@dataclasses.dataclass
class Plan:
    """One pass's verdicts.  ``order`` is the policy's consideration
    order over pending jobs — the reconciler offers admissions in this
    order so gang claims land exactly as simulated."""

    order: List[str] = dataclasses.field(default_factory=list)
    decisions: Dict[str, Decision] = dataclasses.field(
        default_factory=dict)
    preemptions: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)   # (victim_key, preemptor_key)


def job_view(cr_obj: dict, spec: Any, config: SchedulerConfig) -> JobView:
    """Build the policy's view of one CR (spec already parsed)."""
    meta = cr_obj.get("metadata", {})
    labels = meta.get("labels") or {}
    status = cr_obj.get("status", {}) or {}
    tenant = labels.get(LABEL_TENANT, DEFAULT_TENANT)
    priority = labels.get(LABEL_PRIORITY, DEFAULT_PRIORITY)
    return JobView(
        key=f"{spec.namespace}/{spec.name}",
        tenant=tenant,
        priority=priority,
        priority_value=config.priority_value(priority),
        slice_type=spec.slice_type,
        count=spec.num_slices,
        chips=spec.num_devices,
        phase=status.get("phase", ""),
        resumable=bool(status.get("resumable")),
        preemptions=int(status.get("preemptions", 0)),
        family=labels.get(LABEL_FUSE_FAMILY, ""),
        fused_gang=str(status.get("fusedGang") or ""),
        fused_members=int(status.get("fusedMembers", 0) or 0),
        workload=labels.get(LABEL_WORKLOAD, ""),
    )


class SchedulingPolicy:
    def __init__(self, config: Optional[SchedulerConfig] = None,
                 limiter: Optional[PreemptionRateLimiter] = None):
        self.config = config or SchedulerConfig()
        self.limiter = limiter or PreemptionRateLimiter(
            self.config.preemption.max_preemptions,
            self.config.preemption.window_s)

    # -- plan --------------------------------------------------------------

    def plan(self, pending: List[JobView], running: List[JobView],
             free: Dict[str, int], capacity: Dict[str, int]) -> Plan:
        """Simulate one admission pass over a snapshot.

        ``running`` holds every job with a live gang claim, including
        those already mid-preemption (phase Preempting) — their claims
        still count against quota and inventory until torn down.
        """
        plan = Plan()
        free = dict(free)
        usage = self._usage(running)
        tenant_chips: Dict[str, float] = {}
        for job in running:
            for tenant, share in tenant_shares(job):
                tenant_chips[tenant] = \
                    tenant_chips.get(tenant, 0) + share

        # Claims already being torn down: capacity that will free
        # without any new eviction, per slice type.
        preempting_counts: Dict[str, int] = {}
        for job in running:
            if job.phase == "Preempting":
                preempting_counts[job.slice_type] = \
                    preempting_counts.get(job.slice_type, 0) + job.count
                plan.decisions[job.key] = Decision(
                    action=PREEMPT, reason="Preempting",
                    message="eviction in progress")

        blocked: List[JobView] = []   # capacity-blocked, in pick order
        candidates = list(pending)
        while candidates:
            job = self._pick(candidates, tenant_chips)
            candidates.remove(job)
            plan.order.append(job.key)

            if capacity.get(job.slice_type, 0) < job.count:
                plan.decisions[job.key] = Decision(
                    action=UNSATISFIABLE, reason="UnsatisfiableResources",
                    message=(f"requires {job.count} x {job.slice_type} "
                             f"but cluster capacity is "
                             f"{capacity.get(job.slice_type, 0)}"))
                continue

            # Quota checks bill per tenant SHARE: a singleton is its own
            # whole demand; a fused gang charges each member's tenant
            # chips/len(members) (tenant_shares).
            verdict = None
            for tenant, share in tenant_shares(job):
                quota = self.config.quota_chips(tenant, job.slice_type)
                if quota is None:
                    continue
                used = usage.get((tenant, job.slice_type), 0)
                if share > quota:
                    # Exceeds the tenant's ceiling even with NOTHING
                    # else admitted: it can never run under this
                    # config — terminal, like the capacity-
                    # unsatisfiable path, not a permanent queue
                    # squatter.
                    verdict = Decision(
                        action=UNSATISFIABLE, reason="QuotaUnsatisfiable",
                        message=(f"requires {share:g} chips of "
                                 f"{job.slice_type} but tenant "
                                 f"{tenant!r} quota is {quota}"))
                    break
                if used + share > quota:
                    # Skipped, not blocking: quota is the tenant's own
                    # ceiling, and a capped tenant must not wedge
                    # others.
                    verdict = Decision(
                        action=WAIT, reason="QuotaExceeded",
                        message=(f"tenant {tenant!r} at "
                                 f"{used:g}/{quota} chips of "
                                 f"{job.slice_type}"))
                    break
            if verdict is not None:
                plan.decisions[job.key] = verdict
                continue

            fits = free.get(job.slice_type, 0) >= job.count
            if fits and blocked and not self.config.enable_backfill:
                plan.decisions[job.key] = Decision(
                    action=WAIT, reason="BackfillDenied",
                    message="backfill disabled; waiting behind the "
                            "blocked queue head")
                blocked.append(job)
                continue
            if fits and not self._would_delay(job, blocked, free):
                plan.decisions[job.key] = Decision(
                    action=ADMIT, reason="Admitted",
                    backfilled=bool(blocked))
                free[job.slice_type] -= job.count
                for tenant, share in tenant_shares(job):
                    usage[(tenant, job.slice_type)] = \
                        usage.get((tenant, job.slice_type), 0) + share
                    tenant_chips[tenant] = \
                        tenant_chips.get(tenant, 0) + share
                continue

            if fits:
                decision = Decision(
                    action=WAIT, reason="BackfillDenied",
                    message=("admission now could delay a queued "
                             "higher-priority job"))
            else:
                decision = Decision(
                    action=WAIT, reason="WaitingForSlices",
                    message=(f"{free.get(job.slice_type, 0)} free of "
                             f"{job.count} x {job.slice_type} needed"))
            plan.decisions[job.key] = decision
            blocked.append(job)

        if self.config.preemption.enable:
            self._plan_preemptions(plan, blocked, running, free,
                                   preempting_counts)
        # Cancel evictions whose shortage resolved during the grace
        # window (preemptor deleted, or another gang finished): a
        # victim's teardown is only justified while some blocked job
        # of its slice type is still waiting on incoming capacity.
        still_short = {
            job.slice_type for job in blocked
            if plan.decisions[job.key].reason == "WaitingForPreemption"}
        for job in running:
            if job.phase != "Preempting":
                continue
            decision = plan.decisions.get(job.key)
            already_victim = any(v == job.key
                                 for v, _ in plan.preemptions)
            if (decision is not None and decision.action == PREEMPT
                    and not already_victim
                    and job.slice_type not in still_short):
                plan.decisions[job.key] = Decision(
                    action=ADMIT, reason="PreemptionCancelled",
                    message="capacity shortage resolved during the "
                            "grace window; eviction cancelled")
        return plan

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _usage(running: List[JobView]) -> Dict[Tuple[str, str], float]:
        """Admitted chips by (tenant, slice_type) — fused gangs billed
        per-member via :func:`tenant_shares`."""
        usage: Dict[Tuple[str, str], float] = {}
        for job in running:
            for tenant, share in tenant_shares(job):
                key = (tenant, job.slice_type)
                usage[key] = usage.get(key, 0) + share
        return usage

    def _pick(self, candidates: List[JobView],
              tenant_chips: Dict[str, float]) -> JobView:
        """Next job: strict priority, then least admitted chips per
        weight across tenants (recomputed against simulated
        admissions), then FIFO.  A fused gang ranks by its
        LEAST-served member tenant — the gang is pulled forward by
        whichever member fair-share would pick first."""
        def rank(job: JobView):
            fair = min(
                tenant_chips.get(tenant, 0) / self.config.weight(tenant)
                for tenant, _ in tenant_shares(job))
            return (-job.priority_value, fair, job.enqueued_at, job.key)
        return min(candidates, key=rank)

    @staticmethod
    def _would_delay(job: JobView, blocked: List[JobView],
                     free: Dict[str, int]) -> bool:
        """True when admitting ``job`` could push back any already
        capacity-blocked (hence higher pick-order) job's earliest
        start.  Same-type: safe only if the blocked demand still fits
        the post-admission free pool.  Cross-type claims are disjoint
        and always safe."""
        for b in blocked:
            if b.slice_type != job.slice_type:
                continue
            if free.get(job.slice_type, 0) - job.count < b.count:
                return True
        return False

    def _plan_preemptions(self, plan: Plan, blocked: List[JobView],
                          running: List[JobView], free: Dict[str, int],
                          preempting_counts: Dict[str, int]) -> None:
        """Evict for capacity-blocked jobs, highest pick-order first.

        Claims already mid-teardown count as incoming capacity: a
        blocked job whose demand is covered by in-progress evictions
        waits for them instead of triggering more (one eviction wave
        per shortage, however many passes the grace window spans).
        """
        victims_taken: set = set()
        # Per-type capacity each blocked job can draw on WITHOUT a new
        # eviction wave: free slices plus claims already mid-teardown.
        # Every satisfied blocked job RESERVES its demand from this
        # pool — one incoming slice must not absolve two waiters.
        avail = {t: free.get(t, 0) + preempting_counts.get(t, 0)
                 for t in set(free) | set(preempting_counts)}
        for job in blocked:
            decision = plan.decisions[job.key]
            if decision.reason != "WaitingForSlices":
                continue
            have = avail.get(job.slice_type, 0)
            if have >= job.count:
                avail[job.slice_type] = have - job.count
                decision.reason = "WaitingForPreemption"
                decision.message = "eviction in progress frees capacity"
                continue
            pool = [v for v in running
                    if v.slice_type == job.slice_type
                    and v.phase != "Preempting"
                    and v.key not in victims_taken]
            victims = pick_victims(pool, job, have)
            if not victims:
                continue
            if not self.limiter.allow(len(victims)):
                # Budget is per evicted gang; a wave that doesn't fit
                # whole is deferred (partial eviction frees nothing).
                decision.reason = "PreemptionRateLimited"
                decision.message = (
                    f"eviction budget spent "
                    f"({self.limiter.max_preemptions} per "
                    f"{self.limiter.window_s:.0f}s)")
                continue
            faults.fire("scheduler.preempt")
            for _ in victims:
                self.limiter.record()
            for v in victims:
                victims_taken.add(v.key)
                have += v.count
                plan.decisions[v.key] = Decision(
                    action=PREEMPT, reason="Preempted",
                    message=(f"evicted for higher-priority "
                             f"{job.key}"),
                    preemptor=job.key)
                plan.preemptions.append((v.key, job.key))
            avail[job.slice_type] = have - job.count
            decision.reason = "WaitingForPreemption"
            decision.message = (
                f"evicting {len(victims)} lower-priority job(s)")
