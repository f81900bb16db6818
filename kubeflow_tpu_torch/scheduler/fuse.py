"""Fusable-family detection: fold queued singleton jobs into one gang.

The admission-side half of the HFTA tier (runtime/hfta.py holds the
training half).  A swarm of same-architecture tuning jobs — each a
singleton gang that under-fills a slice — opts in by sharing a
``kubeflow-tpu.org/fuse-family`` label value; every plan pass this
module folds compatible pending singletons into ONE fused
:class:`~kubeflow_tpu_torch.scheduler.policy.JobView` (one gang claim, N
members, near-N× utilization) before the policy sees them, and
regroups the member CRs of an already-admitted fused gang back into
their gang view so inventory is charged once while quota/fair-share
bill each member's tenant its share (``policy.tenant_shares``).

Compatibility is deliberately structural: same namespace + family +
slice type + priority class, singleton demand (``num_slices == 1``,
the compatible-budget floor — a multi-slice job has nothing to gain
from sharing one slice).  Same-architecture/shape is the FAMILY
LABEL'S assertion — the scheduler cannot see model graphs, so a family
value is the user's contract that its members stack (runtime/hfta.py
rejects mismatched pytrees at stack time, the backstop).

Decisions for a fused view are MIRRORED onto every member key
(``Decision.fused_gang`` / ``fused_members`` / ``fused_leader``), so
the reconciler drives ordinary member CRs: the leader materializes one
pod gang under the fused claim, every member's phase follows it, and
preemption requeues all members individually resumable — each resumes
from its own per-member verified checkpoint.

Hook site ``scheduler.fuse`` fires once per fused gang formed — the
chaos harness wedges or skews fold passes exactly like
``scheduler.admit``/``scheduler.preempt``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from kubeflow_tpu_torch.scheduler.policy import (  # noqa: F401 (re-export)
    LABEL_FUSE_FAMILY,
    Decision,
    JobView,
    Plan,
)
from kubeflow_tpu_torch.testing import faults

# Fused gang claim keys live in their own namespace-prefixed space so
# they can never collide with a CR's "namespace/name" key.
FUSED_PREFIX = "fused:"

# Fusion needs at least two members to buy anything; the ceiling bounds
# per-member HBM headroom loss on one slice (HFTA's own sweep fuses
# single digits of members per accelerator).
MIN_MEMBERS = 2
MAX_MEMBERS = 8


def fused_gang_key(namespace: str, family: str) -> str:
    return f"{FUSED_PREFIX}{namespace}/{family}"


def fused_gang_name(gang_key: str) -> str:
    """Pod/service-safe name for a fused gang's workload objects."""
    family = gang_key[len(FUSED_PREFIX):].split("/", 1)[-1]
    return f"fused-{family}"


def _fused_view(gang_key: str, members: List[JobView]) -> JobView:
    members = sorted(members, key=lambda m: (m.enqueued_at, m.key))
    base = members[0]
    phase = ("Preempting"
             if any(m.phase == "Preempting" for m in members)
             else base.phase)
    return JobView(
        key=gang_key,
        tenant=",".join(sorted({m.tenant for m in members})),
        priority=base.priority,
        priority_value=base.priority_value,
        slice_type=base.slice_type,
        count=base.count,
        chips=base.chips,
        phase=phase,
        enqueued_at=base.enqueued_at,
        resumable=any(m.resumable for m in members),
        preemptions=max(m.preemptions for m in members),
        family=base.family,
        members=tuple(members),
        fused_members=len(members),
    )


def _stamp_members(fused: JobView) -> None:
    for m in fused.members:
        m.fused_gang = fused.key
        m.fused_members = len(fused.members)


def fold_pending(
    pending: List[JobView], gang=None,
) -> Tuple[List[JobView], List[JobView]]:
    """Fold compatible pending singletons into fused views.

    Returns ``(plan_input, fused_views)``: the pending list with folded
    members replaced by their fused view (position = oldest member's),
    and the fused views alone for decision mirroring.  Members keep
    their individual enqueue times; the gang inherits the OLDEST so
    fusion never costs a member its queue position.
    """
    groups: Dict[Tuple[str, str, str, str], List[JobView]] = {}
    for view in pending:
        if not view.family or view.count != 1:
            continue
        namespace = view.key.split("/", 1)[0]
        groups.setdefault(
            (namespace, view.family, view.slice_type, view.priority),
            []).append(view)

    fused_views: List[JobView] = []
    folded: Dict[str, JobView] = {}   # member key -> fused view
    for (namespace, family, _, _), members in sorted(groups.items()):
        if len(members) < MIN_MEMBERS:
            continue
        # One fused gang per family per pass; an overflow tail stays
        # pending as ordinary singletons until the gang completes.
        gkey = fused_gang_key(namespace, family)
        if any(f.key == gkey for f in fused_views):
            # Same family under a second slice type/priority: first
            # (sorted) group wins the key; the rest stay singletons.
            continue
        if gang is not None and gang.admitted(gkey):
            # A fused gang of this family is already running; late
            # arrivals queue as singletons until it completes.
            continue
        members = sorted(members, key=lambda m: (m.enqueued_at, m.key))
        batch = members[:MAX_MEMBERS]
        faults.fire("scheduler.fuse")
        fused = _fused_view(gkey, batch)
        _stamp_members(fused)
        fused_views.append(fused)
        for m in batch:
            folded[m.key] = fused

    plan_input: List[JobView] = []
    seen_fused: set = set()
    for view in pending:
        fused = folded.get(view.key)
        if fused is None:
            plan_input.append(view)
        elif fused.key not in seen_fused:
            seen_fused.add(fused.key)
            plan_input.append(fused)
    return plan_input, fused_views


def fold_running(
    running: List[JobView], gang
) -> Tuple[List[JobView], List[JobView]]:
    """Regroup member CR views of admitted fused gangs into their gang
    view, so inventory/preemption see ONE claim while quota bills per
    member.  Non-fused running views pass through untouched."""
    by_gang: Dict[str, List[JobView]] = {}
    plan_input: List[JobView] = []
    order: List[str] = []
    for view in running:
        if view.fused_gang and gang.admitted(view.fused_gang):
            if view.fused_gang not in by_gang:
                order.append(view.fused_gang)
            by_gang.setdefault(view.fused_gang, []).append(view)
        else:
            plan_input.append(view)
    fused_views: List[JobView] = []
    for gang_key in order:
        fused = _fused_view(gang_key, by_gang[gang_key])
        _stamp_members(fused)
        fused_views.append(fused)
        plan_input.append(fused)
    return plan_input, fused_views


def mirror_decisions(plan: Plan, fused_views: List[JobView]) -> None:
    """Copy each fused view's verdict onto every member key so the
    reconciler can drive ordinary member CRs, and expand the plan's
    consideration order from gang keys back to member keys."""
    for fused in fused_views:
        decision = plan.decisions.get(fused.key)
        if decision is None:
            # The policy only issues verdicts for pending views and
            # preemption victims; a fused view it left alone is a
            # RUNNING admitted gang (fold_running only groups members
            # whose claim is live) — synthesize the keep verdict so
            # members keep reconciling under the fused branch instead
            # of falling back to singleton requeue.
            decision = Decision(action="admit", reason="Admitted",
                                message="fused gang running")
        member_keys = tuple(m.key for m in fused.members)
        for i, m in enumerate(fused.members):
            plan.decisions[m.key] = dataclasses.replace(
                decision,
                message=(f"{decision.message} "
                         f"[fused gang {fused.key}, member "
                         f"{i + 1}/{len(member_keys)}]").strip(),
                fused_gang=fused.key,
                fused_members=member_keys,
                fused_leader=(i == 0),
            )
        if fused.key in plan.order:
            at = plan.order.index(fused.key)
            plan.order[at:at + 1] = list(member_keys)
