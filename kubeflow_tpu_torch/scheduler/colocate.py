"""Elastic train/serve colocation: serving claims on the shared pool.

Training (the gang placer + policy layer) and serving (the fleet
autoscaler) historically owned disjoint chips, so every diurnal
serving trough stranded the serving pool while training queued.  This
module makes the serving Deployment a first-class TENANT of the
cluster scheduler, Gavel-style (one arbiter over one pool, arXiv
2008.09213):

* The autoscaler's desired-replica delta becomes a TPUJob-shaped
  **ServingClaim** CR (``build_claim_cr``) — high priority class,
  ``kubeflow-tpu.org/workload: serving`` — instead of a raw
  ``spec.replicas`` patch.  One claim per Deployment;
  ``spec.numSlices`` is the desired replica count (one replica per
  slice).
* ``plan()`` admits the claim through the ordinary policy machinery:
  strict priority means a traffic spike preempts strictly-lower
  training via the existing grace-window checkpoint-resume path
  (victims requeue ``resumable: true``, restart budget untouched, the
  PreemptionRateLimiter budget respected) — except the victim drains
  on the SHORT ``serving_grace_period_s`` so the replica cold-start
  overlaps the drain instead of serializing after a full training
  grace.
* A scale-down shrinks the claim in place (``GangScheduler.resize``),
  releasing slices that pending training gangs backfill in the same
  pass.  Scale-to-zero deletes the claim CR outright
  (``numSlices >= 1`` is a spec invariant) and the reconciler's stale
  sweep releases the gang claim.

Elastic growth rides the same fold/merge shape as scheduler/fuse.py:
an admitted claim whose CR asks for MORE than its gang claim holds is
split into a running base view (what it holds — what quota and
preemption see) plus a pending **grow-delta** view (``<key>!grow``)
carrying only the increment; after the plan, ``finalize`` moves the
grow verdict back onto the base key so the reconciler drives one CR.

Speculative placement (arXiv 2010.11307) is the reconciler's half:
when a plan preempts training FOR a serving claim, prepull pods
(``build_prepull_pod``) pinned to the victims' nodes pre-pull the
serving image during the drain.

Hook sites: ``scheduler.colocate`` fires once per serving claim the
fold admits into a plan pass as new demand; ``autoscaler.claim`` fires
on every autoscaler->claim sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.scheduler.policy import (  # noqa: F401 (re-export)
    LABEL_PRIORITY,
    LABEL_TENANT,
    LABEL_WORKLOAD,
    PREEMPT,
    JobView,
    Plan,
)
from kubeflow_tpu_torch.testing import faults

# LABEL_WORKLOAD values.  Training CRs carry no workload label.
WORKLOAD_SERVING = "serving"
WORKLOAD_PREPULL = "prepull"

# Which Deployment a claim elasticizes (same metadata group as the
# tenant/priority labels the policy reads).
LABEL_DEPLOYMENT = "kubeflow-tpu.org/serving-deployment"
# Which claim a prepull pod warms (reconciler-side cleanup key).
LABEL_PREPULL_CLAIM = "kubeflow-tpu.org/prepull-claim"

# Claim defaults: the fleet bills one shared tenant, and serving
# outranks training by priority class — that asymmetry IS the
# colocation policy (latency SLOs preempt batch throughput; batch
# backfills latency troughs).
SERVING_TENANT = "fleet"
SERVING_PRIORITY = "high"
DEFAULT_SERVING_IMAGE = "ghcr.io/kubeflow-tpu/serving:latest"

# Grow-delta view keys live beside their base key; '!' cannot appear
# in a CR name, so the suffix can never collide with a real job key.
GROW_SUFFIX = "!grow"


def claim_name(deployment: str) -> str:
    return f"serving-{deployment}"


def claim_key(namespace: str, deployment: str) -> str:
    return f"{namespace}/{claim_name(deployment)}"


def is_serving_view(view: JobView) -> bool:
    return view.workload == WORKLOAD_SERVING


def is_serving_claim_cr(cr_obj: dict) -> bool:
    labels = (cr_obj.get("metadata") or {}).get("labels") or {}
    return labels.get(LABEL_WORKLOAD) == WORKLOAD_SERVING


def build_claim_cr(namespace: str, deployment: str, *,
                   slice_type: str = "h100-8", replicas: int = 1,
                   tenant: str = SERVING_TENANT,
                   priority: str = SERVING_PRIORITY,
                   image: str = DEFAULT_SERVING_IMAGE) -> dict:
    """The ServingClaim CR: an ordinary TPUJob wearing serving labels.

    Riding the TPUJob shape (rather than a second CRD) is the point:
    quota, fair share, priority, preemption, rate limiting and the CLI
    all apply to the claim with zero new admission code paths.
    """
    spec = crd.TPUJobSpec(
        name=claim_name(deployment), namespace=namespace,
        slice_type=slice_type, num_slices=int(replicas),
        worker=crd.WorkerSpec(image=image))
    cr = spec.to_custom_resource()
    cr["metadata"]["labels"] = {
        LABEL_WORKLOAD: WORKLOAD_SERVING,
        LABEL_TENANT: tenant,
        LABEL_PRIORITY: priority,
        LABEL_DEPLOYMENT: deployment,
    }
    return cr


def build_prepull_pod(namespace: str, claim: str, node: str,
                      image: str) -> dict:
    """Speculative-placement pod: pins to a node the plan predicts
    will free and pre-pulls the serving image during the victim's
    drain.  Runs no workload (the k8s image-pull side effect is the
    product); requests nothing, so it cannot steal the slice it
    warms."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"prepull-{claim}-{node}",
            "namespace": namespace,
            "labels": {
                LABEL_WORKLOAD: WORKLOAD_PREPULL,
                LABEL_PREPULL_CLAIM: claim,
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "nodeName": node,
            "containers": [{
                "name": "prepull",
                "image": image,
                "command": ["/bin/true"],
                "resources": {},
            }],
        },
    }


# -- plan-pass fold / merge (the fuse.py shape) ---------------------------


def _per_slice(view: JobView) -> int:
    return view.chips // max(1, view.count)


def fold(pending: List[JobView], running: List[JobView], gang,
         queue=None) -> Tuple[List[JobView], List[JobView],
                              List[JobView], set]:
    """Split admitted serving claims into held + grow-delta views.

    The policy must see an admitted claim as what it HOLDS (quota,
    victim cost, inventory) while its unmet increment competes as
    ordinary pending demand.  Returns ``(pending, running,
    grow_views, serving_keys)``: grow views are appended to pending
    under ``<key>!grow`` keys (touched into ``queue`` for stable FIFO
    position across passes), and ``serving_keys`` holds every serving
    claim's BASE key — ``finalize`` uses it to stamp the short grace
    on victims evicted for a claim.
    """
    serving_keys = {v.key for v in pending + running
                    if is_serving_view(v)}
    grow_views: List[JobView] = []
    out_running: List[JobView] = []
    out_pending = list(pending)
    for view in running:
        if not is_serving_view(view):
            out_running.append(view)
            continue
        held = gang.claim_count(view.key)
        per = _per_slice(view)
        if held and view.count > held:
            # Desired outgrew the claim: base view bills what is held,
            # the delta queues as pending demand (high priority — it
            # may preempt).
            faults.fire("scheduler.colocate")
            base = dataclasses.replace(
                view, count=held, chips=per * held)
            grow = dataclasses.replace(
                view, key=view.key + GROW_SUFFIX,
                count=view.count - held,
                chips=per * (view.count - held))
            if queue is not None:
                grow.enqueued_at = queue.touch(grow)
            out_running.append(base)
            grow_views.append(grow)
            out_pending.append(grow)
        else:
            # Steady or shrinking claim: the reconciler resizes
            # shrinks in place; the plan bills the held count.
            if held and held != view.count:
                view = dataclasses.replace(
                    view, count=held, chips=per * held)
            out_running.append(view)
    for view in pending:
        if is_serving_view(view):
            # Initial admission of a claim: ordinary pending demand,
            # announced on the colocate hook like a grow delta.
            faults.fire("scheduler.colocate")
    return out_pending, out_running, grow_views, serving_keys


def finalize(plan: Plan, grow_views: List[JobView], serving_keys: set,
             serving_grace_s: float) -> int:
    """Post-plan merge: move grow-delta verdicts onto their base keys
    and stamp the short serving grace on victims evicted for a serving
    claim.  Returns the number of colocation preemptions (victims
    whose preemptor is a serving claim) planned THIS pass — the plan's
    ``preemptions`` list only ever holds fresh eviction waves, so the
    caller can count it straight into a counter without double
    counting across grace-window passes.

    Runs BEFORE ``fuse.mirror_decisions`` so a fused-gang victim's
    grace override is copied onto its member decisions.
    """
    for gv in grow_views:
        base_key = gv.key[:-len(GROW_SUFFIX)]
        decision = plan.decisions.pop(gv.key, None)
        if decision is not None:
            plan.decisions[base_key] = decision
        if gv.key in plan.order:
            plan.order[plan.order.index(gv.key)] = base_key
        plan.preemptions = [
            (victim, base_key if preemptor == gv.key else preemptor)
            for victim, preemptor in plan.preemptions]
        for d in plan.decisions.values():
            if d.preemptor == gv.key:
                d.preemptor = base_key

    colocated = 0
    for victim, preemptor in plan.preemptions:
        if preemptor not in serving_keys:
            continue
        colocated += 1
        decision = plan.decisions.get(victim)
        if decision is not None and decision.action == PREEMPT:
            decision.grace_s = serving_grace_s
    return colocated


# -- the autoscaler's side ------------------------------------------------


class ServingClaimClient:
    """Translates the autoscaler's desired replica count into the
    ServingClaim CR and observes the arbiter's verdict.

    The CR API is create/status/delete (no spec patch, matching the
    fake apiserver), so a desired-count change REPLACES the claim CR;
    the gang claim keys on namespace/name, so the reconciler sees a
    resize, not a release/re-admit cycle.  Scale-to-zero deletes the
    claim and patches the Deployment to 0 directly — releasing chips
    needs no arbitration.
    """

    def __init__(self, kube, namespace: str, deployment: str, *,
                 slice_type: str = "h100-8",
                 tenant: str = SERVING_TENANT,
                 priority: str = SERVING_PRIORITY,
                 image: str = DEFAULT_SERVING_IMAGE):
        self.kube = kube
        self.namespace = namespace
        self.deployment = deployment
        self.slice_type = slice_type
        self.tenant = tenant
        self.priority = priority
        self.image = image
        self._last_state = ""
        self._last_pool: Optional[Dict] = None

    @property
    def name(self) -> str:
        return claim_name(self.deployment)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def sync(self, desired: int) -> dict:
        """Reconcile the claim CR to ``desired`` replicas; returns the
        current verdict snapshot (``state`` granted|pending|denied|
        released, ``granted`` replicas, last seen ``pool``)."""
        faults.fire("autoscaler.claim")
        desired = int(desired)
        if desired <= 0:
            self.kube.delete_custom(self.namespace, self.name)
            try:
                self.kube.patch_deployment_scale(
                    self.namespace, self.deployment, 0)
            except Exception:  # NotFound from either kube backend
                pass
            self._note_state("released")
            return {"desired": 0, "granted": 0, "state": "released",
                    "pool": self._last_pool}
        current = None
        try:
            existing = self.kube.get_custom(self.namespace, self.name)
            current = int(
                (existing.get("spec") or {}).get("numSlices", 0) or 0)
        except Exception:
            existing = None
        if current != desired:
            if existing is not None:
                self.kube.delete_custom(self.namespace, self.name)
            self.kube.create_custom(build_claim_cr(
                self.namespace, self.deployment,
                slice_type=self.slice_type, replicas=desired,
                tenant=self.tenant, priority=self.priority,
                image=self.image))
        return self.observe(desired)

    def observe(self, desired: Optional[int] = None) -> dict:
        try:
            cr = self.kube.get_custom(self.namespace, self.name)
        except Exception:
            self._note_state("released")
            return {"desired": 0, "granted": 0, "state": "released",
                    "pool": self._last_pool}
        spec = cr.get("spec") or {}
        status = cr.get("status") or {}
        if desired is None:
            desired = int(spec.get("numSlices", 0) or 0)
        granted = int(status.get("grantedReplicas", 0) or 0)
        pool = status.get("pool")
        if pool:
            self._last_pool = pool
        if status.get("denied"):
            state = "denied"
        elif granted >= desired:
            state = "granted"
        else:
            state = "pending"
        self._note_state(state)
        return {"desired": desired, "granted": granted, "state": state,
                "pool": self._last_pool}

    def pool(self) -> Optional[Dict]:
        """Last combined-pool snapshot the reconciler stamped on the
        claim status (the fleet status footer's data source)."""
        return self._last_pool

    def close(self) -> None:
        """Zero the claim's gauge series so a torn-down fleet scrapes
        0, not its last value (the registry is process-global; the
        scheduler also zeroes stale series every export)."""
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        gauge = REGISTRY.gauge(
            "kft_scheduler_serving_claim_chips",
            "chips held by admitted serving claims")
        for labels in gauge.labelsets():
            gauge.set(0, **labels)

    def _note_state(self, state: str) -> None:
        if state == self._last_state:
            return
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        if state == "granted":
            REGISTRY.counter(
                "kft_autoscaler_claim_granted_total",
                "serving claims fully granted by the arbiter",
            ).inc(deployment=self.deployment)
        elif state == "denied":
            REGISTRY.counter(
                "kft_autoscaler_claim_denied_total",
                "serving claims denied (unsatisfiable or "
                "rate-limited) by the arbiter",
            ).inc(deployment=self.deployment)
        self._last_state = state
