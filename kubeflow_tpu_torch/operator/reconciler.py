"""TPUJob reconciler: CR -> gang admission -> pods -> lifecycle.

The port's copy of kubeflow_tpu/operator/reconciler.py (stdlib only;
the port imports nothing of the JAX package).  The state machine,
events, condition reasons, metrics and spans are the JAX package's; a
worker pod differs only in what it asks of a node: ``nvidia.com/gpu``
(the shape's ``chips_per_host``) and the port topology's node
selector, where the JAX package asks for ``google.com/tpu``.  The env
is the same ``KFT_*`` contract, which the port's runtime/bootstrap.py
parses; multi-slice jobs keep ``MEGASCALE_NUM_SLICES`` and
``MEGASCALE_SLICE_ID`` (NCCL ignores them) so the pod differs from the
JAX package's in resources and selector alone.

First-party heir of the external tf-operator binary the reference only
*deployed* (kubeflow/core/tf-job-operator.libsonnet:61-125): watches
TPUJob CRs, gang-admits them onto slice inventory, creates the headless
Service + one pod per slice host with the rendezvous env injected
(the TF_CONFIG analogue, see runtime/bootstrap.py), and drives the
status state machine:

    Queued -> Starting -> Running -> Succeeded | Failed

Failure semantics fix the reference's two warts (SURVEY.md §5):
  - any worker failure or disappearance (preemption) restarts the WHOLE
    gang from checkpoint, bounded by restartPolicy.maxRestarts — replacing
    per-pod `restartPolicy: OnFailure` and the launcher's sleep-forever
    hack (tf-controller-examples/tf-cnn/launcher.py:86-90);
  - success is "all workers succeeded", not a chief heuristic
    (kubeflow/tf-job/tf-job.libsonnet:39-44) — SPMD workers exit together.

Level-triggered: ``reconcile_once`` is idempotent and polls, like
controller-runtime; no watch plumbing to mock in tests.

Multi-tenant mode: when a
:class:`~kubeflow_tpu_torch.scheduler.queue.ClusterScheduler` is attached,
``reconcile_all`` consults it for an admission :class:`Plan` instead
of offering CRs to the gang in listing order — quotas, weighted-fair
ordering, priority classes, backfill, and preemption all live in that
policy layer (kubeflow_tpu_torch/scheduler/).  A ``preempt`` verdict drives
the ``Preempting`` phase here: the victim keeps its pods and claim
for a checkpoint grace window (policy clock, skewable), then the gang
is torn down through the same machinery a worker failure uses and the
job re-queues flagged ``resumable`` — on re-admission the trainer's
``CheckpointManager.restore_or_init`` continues from the latest saved
step instead of step 0.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

from kubeflow_tpu_torch.operator import crd
from kubeflow_tpu_torch.operator.gang import GangScheduler, NodeQuarantine
from kubeflow_tpu_torch.operator.kube import (
    FAILED,
    PENDING,
    RUNNING,
    SUCCEEDED,
    Conflict,
    FakeKube,
    NotFound,
)
from kubeflow_tpu_torch.runtime import bootstrap, tracing
from kubeflow_tpu_torch.scheduler import colocate, fuse
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

COORDINATOR_PORT = 8476
LABEL_JOB = "kubeflow-tpu.org/job-name"
LABEL_INDEX = "kubeflow-tpu.org/worker-index"
# Multi-slice env the JAX package's pods carry (its bootstrap's
# ENV_MEGASCALE_SLICES); kept on the port's pods, where nothing reads it.
ENV_MEGASCALE_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
# The device-plugin resource a GPU worker pod asks for.
GPU_RESOURCE = "nvidia.com/gpu"

QUEUED = "Queued"
STARTING = "Starting"
JOB_RUNNING = "Running"
JOB_PREEMPTING = "Preempting"
JOB_SUCCEEDED = "Succeeded"
JOB_FAILED = "Failed"
TERMINAL = (JOB_SUCCEEDED, JOB_FAILED)


def worker_name(job: str, index: int) -> str:
    return f"{job}-worker-{index}"


def coordinator_address(job: crd.TPUJobSpec) -> str:
    """Stable DNS via the headless Service — the openmpi hostfile trick
    (kubeflow/openmpi/assets.libsonnet:30-35) minus the hostfile."""
    return (f"{worker_name(job.name, 0)}.{job.name}.{job.namespace}"
            f":{COORDINATOR_PORT}")


def build_headless_service(job: crd.TPUJobSpec) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": job.name,
            "namespace": job.namespace,
            "labels": {LABEL_JOB: job.name},
        },
        "spec": {
            "clusterIP": "None",  # headless: per-pod DNS records
            "selector": {LABEL_JOB: job.name},
            "ports": [{"name": "coordinator", "port": COORDINATOR_PORT}],
        },
    }


def build_worker_pod(job: crd.TPUJobSpec, index: int,
                     avoid_nodes: Optional[List[str]] = None) -> dict:
    topo = job.topology
    hosts_per_slice = topo.hosts
    slice_id = index // hosts_per_slice
    env = {
        bootstrap.ENV_COORDINATOR: coordinator_address(job),
        bootstrap.ENV_NUM_PROCESSES: str(job.num_workers),
        bootstrap.ENV_PROCESS_ID: str(index),
        bootstrap.ENV_JOB_NAME: job.name,
        bootstrap.ENV_SLICE_TYPE: job.slice_type,
        **job.worker.env,
    }
    if job.num_slices > 1:
        env[ENV_MEGASCALE_SLICES] = str(job.num_slices)
        env[ENV_MEGASCALE_SLICE_ID] = str(slice_id)
    if topo.is_cpu:
        # CPU gang (cpu-N slice): schedulable anywhere, no GPU resource —
        # the reference's minikube CPU TFJob shape.
        resources = {"requests": {"cpu": "1", "memory": "1Gi"}}
    else:
        resources = {
            "limits": {GPU_RESOURCE: str(topo.chips_per_host)},
            "requests": {GPU_RESOURCE: str(topo.chips_per_host)},
        }
    container = {
        "name": "worker",
        "image": job.worker.image,
        "env": [{"name": k, "value": v} for k, v in sorted(env.items())],
        "resources": resources,
        "ports": [{"containerPort": COORDINATOR_PORT}],
    }
    if job.worker.command:
        container["command"] = list(job.worker.command)
    if job.worker.args:
        container["args"] = list(job.worker.args)
    if job.worker.working_dir:
        container["workingDir"] = job.worker.working_dir
    spec: dict = {
        "restartPolicy": "Never",  # gang restart is the operator's job
        "hostname": worker_name(job.name, index),
        "subdomain": job.name,  # -> {pod}.{job}.{ns} DNS
        "nodeSelector": topo.k8s_node_selector(),
        "containers": [container],
    }
    if avoid_nodes:
        # Quarantined (flapping) nodes: hard anti-affinity, so the
        # k8s scheduler cannot land a fresh gang on the host that just
        # ate the previous one's restart budget.
        spec["affinity"] = {"nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [{
                    "key": "kubernetes.io/hostname",
                    "operator": "NotIn",
                    "values": sorted(avoid_nodes),
                }]}],
            },
        }}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": worker_name(job.name, index),
            "namespace": job.namespace,
            "labels": {
                LABEL_JOB: job.name,
                LABEL_INDEX: str(index),
            },
        },
        "spec": spec,
    }


class TPUJobController:
    def __init__(self, kube: FakeKube, scheduler: GangScheduler,
                 cluster=None,
                 quarantine: Optional[NodeQuarantine] = None):
        self.kube = kube
        self.scheduler = scheduler
        # Optional policy layer (scheduler.ClusterScheduler): when set,
        # admission order/quotas/priorities/preemption come from its
        # per-pass Plan instead of gang FIFO.
        self.cluster = cluster
        # Bad-node attribution: repeated WorkerFailed pods on one node
        # quarantine it (excluded from placement for a cooldown) so a
        # flapping host stops eating gangs' restart budgets.
        self.quarantine = quarantine or NodeQuarantine()
        # (job, pod, restart-generation) triples already attributed: a
        # real apiserver keeps listing a Failed pod (deletion grace)
        # for sweeps after the restart, and re-counting the SAME
        # failure each sweep would quarantine a node off one incident.
        self._attributed: Dict[str, set] = {}
        # Transient per-job bookkeeping (admission timestamps for the
        # gang-schedule-to-running metric; restart counts live in status).
        self._admitted_at: Dict[str, float] = {}
        # Preemption grace deadlines on the policy clock, keyed by job.
        self._preempt_deadline: Dict[str, float] = {}
        # Serving claims seen (scheduler/colocate.py): their gang
        # claims are released when the CR vanishes — scale-to-zero
        # deletes the claim CR outright instead of resizing to 0.
        self._serving_claims: set = set()
        # Live speculative-placement pods by claim key ->
        # {(namespace, pod name)}; retired once the claim is fully
        # granted or gone.
        self._prepull: Dict[str, set] = {}
        # Job-lifecycle traces (runtime/tracing.py): one trace per job,
        # a span per phase dwelled in, the root stamped at the terminal
        # transition (tail sampling then always keeps Failed jobs).
        self._job_traces: Dict[str, dict] = {}
        self.metrics: List[dict] = []

    # -- main loop --------------------------------------------------------

    def run(self, poll_interval_s: float = 2.0, max_iterations: int = 0):
        i = 0
        while True:
            self.reconcile_all()
            i += 1
            if max_iterations and i >= max_iterations:
                return
            time.sleep(poll_interval_s)

    def reconcile_all(self) -> None:
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        crs = [cr for cr in self.kube.list_custom()
               if cr.get("kind") == crd.KIND]
        decisions: dict = {}
        order: Dict[str, int] = {}
        plan_obj = None
        if self.cluster is not None:
            try:
                plan = self.cluster.plan(crs)
                plan_obj = plan
                decisions = plan.decisions
                order = {key: i for i, key in enumerate(plan.order)}
            except Exception:
                # A wedged policy pass (scheduler.admit fault, config
                # bug) must not stop already-admitted gangs from being
                # reconciled: fall back to no-decision, which keeps
                # running jobs running and pending jobs Queued.
                log.exception("scheduler plan failed; holding queue")
                REGISTRY.counter(
                    "kft_scheduler_plan_errors_total",
                    "admission-plan passes that raised",
                ).inc()

        def cr_key(cr_obj: dict) -> str:
            meta = cr_obj.get("metadata", {})
            return (f"{meta.get('namespace', 'kubeflow')}/"
                    f"{meta.get('name', '')}")

        # Plan order first (admissions land exactly as simulated),
        # then everything the plan didn't rank, in listing order.
        if order:
            crs.sort(key=lambda cr: order.get(cr_key(cr), len(order)))

        if plan_obj is not None:
            # Speculative placement: pin prepull pods to the nodes the
            # plan just decided will free, in the SAME sweep that
            # starts the victims' drains.
            try:
                self._sync_prepull(plan_obj, crs, cr_key)
            except Exception:
                log.exception("prepull sync failed")

        phases: dict = {}
        for cr_obj in crs:
            try:
                phase = self.reconcile_once(
                    cr_obj, decision=decisions.get(cr_key(cr_obj)))
                phases[phase] = phases.get(phase, 0) + 1
            except ValueError as e:  # SpecError + topology parse errors
                self._set_phase(cr_obj, JOB_FAILED, reason="InvalidSpec",
                                message=str(e))
                phases[JOB_FAILED] = phases.get(JOB_FAILED, 0) + 1
            except Exception:
                log.exception(
                    "reconcile of %s failed", cr_obj["metadata"]["name"]
                )
                REGISTRY.counter(
                    "kft_operator_reconcile_errors_total",
                    "reconcile passes that raised",
                ).inc()
        REGISTRY.counter(
            "kft_operator_reconcile_passes_total",
            "full reconcile sweeps over all TPUJobs",
        ).inc()
        # Serving claims whose CR vanished (scale-to-zero, kubectl
        # delete): release their chips so pending training backfills
        # this sweep, not next.
        live_claim_keys = {cr_key(cr) for cr in crs}
        for skey in [k for k in self._serving_claims
                     if k not in live_claim_keys]:
            self.scheduler.release(skey)
            self._serving_claims.discard(skey)
            if self.cluster is not None:
                self.cluster.forget(skey)
        # Trace state of jobs whose CR vanished pre-terminal (kubectl
        # delete mid-run) would otherwise accumulate forever — no
        # terminal transition will ever prune them.  Keys come from
        # the SAME helper _set_phase stamps with (namespace default
        # 'default', NOT cr_key's 'kubeflow') or a defaulted-namespace
        # job's live trace would be wiped every sweep.
        live_keys = {
            self._trace_key(cr.get("metadata", {})) for cr in crs}
        for key in [k for k in self._job_traces
                    if k not in live_keys]:
            del self._job_traces[key]
        gauge = REGISTRY.gauge(
            "kft_operator_jobs", "TPUJobs by phase at last sweep")
        for phase in (QUEUED, STARTING, JOB_RUNNING, JOB_PREEMPTING,
                      JOB_SUCCEEDED, JOB_FAILED):
            gauge.set(phases.get(phase, 0), phase=phase)
        REGISTRY.gauge(
            "kft_operator_quarantined_nodes",
            "nodes excluded from gang placement for flapping workers",
        ).set(len(self.quarantine.quarantined()))

    # -- single-job reconcile --------------------------------------------

    def reconcile_once(self, cr_obj: dict, decision=None) -> str:
        """Reconcile one CR dict; returns the resulting phase.

        ``decision`` is this job's verdict from the cluster
        scheduler's plan (None when no policy layer is attached, or
        for CRs the plan could not parse): ``admit`` gates the gang
        offer, ``wait``/``unsatisfiable`` replace the FIFO queue
        semantics, ``preempt`` drives the grace-window eviction.
        """
        job = crd.TPUJobSpec.from_custom_resource(cr_obj)
        status = cr_obj.get("status", {}) or {}
        phase = status.get("phase", "")
        key = f"{job.namespace}/{job.name}"

        if phase in TERMINAL:
            self.scheduler.release(key)
            self._preempt_deadline.pop(key, None)
            self._attributed.pop(key, None)
            if self.cluster is not None:
                self.cluster.forget(key)
            return phase

        # Serving claims (scheduler/colocate.py): the fleet
        # autoscaler's desired-replica count riding the TPUJob shape.
        # No pods or service — the grant is a gang claim plus a
        # Deployment scale patch; the serving replicas themselves live
        # under the Deployment.
        if colocate.is_serving_claim_cr(cr_obj):
            return self._reconcile_serving_claim(
                cr_obj, job, status, phase, key, decision)

        # Fused members (scheduler/fuse.py): the plan mirrored the
        # gang's verdict onto this member key; one shared pod gang is
        # driven under the fused claim while each member CR keeps its
        # own phase, events, restart budget and resumable flag.
        if decision is not None and decision.fused_gang:
            return self._reconcile_fused_member(
                cr_obj, job, status, phase, key, decision)

        # 0. Preemption: a higher-priority job needs this gang's
        # slices.  Grace window first (checkpoint-on-SIGTERM
        # contract), teardown + resumable re-queue after.  A gang
        # that FINISHES during the grace is a completion, not an
        # eviction — without this check the preempt branch would
        # return before pod observation every pass, then tear down
        # and pointlessly re-run an already-succeeded job.
        if decision is not None and decision.action == "preempt" \
                and self.scheduler.admitted(key):
            pods = self.kube.list_pods(job.namespace,
                                       labels={LABEL_JOB: job.name})
            done = [(p.get("status") or {}).get("phase", PENDING)
                    for p in pods]
            if len(pods) == job.num_workers and all(
                    ph == SUCCEEDED for ph in done):
                self._set_phase(cr_obj, JOB_SUCCEEDED,
                                reason="AllWorkersDone",
                                message="gang completed during "
                                        "preemption grace")
                self.scheduler.release(key)
                self._admitted_at.pop(key, None)
                self._preempt_deadline.pop(key, None)
                if self.cluster is not None:
                    self.cluster.forget(key)
                return JOB_SUCCEEDED
            if any(ph == FAILED for ph in done):
                # The gang DIED during the grace: nothing is
                # checkpointing, so the window buys nobody anything —
                # cut it short, count the failure against the restart
                # budget exactly like a WorkerFailed restart would,
                # and hand the slices over now.
                restarts = int(status.get("restarts", 0))
                self._preempt_deadline.pop(key, None)
                self._note_worker_failures(job, pods, restarts)
                self._teardown_pods(job)
                self.scheduler.release(key)
                self._admitted_at.pop(key, None)
                if restarts + 1 > job.restart.max_restarts:
                    self._set_phase(
                        cr_obj, JOB_FAILED,
                        reason="MaxRestartsExceeded",
                        message=(f"{done.count(FAILED)} worker(s) "
                                 f"failed during preemption grace; "
                                 f"restarts={restarts}"),
                        extra={"restarts": restarts})
                    if self.cluster is not None:
                        self.cluster.forget(key)
                    return JOB_FAILED
                if self.cluster is not None:
                    self.cluster.note_preempted(key)
                self.kube.record_event(
                    job.namespace, f"TPUJob/{job.name}",
                    "WorkerFailed",
                    f"{done.count(FAILED)} worker(s) failed during "
                    f"preemption grace; grace cut short, gang restart "
                    f"{restarts + 1}/{job.restart.max_restarts} on "
                    f"re-admission", type_="Warning")
                self._set_phase(
                    cr_obj, QUEUED, reason="PreemptedRequeued",
                    message="gang failed during preemption grace; "
                            "resumes from latest checkpoint",
                    extra={"resumable": True,
                           "restarts": restarts + 1})
                return QUEUED
            return self._preempt(cr_obj, job, status, decision)

        # 1. Gang admission (all slices or nothing).
        if decision is None and self.cluster is not None:
            # Policy mode, but the plan had no verdict for this job
            # (plan pass failed, or the CR appeared mid-pass).  Never
            # fall through to the gang FIFO — that would bypass every
            # quota/priority rule.  Admitted jobs keep running; the
            # rest hold for the next plan.
            if not self.scheduler.admitted(key):
                if phase != QUEUED:
                    self._set_phase(
                        cr_obj, QUEUED, reason="WaitingForScheduler",
                        message="no admission verdict this pass")
                return QUEUED
            if phase == JOB_PREEMPTING:
                # Mid-grace victim with no verdict this pass: hold the
                # eviction state; the next healthy plan re-issues the
                # preempt decision and the grace deadline persists.
                return JOB_PREEMPTING
            admitted = True
        elif decision is None:
            admitted = self.scheduler.offer(
                key, job.slice_type, job.num_slices,
                queue=job.queue or "default"
            )
        elif self.scheduler.admitted(key):
            if phase == JOB_PREEMPTING and \
                    self._preempt_deadline.pop(key, None) is not None:
                # The plan withdrew the eviction (shortage resolved
                # mid-grace): the gang was never torn down, so it just
                # keeps running; a future eviction starts a new grace.
                # Revert the eviction stamps — the job was never
                # actually preempted, so neither the resumable flag
                # nor the preemption count may survive (the next
                # _set_phase below persists the corrected status).
                status = dict(status)
                status["resumable"] = False
                status["preemptions"] = max(
                    0, int(status.get("preemptions", 1)) - 1)
                cr_obj["status"] = status
                self.kube.record_event(
                    job.namespace, f"TPUJob/{job.name}",
                    "PreemptionCancelled", decision.message)
            admitted = True
        elif decision.action == "admit":
            # The plan validated capacity against the same gang
            # snapshot in this reconcile pass, so the offer admits
            # immediately — the gang's own FIFO queue stays empty in
            # policy mode.
            admitted = self.scheduler.offer(
                key, job.slice_type, job.num_slices,
                queue=job.queue or "default")
            if admitted and self.cluster is not None:
                self.cluster.note_admitted(
                    key, backfilled=decision.backfilled,
                    resumed=bool(status.get("resumable")))
                if status.get("resumable"):
                    # The flag is CONSUMED by this resume admission:
                    # a later ordinary gang restart must not count as
                    # another resume.  `preemptions` stays — that one
                    # is history.  Persisted by the _set_phase the
                    # materialize step below is guaranteed to make
                    # (phase was Queued).
                    status = dict(status)
                    status["resumable"] = False
                    cr_obj["status"] = status
        elif decision.action == "unsatisfiable":
            self._set_phase(cr_obj, JOB_FAILED,
                            reason=decision.reason or
                            "UnsatisfiableResources",
                            message=decision.message)
            self.scheduler.release(key)
            if self.cluster is not None:
                self.cluster.forget(key)
            return JOB_FAILED
        else:
            admitted = False
        if not admitted:
            if decision is not None:
                reason = decision.reason or "WaitingForSlices"
                if phase != QUEUED or status.get("reason") != reason:
                    self._set_phase(cr_obj, QUEUED, reason=reason,
                                    message=decision.message)
                return QUEUED
            if self.scheduler.unsatisfiable(key):
                # Demand exceeds total inventory: it can NEVER run.  Fail
                # fast with a clear message and release the queue slot so
                # jobs behind it in the FIFO are not wedged forever.
                self._set_phase(
                    cr_obj, JOB_FAILED, reason="UnsatisfiableResources",
                    message=(
                        f"requires {job.num_slices} x {job.slice_type} but "
                        f"cluster capacity is "
                        f"{self.scheduler.capacity.get(job.slice_type, 0)}"
                    ),
                )
                self.scheduler.release(key)
                return JOB_FAILED
            if phase != QUEUED:
                self._set_phase(cr_obj, QUEUED, reason="WaitingForSlices",
                                message=f"queue position "
                                        f"{self.scheduler.position(key)}")
            return QUEUED
        self._admitted_at.setdefault(key, faults.monotonic())

        # 2. Materialize service + pods (idempotent).
        try:
            self.kube.create_service(build_headless_service(job))
        except Conflict:
            pass
        existing = {
            p["metadata"]["name"]: p
            for p in self.kube.list_pods(job.namespace,
                                         labels={LABEL_JOB: job.name})
        }
        restarts = int(status.get("restarts", 0))
        avoid_nodes = self.quarantine.quarantined()
        for i in range(job.num_workers):
            name = worker_name(job.name, i)
            if name not in existing:
                if phase == JOB_RUNNING:
                    # A pod vanished mid-run (preemption/node loss):
                    # that's a gang failure, not a hole to patch.
                    return self._gang_restart(
                        cr_obj, job, restarts,
                        reason="WorkerLost",
                        message=f"{name} disappeared while Running",
                    )
                try:
                    self.kube.create_pod(
                        build_worker_pod(job, i, avoid_nodes))
                except Conflict:
                    pass

        # 3. Observe the gang.
        pods = self.kube.list_pods(job.namespace, labels={LABEL_JOB: job.name})
        phases = [(p.get("status") or {}).get("phase", PENDING)
                  for p in pods]
        if any(ph == FAILED for ph in phases):
            return self._gang_restart(
                cr_obj, job, restarts, reason="WorkerFailed",
                message=f"{phases.count(FAILED)} worker(s) failed",
            )
        if len(pods) == job.num_workers and all(
                ph == SUCCEEDED for ph in phases):
            self._set_phase(cr_obj, JOB_SUCCEEDED, reason="AllWorkersDone",
                            message="gang completed")
            self.scheduler.release(key)
            self._admitted_at.pop(key, None)
            return JOB_SUCCEEDED
        if len(pods) == job.num_workers and all(
                ph in (RUNNING, SUCCEEDED) for ph in phases):
            if phase != JOB_RUNNING:
                latency = faults.monotonic() - self._admitted_at.get(
                    key, faults.monotonic())
                self.metrics.append({
                    "event": "gang_running", "job": key,
                    "schedule_to_running_s": latency,
                })
                from kubeflow_tpu_torch.runtime.prom import REGISTRY

                # The BASELINE north-star, scrapeable: p50 comes from
                # the histogram on the operator's --metrics-port.
                # Buckets sized for gang startup (image pull + GPU node
                # provisioning: seconds to minutes), not request
                # latency — the registry caches the first registration,
                # so defaults here could never be widened later.
                REGISTRY.histogram(
                    "kft_gang_schedule_to_running_seconds",
                    "gang admission to all-workers-running latency",
                    buckets=(1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0,
                             300.0, 600.0),
                ).observe(latency)
                self._set_phase(cr_obj, JOB_RUNNING, reason="GangRunning",
                                message="all workers running",
                                extra={"restarts": restarts})
            return JOB_RUNNING
        if phase != STARTING or status.get("restarts") != restarts:
            self._set_phase(cr_obj, STARTING, reason="CreatingWorkers",
                            message=f"{phases.count(RUNNING)}/"
                                    f"{job.num_workers} running",
                            extra={"restarts": restarts})
        return STARTING

    # -- serving claims (train/serve colocation) ---------------------------

    def _reconcile_serving_claim(self, cr_obj: dict,
                                 job: crd.TPUJobSpec, status: dict,
                                 phase: str, key: str,
                                 decision) -> str:
        """Drive one ServingClaim CR through the shared-pool arbiter.

        Grants and grows go through the plan verdict (which may have
        preempted training to make room); shrinks release in place
        with no arbitration — freed slices backfill pending training
        the same sweep (``GangScheduler.resize`` re-drains the FIFO).
        The granted count is patched onto the Deployment's
        ``spec.replicas`` HERE, keeping every chip movement inside the
        reconcile loop; the autoscaler only ever writes desire into
        the claim CR.
        """
        desired = job.num_slices
        labels = (cr_obj.get("metadata") or {}).get("labels") or {}
        deployment = labels.get(colocate.LABEL_DEPLOYMENT, "")
        self._serving_claims.add(key)
        admitted = self.scheduler.admitted(key)
        held = self.scheduler.claim_count(key)
        denied = False
        reason = message = ""

        if admitted and desired < held:
            self.scheduler.resize(key, desired)
            held = desired
            self.kube.record_event(
                job.namespace, f"TPUJob/{job.name}", "ClaimShrunk",
                f"serving claim released {held} -> {desired} slices; "
                f"training backfills")
        elif admitted and desired > held:
            if decision is not None and decision.action == "admit":
                if self.scheduler.resize(key, desired):
                    if self.cluster is not None:
                        # Clear the grow-delta queue entry and record
                        # its wait in the CLI window.
                        self.cluster.queue.note_admitted(
                            key + colocate.GROW_SUFFIX)
                    held = desired
            elif decision is not None:
                reason = decision.reason or ""
                message = decision.message
                denied = (decision.action == "unsatisfiable"
                          or reason == "PreemptionRateLimited")
        elif not admitted:
            if decision is not None and decision.action == "admit":
                admitted = self.scheduler.offer(
                    key, job.slice_type, desired, queue="serving")
                if admitted:
                    held = desired
                    if self.cluster is not None:
                        self.cluster.note_admitted(
                            key, backfilled=decision.backfilled)
            elif decision is not None:
                reason = decision.reason or ""
                message = decision.message
                denied = (decision.action == "unsatisfiable"
                          or reason == "PreemptionRateLimited")
            elif self.cluster is None:
                # No policy layer: claims fall back to gang FIFO like
                # any job (--no-scheduler operators still colocate).
                admitted = self.scheduler.offer(
                    key, job.slice_type, desired, queue="serving")
                if admitted:
                    held = desired

        granted = self.scheduler.claim_count(key)
        if deployment and granted > 0:
            # Patch only on grant/resize; a claim pending its FIRST
            # grant must not scale the deployment down to zero.
            try:
                dep = self.kube.get_deployment(job.namespace,
                                               deployment)
                current = int(
                    (dep.get("spec") or {}).get("replicas", 0) or 0)
                if current != granted:
                    self.kube.patch_deployment_scale(
                        job.namespace, deployment, granted)
                    self.kube.record_event(
                        job.namespace, f"Deployment/{deployment}",
                        "ServingScaled",
                        f"claim {key}: {current} -> {granted} "
                        f"replicas")
            except NotFound:
                pass

        pool = (self.cluster.pool_status()
                if self.cluster is not None else None)
        if granted >= desired and granted > 0:
            new_phase, new_reason = JOB_RUNNING, "ClaimGranted"
            message = f"{granted}/{desired} replicas granted"
        elif admitted:
            new_phase = STARTING
            new_reason = reason or "ClaimGrowing"
            message = message or (f"{granted}/{desired} replicas "
                                  f"granted")
        else:
            new_phase = QUEUED
            new_reason = reason or "WaitingForSlices"
        extra: dict = {"grantedReplicas": granted, "denied": denied}
        if pool is not None:
            extra["pool"] = pool
        if (phase != new_phase or status.get("reason") != new_reason
                or int(status.get("grantedReplicas", -1) or 0)
                != granted
                or bool(status.get("denied")) != denied):
            self._set_phase(cr_obj, new_phase, reason=new_reason,
                            message=message, extra=extra)
        elif pool is not None and status.get("pool") != pool:
            # Pool accounting moved but the verdict didn't: refresh
            # the stamp without minting an event per sweep.
            new_status = dict(status)
            new_status["pool"] = pool
            cr_obj["status"] = new_status
            self.kube.update_custom_status(
                job.namespace, job.name, new_status)
        return new_phase

    def _sync_prepull(self, plan, crs: List[dict], cr_key) -> None:
        """Speculative placement (arXiv 2010.11307): pin prepull pods
        to the nodes of victims evicted FOR a serving claim, so the
        replica image pull overlaps the victim's drain; retired once
        the claim is fully granted (or its CR vanished).  Fused-gang
        victims are skipped — their key is not a CR key, and their
        members' pods ride the gang name."""
        by_key = {cr_key(cr): cr for cr in crs}
        for victim, preemptor in plan.preemptions:
            claim_cr = by_key.get(preemptor)
            if claim_cr is None or \
                    not colocate.is_serving_claim_cr(claim_cr):
                continue
            victim_cr = by_key.get(victim)
            if victim_cr is None:
                continue
            vmeta = victim_cr.get("metadata", {})
            vns = vmeta.get("namespace", "kubeflow")
            cmeta = claim_cr.get("metadata", {})
            cns = cmeta.get("namespace", "kubeflow")
            cname = cmeta.get("name", "")
            image = (((claim_cr.get("spec") or {}).get("worker")
                      or {}).get("image")
                     or colocate.DEFAULT_SERVING_IMAGE)
            nodes = set()
            for pod in self.kube.list_pods(
                    vns, labels={LABEL_JOB: vmeta.get("name", "")}):
                node = (pod.get("spec") or {}).get("nodeName")
                if node:
                    nodes.add(node)
            for node in sorted(nodes):
                pod = colocate.build_prepull_pod(cns, cname, node,
                                                 image)
                try:
                    self.kube.create_pod(pod)
                except Conflict:
                    pass
                self._prepull.setdefault(preemptor, set()).add(
                    (cns, pod["metadata"]["name"]))
        for ckey in list(self._prepull):
            claim_cr = by_key.get(ckey)
            done = claim_cr is None
            if not done:
                want = int((claim_cr.get("spec") or {})
                           .get("numSlices", 0) or 0)
                done = self.scheduler.claim_count(ckey) >= want
            if done:
                for ns, name in self._prepull.pop(ckey):
                    try:
                        self.kube.delete_pod(ns, name)
                    except NotFound:
                        pass

    # -- fused gangs -------------------------------------------------------

    def _fused_gang_spec(self, job: crd.TPUJobSpec,
                         decision) -> crd.TPUJobSpec:
        """The shared workload spec for a fused gang: the member's spec
        renamed to the gang's pod/service-safe name, with the member
        roster injected so the worker entrypoint can build its
        FusedTrainer member array."""
        member_names = ",".join(
            k.split("/", 1)[-1] for k in decision.fused_members)
        worker = dataclasses.replace(
            job.worker,
            env={**job.worker.env, "KFT_FUSED_MEMBERS": member_names})
        return dataclasses.replace(
            job, name=fuse.fused_gang_name(decision.fused_gang),
            worker=worker)

    def _reconcile_fused_member(self, cr_obj: dict, job: crd.TPUJobSpec,
                                status: dict, phase: str, key: str,
                                decision) -> str:
        """Drive one member CR of a fused gang.

        The gang claim, pod set and grace deadline are keyed on the
        FUSED key and shared by every member; each member CR keeps its
        own phase/events/restart budget/resumable flag.  Every step is
        idempotent, so whichever member reconciles first performs the
        shared action (offer, pod creation, teardown) and its peers
        observe the result in the same sweep.
        """
        gkey = decision.fused_gang
        gang = self._fused_gang_spec(job, decision)
        admitted = self.scheduler.admitted(gkey)
        pods = self.kube.list_pods(job.namespace,
                                   labels={LABEL_JOB: gang.name})
        pod_phases = [(p.get("status") or {}).get("phase", PENDING)
                      for p in pods]

        # Completion first: it outranks both preemption (a gang that
        # finishes during the grace is a completion, not an eviction)
        # and the post-release sweep order (a peer may have released
        # the claim moments ago).
        if pods and len(pods) == gang.num_workers and all(
                ph == SUCCEEDED for ph in pod_phases):
            self.kube.record_event(
                job.namespace, f"TPUJob/{job.name}",
                "FusedMemberCompleted",
                f"fused gang {gkey} completed; member done")
            self._set_phase(cr_obj, JOB_SUCCEEDED,
                            reason="AllWorkersDone",
                            message=f"fused gang {gkey} completed")
            if admitted:
                self.scheduler.release(gkey)
                self._admitted_at.pop(gkey, None)
                self._preempt_deadline.pop(gkey, None)
            if self.cluster is not None:
                self.cluster.forget(key)
            return JOB_SUCCEEDED

        if decision.action == "preempt":
            if not admitted:
                # A peer already tore the gang down this sweep.
                if phase != QUEUED:
                    if self.cluster is not None:
                        self.cluster.note_preempted(key)
                    self._set_phase(
                        cr_obj, QUEUED, reason="PreemptedRequeued",
                        message="fused gang preempted; member resumes "
                                "from its own checkpoint",
                        extra={"resumable": True, "fusedGang": "",
                               "fusedMembers": 0})
                return QUEUED
            now = faults.monotonic()
            grace = (self.cluster.config.preemption.grace_period_s
                     if self.cluster is not None else 0.0)
            if decision.grace_s >= 0:
                grace = decision.grace_s
            deadline = self._preempt_deadline.setdefault(
                gkey, now + grace)
            if phase != JOB_PREEMPTING:
                preemptions = int(status.get("preemptions", 0))
                self.kube.record_event(
                    job.namespace, f"TPUJob/{job.name}", "Preempted",
                    f"{decision.message}; checkpoint grace {grace:g}s",
                    type_="Warning")
                self._set_phase(
                    cr_obj, JOB_PREEMPTING, reason="Preempted",
                    message=(f"{decision.message}; "
                             f"checkpoint grace {grace:g}s"),
                    extra={"resumable": True,
                           "preemptions": preemptions + 1})
            if now < deadline:
                return JOB_PREEMPTING
            # Grace spent: THIS member performs the shared teardown;
            # peers requeue through the not-admitted branch above.
            self._teardown_pods(gang)
            self.scheduler.release(gkey)
            self._admitted_at.pop(gkey, None)
            self._preempt_deadline.pop(gkey, None)
            if self.cluster is not None:
                self.cluster.note_preempted(key)
            self.metrics.append({"event": "gang_preempted", "job": gkey,
                                 "member": key,
                                 "preemptor": decision.preemptor})
            self._set_phase(
                cr_obj, QUEUED, reason="PreemptedRequeued",
                message="fused gang preempted; member resumes from "
                        "its own checkpoint",
                extra={"resumable": True, "fusedGang": "",
                       "fusedMembers": 0})
            return QUEUED

        if decision.action == "unsatisfiable":
            self._set_phase(cr_obj, JOB_FAILED,
                            reason=decision.reason or
                            "UnsatisfiableResources",
                            message=decision.message)
            if self.cluster is not None:
                self.cluster.forget(key)
            return JOB_FAILED
        if decision.action != "admit":
            reason = decision.reason or "WaitingForSlices"
            if phase != QUEUED or status.get("reason") != reason:
                self._set_phase(cr_obj, QUEUED, reason=reason,
                                message=decision.message)
            return QUEUED

        if admitted and phase == JOB_PREEMPTING:
            # The plan withdrew the gang's eviction mid-grace: every
            # member reverts its own stamps (deadline pop idempotent).
            self._preempt_deadline.pop(gkey, None)
            status = dict(status)
            status["resumable"] = False
            status["preemptions"] = max(
                0, int(status.get("preemptions", 1)) - 1)
            cr_obj["status"] = status
            self.kube.record_event(
                job.namespace, f"TPUJob/{job.name}",
                "PreemptionCancelled", decision.message)
        if not admitted:
            admitted = self.scheduler.offer(
                gkey, job.slice_type, job.num_slices, queue="fused")
            if not admitted:
                if phase != QUEUED:
                    self._set_phase(
                        cr_obj, QUEUED, reason="WaitingForSlices",
                        message=f"fused gang {gkey} awaiting slices")
                return QUEUED
            self._admitted_at.setdefault(gkey, faults.monotonic())
        stamp: dict = {}
        if not status.get("fusedGang"):
            # First admission of THIS member into the gang: count it,
            # consume its resumable flag, stamp the gang reference
            # (persisted by the guaranteed phase transition below).
            if self.cluster is not None:
                self.cluster.note_admitted(
                    key, backfilled=decision.backfilled,
                    resumed=bool(status.get("resumable")))
            self.kube.record_event(
                job.namespace, f"TPUJob/{job.name}",
                "FusedMemberAdmitted",
                f"admitted as member of fused gang {gkey} "
                f"({len(decision.fused_members)} members)")
            stamp = {"fusedGang": gkey,
                     "fusedMembers": len(decision.fused_members),
                     "resumable": False}

        # Materialize the SHARED service + pod gang (idempotent; any
        # member creates, Conflict means a peer won the race).
        try:
            self.kube.create_service(build_headless_service(gang))
        except Conflict:
            pass
        existing = {p["metadata"]["name"] for p in pods}
        restarts = int(status.get("restarts", 0))
        avoid_nodes = self.quarantine.quarantined()
        for i in range(gang.num_workers):
            name = worker_name(gang.name, i)
            if name not in existing:
                if phase == JOB_RUNNING:
                    return self._fused_member_restart(
                        cr_obj, gang, key, gkey, restarts, stamp,
                        reason="WorkerLost",
                        message=f"{name} disappeared while Running")
                try:
                    self.kube.create_pod(
                        build_worker_pod(gang, i, avoid_nodes))
                except Conflict:
                    pass

        pods = self.kube.list_pods(job.namespace,
                                   labels={LABEL_JOB: gang.name})
        pod_phases = [(p.get("status") or {}).get("phase", PENDING)
                      for p in pods]
        if any(ph == FAILED for ph in pod_phases):
            return self._fused_member_restart(
                cr_obj, gang, key, gkey, restarts, stamp,
                reason="WorkerFailed",
                message=f"{pod_phases.count(FAILED)} worker(s) failed")
        if len(pods) == gang.num_workers and all(
                ph in (RUNNING, SUCCEEDED) for ph in pod_phases):
            if phase != JOB_RUNNING:
                latency = faults.monotonic() - self._admitted_at.get(
                    gkey, faults.monotonic())
                self.metrics.append({
                    "event": "gang_running", "job": key,
                    "fused_gang": gkey,
                    "schedule_to_running_s": latency,
                })
                from kubeflow_tpu_torch.runtime.prom import REGISTRY

                REGISTRY.histogram(
                    "kft_gang_schedule_to_running_seconds",
                    "gang admission to all-workers-running latency",
                    buckets=(1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0,
                             300.0, 600.0),
                ).observe(latency)
                self._set_phase(cr_obj, JOB_RUNNING,
                                reason="GangRunning",
                                message=f"fused gang {gkey} running",
                                extra={"restarts": restarts, **stamp})
            return JOB_RUNNING
        if phase != STARTING or status.get("restarts") != restarts \
                or stamp:
            self._set_phase(cr_obj, STARTING, reason="CreatingWorkers",
                            message=f"{pod_phases.count(RUNNING)}/"
                                    f"{gang.num_workers} running in "
                                    f"fused gang {gkey}",
                            extra={"restarts": restarts, **stamp})
        return STARTING

    def _fused_member_restart(self, cr_obj: dict, gang: crd.TPUJobSpec,
                              key: str, gkey: str, restarts: int,
                              stamp: dict, reason: str,
                              message: str) -> str:
        """Member-side view of a fused gang restart: the shared pods
        are torn down once (idempotent), each member charges its OWN
        restart budget, and the runtime re-enters through per-member
        ``restore_or_init`` with only still-active members unmasked."""
        self._note_worker_failures(
            gang, self.kube.list_pods(gang.namespace,
                                      labels={LABEL_JOB: gang.name}),
            restarts)
        if restarts + 1 > gang.restart.max_restarts:
            self._set_phase(cr_obj, JOB_FAILED,
                            reason="MaxRestartsExceeded",
                            message=f"{message}; restarts={restarts}",
                            extra={"restarts": restarts})
            self._teardown_pods(gang)
            self.scheduler.release(gkey)
            self._admitted_at.pop(gkey, None)
            return JOB_FAILED
        self.kube.record_event(
            gang.namespace, f"TPUJob/{key.split('/', 1)[-1]}", reason,
            f"{message}; fused gang restart {restarts + 1}/"
            f"{gang.restart.max_restarts} from per-member checkpoints",
            type_="Warning")
        self._teardown_pods(gang)
        self.metrics.append({"event": "gang_restart", "job": gkey,
                             "member": key, "restart": restarts + 1,
                             "reason": reason})
        self._set_phase(cr_obj, STARTING, reason=reason,
                        message=f"fused gang restart {restarts + 1}",
                        extra={"restarts": restarts + 1, **stamp})
        return STARTING

    # -- helpers ----------------------------------------------------------

    def _preempt(self, cr_obj: dict, job: crd.TPUJobSpec,
                 status: dict, decision) -> str:
        """Drive one job through eviction: grace window, then teardown
        and a ``resumable`` re-queue.

        The grace deadline lives on the skewable policy clock
        (``faults.monotonic``) in controller memory, not CR status —
        it is an operator-process promise (like ``_admitted_at``), and
        an operator restart simply restarts the window, which only
        ever gives the victim MORE time to checkpoint."""
        key = f"{job.namespace}/{job.name}"
        now = faults.monotonic()
        grace = (self.cluster.config.preemption.grace_period_s
                 if self.cluster is not None else 0.0)
        if decision.grace_s >= 0:
            # Per-victim override (scheduler/colocate.py): a serving
            # preemptor drains its victim on the short serving grace.
            grace = decision.grace_s
        deadline = self._preempt_deadline.get(key)
        preemptions = int(status.get("preemptions", 0))
        if deadline is None:
            self._preempt_deadline[key] = now + grace
            self.kube.record_event(
                job.namespace, f"TPUJob/{job.name}", "Preempted",
                f"{decision.message}; checkpoint grace {grace:g}s",
                type_="Warning")
            self._set_phase(
                cr_obj, JOB_PREEMPTING, reason="Preempted",
                message=(f"{decision.message}; "
                         f"checkpoint grace {grace:g}s"),
                extra={"resumable": True,
                       "preemptions": preemptions + 1})
            return JOB_PREEMPTING
        if now < deadline:
            return JOB_PREEMPTING
        # Grace spent: tear the gang down through the same machinery a
        # worker failure uses and hand the slices back.  The job
        # re-queues resumable — its next admission restarts the gang,
        # and the trainer's restore_or_init picks up the latest
        # checkpoint (no step-0 retraining).
        self._teardown_pods(job)
        self.scheduler.release(key)
        self._admitted_at.pop(key, None)
        self._preempt_deadline.pop(key, None)
        if self.cluster is not None:
            self.cluster.note_preempted(key)
        self.metrics.append({"event": "gang_preempted", "job": key,
                             "preemptor": decision.preemptor})
        self._set_phase(
            cr_obj, QUEUED, reason="PreemptedRequeued",
            message="awaiting re-admission; resumes from latest "
                    "checkpoint",
            extra={"resumable": True})
        return QUEUED

    def _note_worker_failures(self, job: crd.TPUJobSpec,
                              pods: List[dict],
                              restarts: int) -> None:
        """Attribute FAILED pods to their nodes; a node that trips the
        quarantine threshold gets one NodeQuarantined event and is
        excluded from placement until its cooldown expires.  Each
        (pod, restart-generation) counts ONCE — a Failed pod lingering
        through its deletion grace must not re-count every sweep."""
        key = f"{job.namespace}/{job.name}"
        seen = self._attributed.setdefault(key, set())
        for pod in pods:
            if (pod.get("status") or {}).get("phase") != FAILED:
                continue
            mark = (pod["metadata"]["name"], restarts)
            if mark in seen:
                continue
            seen.add(mark)
            node = (pod.get("spec") or {}).get("nodeName") or ""
            if self.quarantine.note_failure(node):
                self.kube.record_event(
                    job.namespace, f"node/{node}", "NodeQuarantined",
                    f"{self.quarantine.threshold} worker failures "
                    f"within {self.quarantine.window_s:g}s (last: "
                    f"{pod['metadata']['name']} of {key}); excluded "
                    f"from gang placement for "
                    f"{self.quarantine.cooldown_s:g}s",
                    type_="Warning")
                self.metrics.append({"event": "node_quarantined",
                                     "node": node, "job": key})

    def _gang_restart(self, cr_obj: dict, job: crd.TPUJobSpec,
                      restarts: int, reason: str, message: str) -> str:
        key = f"{job.namespace}/{job.name}"
        self._note_worker_failures(
            job, self.kube.list_pods(job.namespace,
                                     labels={LABEL_JOB: job.name}),
            restarts)
        if restarts + 1 > job.restart.max_restarts:
            self._set_phase(cr_obj, JOB_FAILED, reason="MaxRestartsExceeded",
                            message=f"{message}; restarts={restarts}",
                            extra={"restarts": restarts})
            self._teardown_pods(job)
            self.scheduler.release(key)
            self._admitted_at.pop(key, None)
            return JOB_FAILED
        self.kube.record_event(
            job.namespace, f"TPUJob/{job.name}", reason,
            f"{message}; gang restart {restarts + 1}/"
            f"{job.restart.max_restarts} from checkpoint", type_="Warning",
        )
        self._teardown_pods(job)
        self.metrics.append({"event": "gang_restart", "job": key,
                             "restart": restarts + 1, "reason": reason})
        self._set_phase(cr_obj, STARTING, reason=reason,
                        message=f"gang restart {restarts + 1}",
                        extra={"restarts": restarts + 1})
        return STARTING

    def _teardown_pods(self, job: crd.TPUJobSpec) -> None:
        for pod in self.kube.list_pods(job.namespace,
                                       labels={LABEL_JOB: job.name}):
            try:
                self.kube.delete_pod(job.namespace, pod["metadata"]["name"])
            except NotFound:
                pass

    def _set_phase(self, cr_obj: dict, phase: str, reason: str = "",
                   message: str = "", extra: Optional[dict] = None) -> None:
        meta = cr_obj["metadata"]
        status = dict(cr_obj.get("status", {}) or {})
        status.update({
            "phase": phase,
            "reason": reason,
            "message": message,
            # Wall-clock CR status stamp read by kubectl/humans — not
            # a policy decision.
            # kft: allow=clock-discipline
            "lastTransition": time.time(),
            **(extra or {}),
        })
        cr_obj["status"] = status
        self.kube.update_custom_status(
            meta.get("namespace", "default"), meta["name"], status
        )
        self.kube.record_event(
            meta.get("namespace", "default"), f"TPUJob/{meta['name']}",
            reason or phase, message or phase,
        )
        self._trace_transition(self._trace_key(meta), phase, reason,
                               message)

    @staticmethod
    def _trace_key(meta: dict) -> str:
        """The one job-trace key derivation, shared by the stamping
        site (_set_phase) and the prune sweep (reconcile_all) — if
        they diverged, a live job's trace state would be wiped every
        sweep."""
        return (f"{meta.get('namespace', 'default')}/"
                f"{meta.get('name', '')}")

    def _trace_transition(self, key: str, phase: str, reason: str,
                          message: str) -> None:
        """Job-lifecycle spans, drain-time stamped: each phase the job
        dwelled in becomes one span (annotated with the queue/quota/
        preemption reason that ENDED it), and the terminal transition
        stamps the root span — Failed jobs complete with status
        "error", so tail sampling always retains them."""
        if not tracing.enabled():
            self._job_traces.pop(key, None)
            return
        now = time.perf_counter()
        tr = self._job_traces.get(key)
        if tr is not None and tr.get("done"):
            # Already terminally stamped.  A permanently invalid CR
            # re-enters the Failed path EVERY sweep (its spec parse
            # fails before the terminal short-circuit); without this
            # tombstone each sweep would mint a fresh error-retained
            # trace and LRU-flush the store in minutes.  The entry
            # stays (bounded by live CRs, like _admitted_at) until the
            # prune sweep sees the CR vanish.
            return
        if tr is None:
            tr = self._job_traces[key] = {
                "t0": now, "phase": None, "since": now, "spans": []}
        prev = tr["phase"]
        if prev is not None and prev != phase:
            # Phase spans buffer in CONTROLLER memory (bounded: a few
            # phases per job) and stamp at the terminal transition —
            # a job Running for hours must not depend on the store's
            # open-trace aging to keep its earlier phases.
            tr["spans"].append(
                (f"job.{prev}", tr["since"], now,
                 {"job": key, "to": phase, "reason": reason,
                  "message": message}))
            tr["since"] = now
        tr["phase"] = phase
        if phase in TERMINAL:
            ctx = tracing.new_root_ctx()
            if ctx is not None:
                for name, start, end, attrs in tr["spans"]:
                    tracing.record_span(name, ctx, start, end,
                                        attrs=attrs)
                tracing.record_span(
                    "job.lifecycle", ctx, tr["t0"], now,
                    status="ok" if phase == JOB_SUCCEEDED
                    else "error",
                    attrs={"job": key, "phase": phase,
                           "reason": reason, "message": message},
                    root=True)
            tr["spans"] = []
            tr["done"] = True
