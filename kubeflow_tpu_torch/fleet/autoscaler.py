"""Metrics-driven horizontal autoscaler for the serving Deployment (the
port's copy of kubeflow_tpu/fleet/autoscaler.py, stdlib only).

A level-triggered reconcile loop in the operator/reconciler.py mold:
each pass reads the fleet's scraped load (the endpoint registry's
kft_serving_inflight + kft_serving_queue_depth gauges, see
fleet/endpoints.py), computes a desired replica count from a target
per-replica in-flight utilization, and — when hysteresis and cooldowns
agree — patches the Deployment's spec.replicas through the kube client
(FakeKube / HttpKube / RealKube all speak patch_deployment_scale).

Policy, in order:
  desired0  = ceil(total_load / target_inflight_per_replica)
  hysteresis: stay at the current count while the load is inside the
              tolerance band around current capacity — scale only on a
              signal strong enough to be worth a rollout
  cooldown:   scale-ups wait scale_up_cooldown_s after ANY scale event,
              scale-downs wait the (longer) scale_down_cooldown_s —
              asymmetric on purpose: under-capacity sheds traffic,
              over-capacity just costs money
  bounds:     clamp to [min_replicas, max_replicas]

Every policy clock reads testing/faults.monotonic(), so chaos tests
walk cooldown windows by skewing the clock instead of sleeping.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, Optional

from kubeflow_tpu_torch.fleet.endpoints import EndpointRegistry
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)

DESIRED_GAUGE = "kft_autoscaler_desired_replicas"
DESIRED_HELP = "replica count the autoscaler last computed"
OBSERVED_GAUGE = "kft_autoscaler_observed_load"
OBSERVED_HELP = "summed scraped in-flight + queue depth across replicas"
READY_GAUGE = "kft_autoscaler_ready_replicas"
READY_HELP = "replicas answering /readyz ready at the last pass"
SCALE_EVENTS_TOTAL = "kft_autoscaler_scale_events_total"
SCALE_EVENTS_HELP = "applied scale patches, by direction"


class Autoscaler:
    """Reconciling replica-count controller over one Deployment."""

    def __init__(self, kube: Any, namespace: str, deployment: str,
                 registry: EndpointRegistry, *,
                 target_inflight_per_replica: float = 4.0,
                 tolerance: float = 0.2,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 scale_up_cooldown_s: float = 10.0,
                 scale_down_cooldown_s: float = 60.0,
                 claims: Any = None):
        if target_inflight_per_replica <= 0:
            raise ValueError("target_inflight_per_replica must be > 0")
        self._kube = kube
        self._namespace = namespace
        self._deployment = deployment
        self._registry = registry
        # Colocation mode: a claims client (duck-typed: ``sync(desired)``
        # returning the claim's view, ``pool()`` for the router's status
        # route; the JAX package's scheduler/colocate.py
        # ServingClaimClient, whose port comes with the scheduler)
        # translates the desired count into a claim on the shared GPU
        # pool; the cluster reconciler patches spec.replicas on grant.
        # None = the direct-patch path (--no-colocation).
        self._claims = claims
        self._last_claim_desired: Optional[int] = None
        self.target = float(target_inflight_per_replica)
        self.tolerance = float(tolerance)
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self._up_cooldown_s = scale_up_cooldown_s
        self._down_cooldown_s = scale_down_cooldown_s
        # Policy clock of the LAST applied scale event; -inf so the
        # first pass is never cooldown-gated.
        self._last_scale_t = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one reconcile pass ------------------------------------------------

    def reconcile_once(self) -> Dict[str, Any]:
        """Observe -> decide -> (maybe) patch.  Returns the decision
        record (also exported as kft_autoscaler_* gauges) — idempotent
        and safe to call at any cadence, like the TPUJob reconciler."""
        now = faults.monotonic()
        load = self._registry.total_load()
        ready = self._registry.ready_count()
        current = int(self._kube.get_deployment(
            self._namespace, self._deployment)
            .get("spec", {}).get("replicas", 0))
        desired = self._decide(load, current, now)
        applied = False
        claim = None
        if self._claims is not None:
            # Colocation: desire goes into the claim CR, never onto
            # spec.replicas — the arbiter's reconciler patches that on
            # grant.  Synced every pass (level-triggered, idempotent)
            # so the verdict and pool snapshot stay fresh; a scale
            # EVENT is only the desired count actually changing.
            changed = desired != self._last_claim_desired
            claim = self._claims.sync(desired)
            self._last_claim_desired = desired
            if changed and desired != current:
                self._last_scale_t = now
                applied = True
                direction = "up" if desired > current else "down"
                REGISTRY.counter(
                    SCALE_EVENTS_TOTAL,
                    SCALE_EVENTS_HELP).inc(direction=direction)
                log.info("claimed %s/%s %d -> %d replicas (load %.1f, "
                         "state %s)", self._namespace,
                         self._deployment, current, desired, load,
                         claim.get("state"))
        elif desired != current:
            self._kube.patch_deployment_scale(
                self._namespace, self._deployment, desired)
            self._last_scale_t = now
            applied = True
            direction = "up" if desired > current else "down"
            REGISTRY.counter(SCALE_EVENTS_TOTAL,
                             SCALE_EVENTS_HELP).inc(direction=direction)
            log.info("scaled %s/%s %d -> %d (load %.1f, target %.1f "
                     "per replica)", self._namespace, self._deployment,
                     current, desired, load, self.target)
        REGISTRY.gauge(DESIRED_GAUGE, DESIRED_HELP).set(desired)
        REGISTRY.gauge(OBSERVED_GAUGE, OBSERVED_HELP).set(load)
        REGISTRY.gauge(READY_GAUGE, READY_HELP).set(ready)
        record = {"load": load, "ready": ready, "current": current,
                  "desired": desired, "applied": applied}
        if claim is not None:
            record["claim"] = claim
        return record

    def _decide(self, load: float, current: int, now: float) -> int:
        raw = math.ceil(load / self.target) if load > 0 else \
            self.min_replicas
        desired = min(self.max_replicas, max(self.min_replicas, raw))
        if desired == current or current == 0:
            # current == 0: a scaled-to-zero or just-created Deployment
            # has no capacity band to hold — go straight to desired.
            return desired
        capacity = current * self.target
        if desired > current:
            # Hysteresis: inside the band, the current count still
            # fits; a rollout needs a real signal.
            if load <= capacity * (1.0 + self.tolerance):
                return current
            if now - self._last_scale_t < self._up_cooldown_s:
                return current
        else:
            # Band guard only while there IS load: at load == 0 the
            # inequality degenerates to 0 >= 0 at current == 1 and
            # would pin a scale-to-zero fleet at one replica forever.
            if load > 0 and load >= capacity * (1.0 - self.tolerance) \
                    * (current - 1) / current:
                # The load still needs more than (current - 1)
                # replicas' worth of tolerated capacity — dropping one
                # would immediately re-trigger a scale-up.
                return current
            if now - self._last_scale_t < self._down_cooldown_s:
                return current
        return desired

    # -- control loop ------------------------------------------------------

    def start(self, interval_s: float = 2.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.reconcile_once()
                except Exception:
                    # Reconcile weather (apiserver blip, scrape gap)
                    # must not kill the loop — level-triggered means
                    # the next pass repairs it.
                    log.exception("autoscaler reconcile failed")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
