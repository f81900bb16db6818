"""Fleet router entry point (the port's copy of kubeflow_tpu/fleet/main.py,
with its flags).

Runs the load-aware router (and optionally the autoscaler) in front of
a fleet of serving replicas:

  python -m kubeflow_tpu_torch.fleet.main --port 8080 \\
      --endpoints http://replica-0:8000,http://replica-1:8000

or, discovering replicas from the cluster through a Service-style
label selector, readiness-probed and load-scraped directly:

  python -m kubeflow_tpu_torch.fleet.main --port 8080 \\
      --kube_namespace kubeflow --kube_selector app=tpu-serving \\
      --autoscale_deployment tpu-serving --no-colocation

Without ``--no-colocation`` the autoscaler claims GPUs from the shared
train/serve pool through the scheduler's ``ServingClaimClient``
(scheduler/colocate.py): its desired replica count becomes a
high-priority claim CR that the operator's cluster scheduler arbitrates
against training, and the router's status route shows the pool the
reconciler stamps on the claim.  ``KFT_ROUTER_READY rest=PORT`` on
stderr marks the listener up (``--port 0`` binds any free port).

SIGTERM drains like serving/main.py: /readyz flips 503 immediately,
in-flight proxied requests finish inside --drain_deadline_s, then the
listener closes.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time

from kubeflow_tpu_torch.fleet.autoscaler import Autoscaler
from kubeflow_tpu_torch.fleet.endpoints import (
    EndpointRegistry,
    KubeEndpoints,
    StaticEndpoints,
)
from kubeflow_tpu_torch.fleet.router import FleetRouter, make_router_server
from kubeflow_tpu_torch.testing import faults


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-router")
    ap.add_argument("--port", type=int, default=8080,
                    help="router REST port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--endpoints", default="",
                    help="comma-separated static replica base URLs "
                         "(http://host:port); empty = kube discovery")
    ap.add_argument("--kube_base_url", default="",
                    help="apiserver base URL (empty = in-cluster env)")
    ap.add_argument("--kube_namespace", default="kubeflow")
    ap.add_argument("--kube_selector", default="app=tpu-serving",
                    help="label selector for replica pods, k=v[,k=v]")
    ap.add_argument("--replica_port", type=int, default=8000,
                    help="replica REST port when the pod spec names "
                         "none")
    ap.add_argument("--probe_interval_s", type=float, default=1.0,
                    help="readiness-probe + load-scrape period (also "
                         "the ejection detection latency bound)")
    ap.add_argument("--probe_timeout_s", type=float, default=2.0)
    ap.add_argument("--max_tries", type=int, default=3,
                    help="distinct replicas one request may be "
                         "offered to (1 = no retries)")
    ap.add_argument("--try_timeout_s", type=float, default=120.0,
                    help="per-attempt upstream socket timeout (a "
                         "request deadline tightens it further)")
    ap.add_argument("--retry_budget_ratio", type=float, default=0.2,
                    help="retry tokens deposited per admitted request "
                         "— bounds retries to this fraction of live "
                         "traffic")
    ap.add_argument("--max_replays", type=int, default=2,
                    help="per-request cap on idempotent-POST replays "
                         "after a transport failure (resume-based "
                         "failover for :generate streams; 0 restores "
                         "the never-replay 502 semantics)")
    ap.add_argument("--eject_threshold", type=int, default=3,
                    help="consecutive failures that eject a replica")
    ap.add_argument("--eject_backoff_s", type=float, default=1.0,
                    help="initial ejection backoff (doubles per "
                         "failed half-open probe, jittered)")
    ap.add_argument("--eject_backoff_cap_s", type=float, default=30.0)
    ap.add_argument("--autoscale_deployment", default="",
                    help="serving Deployment to scale (empty = "
                         "autoscaler off)")
    ap.add_argument("--autoscale_target_inflight", type=float,
                    default=4.0,
                    help="per-replica in-flight+queued target the "
                         "desired count is computed from")
    ap.add_argument("--autoscale_tolerance", type=float, default=0.2,
                    help="hysteresis band around current capacity")
    ap.add_argument("--min_replicas", type=int, default=1)
    ap.add_argument("--max_replicas", type=int, default=8)
    ap.add_argument("--scale_up_cooldown_s", type=float, default=10.0)
    ap.add_argument("--scale_down_cooldown_s", type=float,
                    default=60.0)
    ap.add_argument("--autoscale_interval_s", type=float, default=2.0)
    ap.add_argument("--no-colocation", dest="no_colocation",
                    action="store_true",
                    help="legacy direct spec.replicas patching: scale "
                         "without claiming GPUs from the shared "
                         "train/serve pool arbiter")
    ap.add_argument("--claim_slice_type", default="h100-8",
                    help="gang shape one serving replica occupies in "
                         "the shared pool (colocation mode)")
    ap.add_argument("--claim_tenant", default="fleet",
                    help="tenant the serving claim bills")
    ap.add_argument("--claim_priority", default="high",
                    help="priority class of the serving claim — must "
                         "outrank preemptible training to steal GPUs "
                         "under load")
    ap.add_argument("--claim_image", default="",
                    help="serving image prepull pods warm on freeing "
                         "nodes (empty = the colocate default)")
    ap.add_argument("--drain_deadline_s", type=float, default=30.0)
    from kubeflow_tpu_torch.runtime import tracing

    tracing.add_cli_args(ap)
    return ap


def main(argv=None) -> int:
    from kubeflow_tpu_torch.runtime import tracing

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    if tracing.enable_from_args(args) is not None:
        logging.info("request tracing on (sample rate %g) — "
                     "GET /debug/traces", args.trace_sample_rate)
    if faults.install_from_env() is not None:
        logging.warning("fault injection ACTIVE (KFT_FAULTS set)")

    kube = None
    if args.endpoints:
        source = StaticEndpoints.from_urls(
            [u.strip() for u in args.endpoints.split(",") if u.strip()])
    else:
        from kubeflow_tpu_torch.operator.kube_http import HttpKube

        kube = HttpKube(base_url=args.kube_base_url or None)
        labels = dict(
            kv.split("=", 1)
            for kv in args.kube_selector.split(",") if "=" in kv)
        source = KubeEndpoints(kube, args.kube_namespace, labels,
                               default_port=args.replica_port)
    registry = EndpointRegistry(
        source,
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        eject_threshold=args.eject_threshold,
        eject_backoff_s=args.eject_backoff_s,
        eject_backoff_cap_s=args.eject_backoff_cap_s)
    registry.refresh()
    registry.start()
    claims = None
    if args.autoscale_deployment and not args.no_colocation:
        from kubeflow_tpu_torch.scheduler.colocate import ServingClaimClient

        if kube is None:
            from kubeflow_tpu_torch.operator.kube_http import HttpKube

            kube = HttpKube(base_url=args.kube_base_url or None)
        claim_kwargs = dict(
            slice_type=args.claim_slice_type,
            tenant=args.claim_tenant,
            priority=args.claim_priority)
        if args.claim_image:
            claim_kwargs["image"] = args.claim_image
        claims = ServingClaimClient(
            kube, args.kube_namespace, args.autoscale_deployment,
            **claim_kwargs)
    router = FleetRouter(
        registry, max_tries=args.max_tries,
        try_timeout_s=args.try_timeout_s,
        retry_budget_ratio=args.retry_budget_ratio,
        max_replays=args.max_replays,
        pool_status=claims.pool if claims is not None else None)
    httpd, _ = make_router_server(router, port=args.port,
                                  host=args.host)
    autoscaler = None
    if args.autoscale_deployment:
        if kube is None:
            from kubeflow_tpu_torch.operator.kube_http import HttpKube

            kube = HttpKube(base_url=args.kube_base_url or None)
        autoscaler = Autoscaler(
            kube, args.kube_namespace, args.autoscale_deployment,
            registry,
            target_inflight_per_replica=args.autoscale_target_inflight,
            tolerance=args.autoscale_tolerance,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            scale_up_cooldown_s=args.scale_up_cooldown_s,
            scale_down_cooldown_s=args.scale_down_cooldown_s,
            claims=claims)
        autoscaler.start(args.autoscale_interval_s)
    logging.info("fleet router on :%d (%d endpoints discovered%s)",
                 httpd.server_address[1], len(registry.all()),
                 ", autoscaler on" if autoscaler else "")
    print(f"KFT_ROUTER_READY rest={httpd.server_address[1]}",
          file=sys.stderr, flush=True)

    stop = threading.Event()

    def on_signal(*_):
        router.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    stop.wait()
    # Drain: readiness already flipped in the handler; give proxied
    # in-flight requests their budget before the listener closes.
    deadline = faults.monotonic() + max(0.0, args.drain_deadline_s)
    while faults.monotonic() < deadline and any(
            s.local_inflight for s in registry.all()):
        time.sleep(0.05)
    if autoscaler is not None:
        autoscaler.stop()
    registry.stop()
    httpd.shutdown()
    httpd.server_close()
    router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
