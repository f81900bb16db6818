"""Operator daemon entrypoint: the port's copy of
kubeflow_tpu/operator/main.py, with the port's GPU shapes in the default
inventory.  Run ``python -m kubeflow_tpu_torch.operator.main --fake-kube``
for the in-memory cluster.

Deployable heir of the tf-operator Deployment the reference's manifests
created (kubeflow/core/tf-job-operator.libsonnet:61-125): watches TPUJob
CRs and reconciles gangs.  Slice inventory comes from --inventory
(type=count pairs) or, on a real cluster, from node-pool discovery via the
kubernetes client (operator/kube_real.py, used when --kubeconfig is
given or in-cluster config is present).
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_inventory(pairs) -> dict:
    out = {}
    for pair in pairs:
        slice_type, _, count = pair.partition("=")
        out[slice_type] = int(count or "1")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-operator")
    # cpu-N gangs are schedulable anywhere, so a little CPU capacity is
    # in the default inventory — GPU-less clusters (kind E2E) work out
    # of the box.
    ap.add_argument("--inventory", nargs="*",
                    default=["h100-8=4", "cpu-1=4"],
                    help="slice capacity, e.g. h100-32=2 h100-8=4")
    ap.add_argument("--namespace", default="",
                    help="informational; CRs are watched cluster-wide")
    ap.add_argument("--controller-config-file", default="",
                    help="operator ConfigMap file (manifests/tpujob.py "
                         "controller_config); an 'inventory' key there "
                         "overrides --inventory")
    ap.add_argument("--poll-interval-s", type=float, default=2.0)
    ap.add_argument("--max-iterations", type=int, default=0,
                    help="stop after N reconcile passes (0 = forever)")
    ap.add_argument("--fake-kube", action="store_true",
                    help="run against the in-memory cluster (demo/tests)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus /metrics on this port (0=off); "
                         "also serves the scheduler queue at /queue")
    ap.add_argument("--no-scheduler", action="store_true",
                    help="disable the multi-tenant policy layer and "
                         "admit jobs gang-FIFO (the pre-scheduler "
                         "behavior)")
    from kubeflow_tpu_torch.runtime import tracing

    tracing.add_cli_args(ap, dashes=True)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    tracing.enable_from_args(args)
    from kubeflow_tpu_torch.operator.gang import GangScheduler
    from kubeflow_tpu_torch.operator.kube import FakeKube
    from kubeflow_tpu_torch.operator.reconciler import TPUJobController
    from kubeflow_tpu_torch.scheduler import ClusterScheduler, SchedulerConfig

    inventory = parse_inventory(args.inventory)
    scheduler_config = SchedulerConfig()
    if args.controller_config_file:
        import json

        with open(args.controller_config_file) as f:
            config = json.load(f)
        if "inventory" in config:
            inventory = {k: int(v) for k, v in config["inventory"].items()}
        if "scheduler" in config:
            scheduler_config = SchedulerConfig.from_dict(
                config["scheduler"])

    if args.fake_kube:
        kube = FakeKube()
    else:
        kube = None
        try:
            from kubeflow_tpu_torch.operator.kube_real import RealKube

            kube = RealKube()
        except ImportError:
            # The official client is an optional dependency; the stdlib
            # REST backend serves the same surface with in-cluster
            # service-account credentials (operator/kube_http.py) and is
            # integration-tested over real sockets in the suite.
            try:
                from kubeflow_tpu_torch.operator.kube_http import HttpKube

                kube = HttpKube()
                logging.info("using stdlib HTTP kube backend")
            except Exception as e:
                err = e
        except Exception as e:  # cluster creds invalid
            err = e
        if kube is None:
            logging.error(
                "no cluster access (%s); use --fake-kube for local runs",
                err)
            return 1
    gang = GangScheduler(inventory)
    # The multi-tenant policy layer is on by default: with an empty
    # config (no quotas, one priority class in play) it behaves like
    # weighted-fair FIFO plus provably-safe backfill, and quota/
    # priority/preemption policy arrives via the controller ConfigMap
    # without a redeploy of the binary.
    cluster = None if args.no_scheduler else ClusterScheduler(
        gang, scheduler_config)
    controller = TPUJobController(kube, gang, cluster)
    if args.metrics_port:
        from kubeflow_tpu_torch.runtime.prom import serve_metrics

        routes = {"/debug/traces": tracing.snapshot}
        if cluster is not None:
            routes["/queue"] = cluster.status
        serve_metrics(args.metrics_port, json_routes=routes)
        logging.info("metrics on :%d/metrics (+ /debug/traces)",
                     args.metrics_port)
    logging.info("operator up; inventory=%s scheduler=%s", inventory,
                 "off" if cluster is None else "on")
    controller.run(poll_interval_s=args.poll_interval_s,
                   max_iterations=args.max_iterations)
    return 0


if __name__ == "__main__":
    sys.exit(main())
