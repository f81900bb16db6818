"""Opt-in anonymous usage telemetry: the port of
kubeflow_tpu/tools/telemetry.py.

A periodic reporter that assembles an anonymous payload {usage id,
framework and torch versions} and POSTs it to ``--report-url``, or logs
it when no collector is configured (the report is always inspectable).
``torch_version`` takes the place of the JAX package's ``jax_version``.
The JAX package adds ``node_count`` from its Kubernetes client; the
port has no client yet (ROADMAP queue 1 item 18), so ``main`` reports
none, which is what the JAX package reports when its client cannot be
made.  ``collect(usage_id, kube=...)`` takes any client with
``list_nodes()``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import urllib.request
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)


def collect(usage_id: str, kube=None) -> Dict[str, Any]:
    """Anonymous payload: no names, no IPs, no workload details."""
    from kubeflow_tpu_torch.version import __version__

    payload: Dict[str, Any] = {
        "usage_id": usage_id,
        "framework_version": __version__,
    }
    try:
        import torch

        payload["torch_version"] = torch.__version__
    except ImportError:
        payload["torch_version"] = None
    if kube is not None:
        try:
            payload["node_count"] = len(kube.list_nodes())
        except Exception:  # the cluster is unreachable: count unknown
            payload["node_count"] = None
    return payload


def report(payload: Dict[str, Any], url: Optional[str] = None,
           timeout_s: float = 10.0) -> bool:
    """POST the payload; log-only when no collector URL is configured.
    Returns True when the report was delivered (or logged)."""
    body = json.dumps(payload).encode()
    if not url:
        log.info("usage report (no collector configured): %s",
                 body.decode())
        return True
    try:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return 200 <= resp.status < 300
    except Exception as e:  # the collector is down: report again later
        log.warning("usage report failed: %s", e)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-telemetry")
    ap.add_argument("--usage-id", required=True)
    ap.add_argument("--interval-hours", type=float, default=24.0)
    ap.add_argument("--report-url", default="",
                    help="collector endpoint; log-only when empty")
    ap.add_argument("--once", action="store_true",
                    help="report once and exit (tests/cron)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    while True:
        report(collect(args.usage_id), args.report_url or None)
        if args.once:
            return 0
        time.sleep(args.interval_hours * 3600)


if __name__ == "__main__":
    sys.exit(main())
