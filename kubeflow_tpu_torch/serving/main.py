"""Serving entry point: the port of kubeflow_tpu/serving/main.py.

    python -m kubeflow_tpu_torch.serving.main --model_name lm \\
        --model_base_path /models/lm --lm_buckets 512,1024,2048 \\
        --micro_batch_size 4 [--device cpu]

Serves the REST contract on ``--port`` from one process on one device,
which is CUDA unless ``--device`` says otherwise.  With
``--micro_batch_size`` and ``--lm_buckets`` an ``lm_generate`` model is
served through the static ``BucketedLMBatcher``; other models through the
shape-grouped ``MicroBatcher``.

Not ported yet: the continuous-batching decode engine and its flags, the
gRPC face, tracing, fault injection and idempotency dedup (ROADMAP
queue 1, item 3).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional, Tuple

from kubeflow_tpu_torch.serving.http import make_http_server
from kubeflow_tpu_torch.serving.model_server import (
    BucketedLMBatcher,
    MicroBatcher,
    ModelServer,
)

# Graceful-drain budget after SIGTERM.
DRAIN_DEADLINE_S = 30.0


def batcher_factory(*, micro_batch_size: int, batch_timeout_s: float,
                    lm_buckets: str = "",
                    lm_max_promotion_factor: float = 4.0,
                    max_queue_depth: int = 0,
                    overload_retry_after_s: float = 1.0):
    """ModelServer.enable_batching factory: the static batchers.
    ``lm_generate`` models with buckets get the BucketedLMBatcher, others
    the MicroBatcher; rebuilt around every hot-swapped version."""
    sizes = [s for s in (1, 2, 4, 8, 16, 32, 64, 128)
             if s <= micro_batch_size]
    if not sizes or sizes[-1] != micro_batch_size:
        sizes.append(micro_batch_size)
    buckets = [int(b) for b in lm_buckets.split(",") if b.strip()]

    def build(model):
        if micro_batch_size <= 0:
            return None  # direct predict path
        kwargs = dict(
            max_batch_size=micro_batch_size,
            batch_timeout_s=batch_timeout_s,
            allowed_batch_sizes=sizes,
            max_queue_depth=max_queue_depth,
            overload_retry_after_s=overload_retry_after_s,
            name=f"{model.name}-v{model.version}",
        )
        loader = str(model.meta.get("loader", ""))
        if buckets and loader.endswith("lm_generate"):
            return BucketedLMBatcher(
                model.predict, buckets=buckets,
                max_promotion_factor=(lm_max_promotion_factor
                                      if lm_max_promotion_factor > 0
                                      else None),
                **kwargs)
        return MicroBatcher(model.predict, **kwargs)

    return build


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-serve")
    ap.add_argument("--model_name", required=True)
    ap.add_argument("--model_base_path", required=True)
    ap.add_argument("--port", type=int, default=8000,
                    help="REST port (0 = any free port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--poll_interval_s", type=float, default=2.0,
                    help="model version poll period (hot-swap latency)")
    ap.add_argument("--micro_batch_size", type=int, default=0,
                    help="coalesce concurrent single-row requests into "
                         "device batches up to this size (0 = off)")
    ap.add_argument("--batch_timeout_ms", type=float, default=5.0,
                    help="micro-batch assembly window per group")
    ap.add_argument("--lm_buckets", default="",
                    help="comma-separated prompt-length buckets; with "
                         "--micro_batch_size on an lm_generate model, "
                         "mixed-length prompts left-pad to these and "
                         "share batches")
    ap.add_argument("--lm_max_promotion_factor", type=float, default=4.0,
                    help="only prompts whose buckets are within this "
                         "factor share a batch; <=0 = one shared queue")
    ap.add_argument("--max_queue_depth", type=int, default=256,
                    help="pending requests per model beyond which "
                         "submissions fail fast with 429 (0 = unbounded)")
    ap.add_argument("--max_inflight", type=int, default=512,
                    help="per-model in-flight cap across all paths; "
                         "beyond it requests get 429 (0 = unbounded)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; fails when no GPU is "
                         "present), 'cuda:N' or 'cpu'")
    return ap


def start(argv: Optional[List[str]] = None
          ) -> Tuple[ModelServer, ThreadingHTTPServer]:
    """Load the model, start batching, the version watcher and the REST
    listener; returns (server, httpd) with both running."""
    args = _parser().parse_args(argv)
    server = ModelServer(poll_interval_s=args.poll_interval_s,
                         max_inflight=args.max_inflight, device=args.device)
    server.add_model(args.model_name, args.model_base_path)
    if args.micro_batch_size > 0:
        server.enable_batching(args.model_name, batcher_factory(
            micro_batch_size=args.micro_batch_size,
            batch_timeout_s=args.batch_timeout_ms / 1e3,
            lm_buckets=args.lm_buckets,
            lm_max_promotion_factor=args.lm_max_promotion_factor,
            max_queue_depth=args.max_queue_depth))
    server.start_watcher()
    httpd, _ = make_http_server(server, port=args.port, host=args.host)
    logging.info("serving %r on %s, rest=:%d", args.model_name,
                 server.device, httpd.server_address[1])
    return server, httpd


def shutdown(server: ModelServer, httpd: ThreadingHTTPServer) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.stop()


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    server, httpd = start(argv)
    # Readiness marker for process-spawning callers: the bound port.
    print(f"KFT_SERVING_READY rest={httpd.server_address[1]}",
          file=sys.stderr, flush=True)
    stop = threading.Event()

    def on_signal(*_):
        server.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    stop.wait()
    drained = wait_for_drain(server, DRAIN_DEADLINE_S)
    logging.info("drain %s after SIGTERM (in-flight now %d)",
                 "complete" if drained else "deadline exceeded",
                 server.inflight())
    shutdown(server, httpd)
    return 0


def wait_for_drain(server: ModelServer, deadline_s: float,
                   settle_s: float = 0.25, poll_s: float = 0.02) -> bool:
    """Block until in-flight stays at zero for ``settle_s`` or
    ``deadline_s`` passes; True when the server quiesced in time."""
    deadline = time.monotonic() + max(0.0, deadline_s)
    quiet_since = None
    while time.monotonic() < deadline:
        if server.inflight() == 0:
            if quiet_since is None:
                quiet_since = time.monotonic()
            elif time.monotonic() - quiet_since >= settle_s:
                return True
        else:
            quiet_since = None
        time.sleep(poll_s)
    return server.inflight() == 0


if __name__ == "__main__":
    sys.exit(main())
