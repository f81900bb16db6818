"""Serving entry point: the port of kubeflow_tpu/serving/main.py.

    python -m kubeflow_tpu_torch.serving.main --model_name lm \\
        --model_base_path /models/lm [--lm_buckets 512,1024,2048] \\
        [--device cpu]

Serves the REST contract on ``--port`` from one process on one device,
which is CUDA unless ``--device`` says otherwise.  An ``lm_generate``
model is served through the continuous-batching ``DecodeEngine``
(serving/engine.py) by default, with the JAX CLI's engine defaults (8
slots, fused rounds of 8 steps, 64-token prefill chunks, 16-token KV
blocks, prefix caching on); prompts wider than its prefill width take
the direct ``generate()`` path.  ``--lm_static_batcher`` restores the
static ``BucketedLMBatcher`` (with ``--micro_batch_size`` and
``--lm_buckets``); other models get the shape-grouped ``MicroBatcher``.
``--speculative_tokens N`` makes the engine speculate with n-gram drafts
of up to N tokens (greedy exports), and ``--role prefill|decode``
advertises the server's disaggregated tier on /readyz (every server
answers :prefill and the streaming :generate).  ``--host_spill_blocks
N`` gives the engine a host-memory KV tier of N pages, which parked
sessions (``park_kv``) and pool pressure fill and ``:fetch_kv`` serves.
An export whose config sets ``quantize: int8`` or ``kv_cache: int8``
serves int8 weights or an int8 KV pool.  ``--adapters_dir DIR`` (with
``--adapter_slots`` and ``--adapter_rank``) gives each engine an
``AdapterRegistry`` over ``DIR/<name>.npz``: ``POST
/model/NAME@ADAPTER:predict`` or ``:generate`` serves that adapter,
co-batched with base traffic in the same captured programs.

As in the JAX entry point: ``--trace_sample_rate``, ``--trace_capacity``
and ``--no_tracing`` set up request tracing (``GET /debug/traces``);
``KFT_FAULTS`` in the environment installs a scripted fault scenario
(testing/faults.py); ``--dedup_capacity`` and ``--dedup_ttl_s`` size the
idempotency cache; ``--reload_backoff_s`` and ``--reload_backoff_cap_s``
the reload breaker; and SIGTERM flips /readyz, then waits up to
``--drain_deadline_s`` on the policy clock for in-flight work.

The gRPC ``PredictionService`` (``Predict``, ``Classify``,
``GetModelMetadata``), its TF-Serving ``Predict`` face and
``grpc.health.v1`` share one port, ``--grpc_port`` (9000 as in the JAX
entry point and the serving manifest; 0 = any free port, -1 = REST
only), started and stopped with the REST listener (serving/grpc_server.py).
grpcio is imported only when gRPC is asked for: without it a server
started with gRPC on fails at start with the ImportError, and
``--grpc_port -1`` serves REST alone.  ``KFT_SERVING_READY rest=PORT
grpc=PORT`` on stderr marks both listeners up (``grpc=-1`` when off).

``--mesh tensor=N`` serves each engine tensor-parallel over N processes,
one a GPU (serving/sharding.py): start N copies of this entry point with
the ``KFT_*`` variables (runtime/bootstrap.py; ``KFT_DIST_BACKEND=gloo``
when they share one GPU, and ``--device cpu`` on the CPU) or under
torchrun.  Rank 0 serves REST and gRPC and runs the engine's host side;
every other rank loads the same export version from the same base path,
keeps its slice and replays rank 0's device calls (``engine.follow``),
binds no port, prints ``KFT_SERVING_FOLLOWER rank=R`` on stderr and
exits when rank 0 shuts down.  Under a mesh the engine's programs run
uncaptured; prompts wider than its prefill width and the static batcher
run whole on rank 0, as in the JAX entry point, which passes the mesh to
the engine only.
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

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.serving import lockstep, sharding
from kubeflow_tpu_torch.serving.http import make_http_server
from kubeflow_tpu_torch.serving.model_server import (
    BucketedLMBatcher,
    MicroBatcher,
    ModelServer,
)
from kubeflow_tpu_torch.testing import faults


def batcher_factory(*, micro_batch_size: int, batch_timeout_s: float,
                    lm_buckets: str = "",
                    lm_max_promotion_factor: float = 4.0,
                    lm_engine: bool = True,
                    lm_engine_slots: int = 8,
                    lm_engine_prefill_len: int = 0,
                    lm_engine_sync_lag: int = 2,
                    lm_engine_steps_per_call: int = 1,
                    lm_engine_admit_width: int = 4,
                    decode_rounds: int = 1,
                    prefill_chunk_tokens: int = 64,
                    kv_block_tokens: int = 16,
                    kv_pool_blocks: int = 0,
                    host_spill_blocks: int = 0,
                    prefix_caching: bool = True,
                    max_queue_depth: int = 0,
                    overload_retry_after_s: float = 1.0,
                    speculative_tokens: int = 0,
                    adapters_dir: str = "",
                    adapter_slots: int = 8,
                    adapter_rank: int = 4,
                    mesh=None,
                    model_base_path: str = ""):
    """ModelServer.enable_batching factory: picks the batcher per model,
    rebuilt around every hot-swapped version.

    ``lm_generate`` models default to the continuous-batching
    DecodeEngine; ``lm_engine=False`` (--lm_static_batcher) falls back to
    the static BucketedLMBatcher when buckets are configured.  Everything
    else gets the shape-grouped MicroBatcher when micro-batching is on,
    or no batcher (build returns None: the direct predict path).  With
    ``adapters_dir`` each engine gets its own ``AdapterRegistry`` of
    ``adapter_slots`` rows at ``adapter_rank``.  ``mesh`` (a serving
    mesh from ``sharding.build_mesh``, built once per job) makes each
    engine tensor-parallel; the other ranks load the version the engine
    serves from ``model_base_path``.
    """
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    sizes = [s for s in (1, 2, 4, 8, 16, 32, 64, 128)
             if s <= micro_batch_size]
    if not sizes or sizes[-1] != micro_batch_size:
        sizes.append(micro_batch_size)
    buckets = [int(b) for b in lm_buckets.split(",") if b.strip()]

    def build(model):
        spec = getattr(model.predict, "engine_spec", None)
        if lm_engine and spec is not None:
            # Prefill width: explicit flag > largest bucket > a capped
            # share of the prompt room max_seq_len leaves after the
            # completion budget.  The width is a static program shape and
            # sizes the pool (slots x (width + budget)), hence the cap.
            # Prompts beyond it take the direct generate() path; with no
            # room left at all, fall through to the static paths.
            cap = (spec["cfg"].max_seq_len
                   - spec["decode"].max_new_tokens)
            prefill = lm_engine_prefill_len or (
                max(buckets) if buckets else min(cap, 512))
            prefill = min(prefill, cap)
            if prefill >= 1:
                registry = None
                if adapters_dir:
                    # One registry per engine: hot-loaded per-tenant
                    # deltas ride the engine's stacked adapter arrays
                    # inside the SAME captured programs.
                    registry = AdapterRegistry(
                        spec["cfg"], slots=adapter_slots,
                        rank=adapter_rank, directory=adapters_dir,
                        name=f"{model.name}-v{model.version}",
                        overload_retry_after_s=overload_retry_after_s)
                logging.info(
                    "decode engine for %r v%d: %d slots, prefill width "
                    "%d, cache %d cols/slot", model.name, model.version,
                    lm_engine_slots, prefill,
                    prefill + spec["decode"].max_new_tokens)
                return DecodeEngine(
                    spec["model"], spec["decode"],
                    slots=lm_engine_slots, prefill_len=prefill,
                    sync_lag=lm_engine_sync_lag,
                    steps_per_call=lm_engine_steps_per_call,
                    decode_rounds=decode_rounds,
                    admit_width=lm_engine_admit_width,
                    prefill_chunk_tokens=prefill_chunk_tokens,
                    kv_block_tokens=kv_block_tokens,
                    kv_pool_blocks=kv_pool_blocks,
                    host_spill_blocks=host_spill_blocks,
                    prefix_caching=prefix_caching,
                    max_queue_depth=max_queue_depth,
                    overload_retry_after_s=overload_retry_after_s,
                    speculative_tokens=speculative_tokens,
                    adapters=registry,
                    mesh=mesh,
                    source={"base": model_base_path,
                            "version": model.version},
                    name=f"{model.name}-v{model.version}")
            logging.warning(
                "decode engine disabled for %r: max_new_tokens %d "
                "leaves no prompt room in max_seq_len %d", model.name,
                spec["decode"].max_new_tokens, spec["cfg"].max_seq_len)
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
    ap.add_argument("--grpc_port", type=int, default=9000,
                    help="gRPC PredictionService port (0 = any free "
                         "port); -1 disables")
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
    ap.add_argument("--lm_static_batcher", action="store_true",
                    help="serve lm_generate models through the static "
                         "BucketedLMBatcher instead of the default "
                         "continuous-batching DecodeEngine; on an H100 "
                         "the engine, its programs captured as CUDA "
                         "graphs, served chip_smoke.py's eight-request "
                         "188M LM burst 1.70-3.54x faster than the "
                         "static batcher in two runs (PERF.md section 5)")
    ap.add_argument("--lm_engine_slots", type=int, default=8,
                    help="DecodeEngine concurrent sequences")
    ap.add_argument("--lm_engine_prefill_len", type=int, default=0,
                    help="DecodeEngine static prompt width (0 = largest "
                         "--lm_buckets entry, else max_seq_len minus "
                         "max_new_tokens capped at 512; clamped to the "
                         "model's prompt room); longer prompts take the "
                         "direct generate() path")
    ap.add_argument("--lm_engine_sync_lag", type=int, default=2,
                    help="DecodeEngine host-read lag in steps (0 = "
                         "synchronous loop)")
    ap.add_argument("--lm_engine_steps_per_call", type=int, default=1,
                    help="DecodeEngine decode steps per step-program "
                         "call")
    ap.add_argument("--lm_engine_admit_width", type=int, default=4,
                    help="DecodeEngine concurrent mid-prefill admissions")
    ap.add_argument("--decode_rounds", type=int, default=8,
                    help="DecodeEngine fused decode rounds: up to k steps "
                         "per dispatch, the width adapting between 1 and "
                         "k; 1 restores the per-step dispatch loop")
    ap.add_argument("--prefill_chunk_tokens", type=int, default=64,
                    help="DecodeEngine per-step prefill token budget and "
                         "static chunk width")
    ap.add_argument("--kv_block_tokens", type=int, default=16,
                    help="DecodeEngine paged-KV page size in positions "
                         "(also the prefix sharing granularity)")
    ap.add_argument("--kv_pool_blocks", type=int, default=0,
                    help="DecodeEngine KV pool capacity in pages (0 = "
                         "slots x ceil(max_len / kv_block_tokens))")
    ap.add_argument("--no_prefix_cache", action="store_true",
                    help="disable shared-prefix block aliasing")
    ap.add_argument("--speculative_tokens", type=int, default=0,
                    help="DecodeEngine self-speculative decoding: up to "
                         "this many n-gram-drafted tokens a slot verify "
                         "in one forward, token-identical to greedy "
                         "decode; greedy exports only (a sampling export "
                         "serves without it); 0 = off")
    ap.add_argument("--host_spill_blocks", type=int, default=0,
                    help="DecodeEngine host-RAM KV spill tier capacity "
                         "in pages (0 = disabled).  LRU-cold "
                         "prefix records and parked multi-turn "
                         "sessions evacuate to host memory under pool "
                         "pressure and re-import through kv_import on "
                         "the next hit; tokens-addressable capacity "
                         "becomes (kv_pool_blocks + host_spill_blocks)"
                         " x kv_block_tokens, and the :fetch_kv route "
                         "serves these pages to failover peers")
    ap.add_argument("--adapters_dir", default="",
                    help="directory of per-tenant adapter deltas "
                         "(<name>.npz + digest sidecar): enables "
                         "multi-model serving on the DecodeEngine; "
                         "requests naming 'model@adapter' hot-load the "
                         "delta into a bounded stacked-array slot and "
                         "co-batch with every other variant in the SAME "
                         "captured programs.  Empty = adapter requests "
                         "404")
    ap.add_argument("--adapter_slots", type=int, default=8,
                    help="resident adapter variants per engine (the "
                         "stacked array's device rows beyond base); "
                         "idle adapters LRU-evict when the slots fill, "
                         "in-flight ones are pinned; all slots pinned "
                         "sheds 429")
    ap.add_argument("--adapter_rank", type=int, default=4,
                    help="low-rank adapter factor rank: every adapter "
                         "served by one engine shares this rank (the "
                         "stacked array is one static shape)")
    ap.add_argument("--mesh", default="",
                    help="serving mesh, 'tensor=N': each engine runs "
                         "tensor-parallel over the job's N processes "
                         "(rank 0 serves, the others follow it); empty "
                         "= one device")
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"),
                    help="disaggregated-serving tier, advertised on "
                         "/readyz: 'prefill' servers answer :prefill with "
                         "KV handoff pages, 'decode' servers import them "
                         "and stream :generate; 'unified' (default) "
                         "serves the single-tier path")
    ap.add_argument("--max_queue_depth", type=int, default=256,
                    help="pending requests per model beyond which "
                         "submissions fail fast with 429 (0 = unbounded)")
    ap.add_argument("--overload_retry_after_s", type=float, default=1.0,
                    help="Retry-After hint carried by shed (429) "
                         "responses")
    ap.add_argument("--max_inflight", type=int, default=512,
                    help="per-model in-flight cap across all paths; "
                         "beyond it requests get 429 (0 = unbounded)")
    ap.add_argument("--dedup_capacity", type=int, default=1024,
                    help="idempotency dedup cache entries (completed "
                         "results answered to retried keys; in-flight "
                         "duplicates attach instead of re-executing)")
    ap.add_argument("--dedup_ttl_s", type=float, default=120.0,
                    help="how long a completed idempotency-key result "
                         "stays answerable (policy clock); 0 disables "
                         "expiry")
    ap.add_argument("--drain_deadline_s", type=float, default=30.0,
                    help="graceful-drain budget on SIGTERM: /readyz "
                         "flips not-ready at once, then in-flight "
                         "requests get this long to finish before the "
                         "listener closes")
    ap.add_argument("--reload_backoff_s", type=float, default=0.5,
                    help="initial circuit-breaker backoff after a "
                         "model (re)load failure (doubles per failure, "
                         "jittered; the last-good version keeps "
                         "serving while the breaker is open)")
    ap.add_argument("--reload_backoff_cap_s", type=float, default=60.0,
                    help="circuit-breaker backoff ceiling")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; fails when no GPU is "
                         "present), 'cuda:N' or 'cpu'")
    tracing.add_cli_args(ap)
    return ap


def start(argv: Optional[List[str]] = None
          ) -> Tuple[ModelServer, ThreadingHTTPServer]:
    """Set up tracing and the ``KFT_FAULTS`` scenario, load the model,
    start batching, the version watcher, the REST listener and (unless
    ``--grpc_port -1``) the gRPC server; returns (server, httpd) with
    all running.  The gRPC server is ``httpd.grpc_server`` (None when
    off; its port is ``.bound_port``), and ``shutdown`` stops it.  With
    ``--mesh`` this process must be rank 0 of the job (``main`` runs the
    other ranks)."""
    args = _parser().parse_args(argv)
    mesh = _serving_mesh(args)
    if mesh is not None and not lockstep.channel(mesh).leader:
        raise ValueError("start() serves from rank 0 of a mesh; the other "
                         "ranks run main(), which follows it")
    server, httpd, _ = _start(args, mesh)
    return server, httpd


def _serving_mesh(args: argparse.Namespace):
    """The job's serving mesh for ``--mesh`` (None without one): a
    multi-process job joins its process group first."""
    axes = sharding.parse_mesh_flag(args.mesh)
    if axes.get(sharding.TENSOR, 1) <= 1:
        return None
    from kubeflow_tpu_torch.runtime import bootstrap

    bootstrap.initialize(device=args.device)
    return sharding.build_mesh(axes, device=args.device)


def _follow(args: argparse.Namespace, mesh) -> int:
    """A rank other than 0: build every engine rank 0 builds from the
    same export version, replay its device calls, exit when it closes
    the channel."""
    from kubeflow_tpu_torch.serving.engine import follow
    from kubeflow_tpu_torch.serving.export import load_version

    def resolve(source):
        predict, _ = load_version(source["base"], source["version"],
                                  device=args.device)
        return predict.engine_spec["model"]

    rank = lockstep.channel(mesh).rank
    logging.info("rank %d follows rank 0 (mesh %s)", rank, args.mesh)
    print(f"KFT_SERVING_FOLLOWER rank={rank}", file=sys.stderr, flush=True)
    follow(mesh, resolve)
    logging.info("rank %d: rank 0 closed the mesh", rank)
    return 0


def _start(args: argparse.Namespace, mesh=None):
    make_grpc_server = None
    if args.grpc_port >= 0:
        # Deferred import, before anything starts: a REST-only server
        # (--grpc_port -1) runs without grpcio installed, and a server
        # asked for gRPC without it fails here.
        from kubeflow_tpu_torch.serving.grpc_server import make_grpc_server
    if tracing.enable_from_args(args) is not None:
        logging.info("request tracing on (sample rate %g, store %d "
                     "traces): GET /debug/traces",
                     args.trace_sample_rate, args.trace_capacity)
    # Scripted chaos (KFT_FAULTS): a no-op unless the variable is set.
    if faults.install_from_env() is not None:
        logging.warning("fault injection ACTIVE (KFT_FAULTS set)")
    factory = None
    # lm_generate models default to the engine even with micro-batching
    # off; --lm_static_batcher restores the static paths.
    if args.micro_batch_size > 0 or not args.lm_static_batcher:
        factory = batcher_factory(
            micro_batch_size=args.micro_batch_size,
            batch_timeout_s=args.batch_timeout_ms / 1e3,
            lm_buckets=args.lm_buckets,
            lm_max_promotion_factor=args.lm_max_promotion_factor,
            lm_engine=not args.lm_static_batcher,
            lm_engine_slots=args.lm_engine_slots,
            lm_engine_prefill_len=args.lm_engine_prefill_len,
            lm_engine_sync_lag=args.lm_engine_sync_lag,
            lm_engine_steps_per_call=args.lm_engine_steps_per_call,
            lm_engine_admit_width=args.lm_engine_admit_width,
            decode_rounds=args.decode_rounds,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            kv_block_tokens=args.kv_block_tokens,
            kv_pool_blocks=args.kv_pool_blocks,
            host_spill_blocks=args.host_spill_blocks,
            prefix_caching=not args.no_prefix_cache,
            max_queue_depth=args.max_queue_depth,
            overload_retry_after_s=args.overload_retry_after_s,
            speculative_tokens=args.speculative_tokens,
            adapters_dir=args.adapters_dir,
            adapter_slots=args.adapter_slots,
            adapter_rank=args.adapter_rank,
            mesh=mesh,
            model_base_path=args.model_base_path)
    server = ModelServer(poll_interval_s=args.poll_interval_s,
                         reload_backoff_s=args.reload_backoff_s,
                         reload_backoff_cap_s=args.reload_backoff_cap_s,
                         max_inflight=args.max_inflight,
                         overload_retry_after_s=args.overload_retry_after_s,
                         dedup_capacity=args.dedup_capacity,
                         dedup_ttl_s=args.dedup_ttl_s,
                         device=args.device, role=args.role)
    server.add_model(args.model_name, args.model_base_path)
    if factory is not None:
        server.enable_batching(args.model_name, factory)
    server.start_watcher()
    httpd, _ = make_http_server(server, port=args.port, host=args.host)
    httpd.lockstep = None if mesh is None else lockstep.channel(mesh)
    httpd.grpc_server = None
    if make_grpc_server is not None:
        try:
            httpd.grpc_server = make_grpc_server(
                server, port=args.grpc_port, host=args.host)
        except BaseException:
            shutdown(server, httpd)
            raise
        logging.info("serving %r on %s, rest=:%d grpc=:%d",
                     args.model_name, server.device,
                     httpd.server_address[1], httpd.grpc_server.bound_port)
    else:
        logging.info("serving %r on %s, rest=:%d (grpc disabled)",
                     args.model_name, server.device,
                     httpd.server_address[1])
    return server, httpd, args


def shutdown(server: ModelServer, httpd: ThreadingHTTPServer) -> None:
    httpd.shutdown()
    httpd.server_close()
    grpc_server = getattr(httpd, "grpc_server", None)
    if grpc_server is not None:
        grpc_server.stop(grace=1).wait()
    server.stop()
    chan = getattr(httpd, "lockstep", None)
    if chan is not None:
        chan.close()  # the other ranks of the mesh exit


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = _parser().parse_args(argv)
    mesh = _serving_mesh(args)
    if mesh is not None and not lockstep.channel(mesh).leader:
        return _follow(args, mesh)
    server, httpd, args = _start(args, mesh)
    # Readiness marker for process-spawning callers: the bound ports,
    # on one line, after both listeners are up.
    grpc_server = httpd.grpc_server
    print(f"KFT_SERVING_READY rest={httpd.server_address[1]} "
          f"grpc={grpc_server.bound_port if grpc_server else -1}",
          file=sys.stderr, flush=True)
    stop = threading.Event()

    def on_signal(*_):
        server.begin_drain()
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    stop.wait()
    drained = wait_for_drain(server, args.drain_deadline_s)
    logging.info("drain %s after SIGTERM (in-flight now %d)",
                 "complete" if drained else "deadline exceeded",
                 server.inflight())
    shutdown(server, httpd)
    return 0


def wait_for_drain(server: ModelServer, deadline_s: float,
                   settle_s: float = 0.25, poll_s: float = 0.02) -> bool:
    """Block until in-flight stays at zero for ``settle_s`` or
    ``deadline_s`` passes on the policy clock; True when the server
    quiesced in time."""
    deadline = faults.monotonic() + max(0.0, deadline_s)
    quiet_since = None
    while faults.monotonic() < deadline:
        if server.inflight() == 0:
            if quiet_since is None:
                quiet_since = faults.monotonic()
            elif faults.monotonic() - quiet_since >= settle_s:
                return True
        else:
            quiet_since = None
        time.sleep(poll_s)
    return server.inflight() == 0


if __name__ == "__main__":
    sys.exit(main())
