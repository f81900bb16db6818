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

Not ported yet: ``--mesh`` (ROADMAP queue 1, item 6), accepted at its
off value only and raising ``NotPortedError`` otherwise; the gRPC face
(item 7); tracing routes, fault injection from the environment and
idempotency dedup (item 9).
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

from kubeflow_tpu_torch import NotPortedError
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
                    mesh: str = ""):
    """ModelServer.enable_batching factory: picks the batcher per model,
    rebuilt around every hot-swapped version.

    ``lm_generate`` models default to the continuous-batching
    DecodeEngine; ``lm_engine=False`` (--lm_static_batcher) falls back to
    the static BucketedLMBatcher when buckets are configured.  Everything
    else gets the shape-grouped MicroBatcher when micro-batching is on,
    or no batcher (build returns None: the direct predict path).  With
    ``adapters_dir`` each engine gets its own ``AdapterRegistry`` of
    ``adapter_slots`` rows at ``adapter_rank``.  ``mesh`` raises
    ``NotPortedError`` unless it is off.
    """
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    if mesh:
        raise NotPortedError(
            "--mesh is not ported yet (ROADMAP queue 1 item 6); the port "
            "serves with it off")
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
                    help="not ported yet: only empty is accepted")
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
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; fails when no GPU is "
                         "present), 'cuda:N' or 'cpu'")
    return ap


def start(argv: Optional[List[str]] = None
          ) -> Tuple[ModelServer, ThreadingHTTPServer]:
    """Load the model, start batching, the version watcher and the REST
    listener; returns (server, httpd) with both running."""
    args = _parser().parse_args(argv)
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
            mesh=args.mesh)
    server = ModelServer(poll_interval_s=args.poll_interval_s,
                         max_inflight=args.max_inflight,
                         overload_retry_after_s=args.overload_retry_after_s,
                         device=args.device, role=args.role)
    server.add_model(args.model_name, args.model_base_path)
    if factory is not None:
        server.enable_batching(args.model_name, factory)
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
