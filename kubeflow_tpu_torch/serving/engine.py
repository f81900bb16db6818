"""Continuous-batching LM decode engine: the port of
kubeflow_tpu/serving/engine.py's default path.

The static batchers dispatch whole ``generate()`` calls: a batch is
assembled, padded and owned by one program from prefill to the last
token, so a request arriving mid-generation waits for all of it and
every row pays the batch bucket's padded KV span.  This engine runs the
slot programs of models/generate.py instead, over ONE persistent PAGED
KV block pool shared by ``slots`` sequences:

  - the KV store is a device block pool ([layers, kv_pool_blocks,
    kv_block_tokens, hkv, d]) with host-owned per-slot block tables
    passed into every program call; a slot holds pages for the tokens
    it has produced, so capacity is bounded by tokens resident, and
    admission reserves each request's worst-case page count up front
    and sheds typed ``Overloaded`` when the pool can never cover it
    (serving/prefix_cache.py BlockManager);
  - a loop thread advances all live slots one token per ``decode_step``
    call, or up to ``decode_rounds`` tokens per fused ``decode_rounds``
    call;
  - new requests are admitted into free slots BETWEEN steps, and their
    prompts prefill in static-width chunks scheduled between steps under
    a per-step token budget (``prefill_chunk_tokens``), so an arriving
    prompt stalls in-flight decode for at most one chunk;
  - admission resumes from the longest cached shared prefix: the new
    slot's table aliases the physical blocks a previous prompt wrote (a
    refcount bump, no device copy) and chunked prefill continues after
    them;
  - finished rows retire at once (device-side ``done``); their slots are
    reused and their private pages return to the pool;
  - with ``speculative_tokens`` k > 0 (greedy exports only), the host
    drafts up to k tokens a slot from the slot's own history (n-gram
    prompt lookup) and one ``verify_step`` call scores them, emitting
    the accepted prefix and one free token, token-identical to plain
    decode; gates on draft mass and on the measured delivered rates keep
    it off where it does not pay;
  - for disaggregated serving, ``prefill_export`` returns a prompt's
    finished full-block KV pages (``kv_handoff``) and a request carrying
    such a payload imports them into its own blocks and prefills only
    the rest; ``submit_stream`` streams a request's tokens as the loop
    materializes them;
  - with ``host_spill_blocks`` > 0 the pool gains a host-memory tier:
    under pool pressure the loop copies LRU-cold idle prefix records to
    host memory before admission would destroy-evict them, a request
    with ``park_kv`` publishes its whole context and copies its pages
    there at delivery, and an admission the host tier covers further
    than the device index re-imports those pages through the same
    ``KvImport`` program a handoff uses; ``fetch_kv`` serves the host
    tier's pages to a peer (host memory only, on any thread);
  - a ``kv_cache_dtype="int8"`` export keeps an int8 pool with one
    float32 scale per (position, head), which its handoff, spill and
    fetch payloads carry as ``{"values", "scale"}`` sides;
  - with an ``AdapterRegistry`` (serving/adapters.py), a request naming
    an ``adapter`` decodes that tenant's low-rank variant in the same
    continuous batch: the engine keeps the registry's stacked factors
    on the device (model dtype) and every program gathers each slot's
    row; admission pins the row, salts the request's prefix chain with
    the adapter's content digest, and picks among queued requests
    fairly per tenant.

The host reads sampled tokens ``sync_lag`` calls late: each program's
results are copied into pinned host memory by non-blocking copies behind
a CUDA event, and the host waits on that event only when it drains the
call, ``sync_lag`` dispatches later (at the round boundary for fused
rounds).  No program reads a device value on the host.  The loop thread
runs under ``torch.inference_mode()``, which is per thread.

Where the JAX engine lowers and compiles its programs ahead of time,
this one builds them once (serving/programs.py): on CUDA each program
is captured as a CUDA graph on the loop thread before the first
admission, and each call is an upload of its tokens and scalars into
fixed device buffers and one replay.  A capture that fails raises from
the constructor; nothing falls back to eager ops unless the caller
passes ``cuda_graphs=False``.  On the CPU the same program objects run
eagerly.  ``compiled_programs()`` counts each program once the engine
has run it, so it reports what the JAX engine reports under the same
flags.

Not ported yet: ``mesh`` (ROADMAP queue 1 item 6), refused with
``NotPortedError``.

Interface-compatible with the batchers (submit/accepts/stats/close), so
ModelServer.enable_batching wires it behind the REST surface unchanged.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.ops.quantize import QTensor
from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.serving import programs
from kubeflow_tpu_torch.serving.adapters import AdapterNotFound
from kubeflow_tpu_torch.serving.errors import (
    BatcherClosed,
    DeadlineExceeded,
    Overloaded,
)
from kubeflow_tpu_torch.serving.model_server import (
    EXPIRED_HELP,
    EXPIRED_TOTAL,
    SHED_HELP,
    SHED_TOTAL,
    locked_snapshot,
)
from kubeflow_tpu_torch.serving.prefix_cache import BlockManager
from kubeflow_tpu_torch.testing import faults

log = logging.getLogger(__name__)


class _SpillShed(Exception):
    """Internal: a spill-tier fault struck mid-admission (the engine.spill
    site raised during re-import).  The loop sheds the one affected
    request typed 429: never engine death, never a leaked page."""


# Step-duration histogram buckets: decode steps run ~0.1 ms (tiny CPU
# models) to ~100 ms.
_STEP_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                 1.0, 2.5)

PREFIX_HITS_TOTAL = "kft_engine_prefix_hits_total"
PREFIX_HITS_HELP = "admissions resumed from a cached prefix, by engine"
PREFIX_MISSES_TOTAL = "kft_engine_prefix_misses_total"
PREFIX_MISSES_HELP = "admissions with no cached prefix, by engine"
PREFIX_EVICTIONS_TOTAL = "kft_engine_prefix_evictions_total"
PREFIX_EVICTIONS_HELP = "cached prefix records evicted (LRU), by engine"
KV_BLOCKS_GAUGE = "kft_engine_kv_blocks"
KV_BLOCKS_HELP = "paged KV pool capacity in blocks, by engine"
KV_BLOCKS_USED_GAUGE = "kft_engine_kv_blocks_used"
KV_BLOCKS_USED_HELP = \
    "paged KV blocks resident (slot- or cache-held), by engine"
KV_EVICTIONS_TOTAL = "kft_engine_kv_block_evictions_total"
KV_EVICTIONS_HELP = \
    "paged KV blocks freed by prefix-cache LRU eviction, by engine"
KV_SHED_TOTAL = "kft_engine_kv_shed_no_blocks_total"
KV_SHED_HELP = \
    "submissions shed because the KV block pool could not cover " \
    "them, by engine"
PREFILL_CHUNKS_TOTAL = "kft_engine_prefill_chunks_total"
PREFILL_CHUNKS_HELP = "prefill chunk program calls, by engine"
FUSED_ROUNDS_TOTAL = "kft_engine_fused_rounds_total"
FUSED_ROUNDS_HELP = \
    "fused multi-step decode rounds dispatched (decode_rounds > 1), " \
    "by engine"
FUSED_WASTED_TOTAL = "kft_engine_fused_steps_wasted_total"
FUSED_WASTED_HELP = \
    "fused-round slot-steps dispatched but not delivered (early-exit " \
    "waste past a slot's EOS/budget/deadline), by engine"
SPEC_DRAFTED_TOTAL = "kft_engine_spec_drafted_total"
SPEC_DRAFTED_HELP = "draft tokens proposed to verify_step, by engine"
SPEC_ACCEPTED_TOTAL = "kft_engine_spec_accepted_total"
SPEC_ACCEPTED_HELP = "draft tokens accepted by verify_step, by engine"
HANDOFF_PAGES_TOTAL = "kft_engine_handoff_pages_total"
HANDOFF_PAGES_HELP = \
    "paged-KV pages transferred for disaggregated prefill/decode " \
    "handoff, by engine and direction (export/import)"
KV_SPILLED_GAUGE = "kft_engine_kv_spilled_blocks"
KV_SPILLED_HELP = \
    "paged-KV pages currently resident in the host spill tier, " \
    "by engine"
HOST_TIER_GAUGE = "kft_engine_host_tier_blocks"
HOST_TIER_HELP = \
    "host spill-tier capacity in pages (0 = tier disabled), by engine"
KV_SPILL_TOTAL = "kft_engine_kv_spill_total"
KV_SPILL_HELP = \
    "paged-KV pages crossing the host spill tier, by engine and " \
    "direction (out = device pages evacuated to host, in = host " \
    "pages re-imported at admission)"
ADAPTER_REQUESTS_TOTAL = "kft_engine_adapter_requests_total"
ADAPTER_REQUESTS_HELP = \
    "requests admitted naming an adapter variant, by engine and " \
    "adapter"

# N-gram drafter bounds: suffixes of up to _SPEC_NGRAM_MAX tokens are
# matched against the request's own history, down to _SPEC_NGRAM_MIN (a
# bigram: a single repeated token recurs by chance in unrepetitive text,
# while every periodic regime repeats its bigrams too).  A slot whose
# adaptive draft width backed off to zero re-probes after _SPEC_COOLDOWN
# rounds.
_SPEC_NGRAM_MAX = 4
_SPEC_NGRAM_MIN = 2
_SPEC_COOLDOWN = 8
# While no live slot proposes anything, the drafting scan's period
# doubles, up to _SPEC_SCAN_STRIDE_MAX rounds; a proposal or a draftable
# admission resets it to every round.
_SPEC_SCAN_STRIDE_MAX = 8
# Throughput gate: verify keeps running only while its measured
# delivered token rate (EMA) is at least this share of the decode
# program's; while gated off, a probe verify runs every
# _SPEC_PROBE_EVERY gated rounds to refresh the estimate.
_SPEC_RATE_MARGIN = 0.95
_SPEC_PROBE_EVERY = 4
_SPEC_RATE_ALPHA = 0.3

# Fused decode rounds (decode_rounds > 1): shrink the adaptive round
# width when more than this fraction of a round's dispatched slot-steps
# delivered nothing (slots frozen at EOS/budget while co-resident slots
# keep stepping), or when an admission is queued (smaller rounds reach
# the admission boundary sooner); grow back one step per full,
# waste-free round.  The pace EMA smooths the per-token step latency
# used to clamp the width under live deadlines.
_ROUND_WASTE_FRAC = 0.25
_ROUND_PACE_ALPHA = 0.2


_NO_DRAFT = np.empty((0,), np.int32)


def _ngram_propose(history: np.ndarray, k: int,
                   nmax: int = _SPEC_NGRAM_MAX,
                   nmin: int = _SPEC_NGRAM_MIN) -> np.ndarray:
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the history's longest matchable suffix (n-gram, longest n first) and
    propose the up-to-k tokens that followed it; empty when no suffix
    recurs.  A proposal carries no correctness weight (verify accepts
    exact greedy matches only): it sets the acceptance rate.  Every
    matchable suffix ends with the history's last two tokens, so one
    vectorized scan for them prunes unrepetitive text first."""
    n_hist = int(history.shape[0])
    if n_hist < nmin + 1 or k <= 0:
        return _NO_DRAFT
    ends = np.flatnonzero(history[:n_hist - 1] == history[n_hist - 1])
    if ends.size == 0:
        return _NO_DRAFT
    if nmin >= 2:
        ends = ends[ends >= 1]
        ends = ends[history[ends - 1] == history[n_hist - 2]]
        if ends.size == 0:
            return _NO_DRAFT
    for n in range(min(nmax, n_hist - 1), nmin - 1, -1):
        cand = ends[ends >= n - 1]
        if cand.size == 0:
            continue
        if n > 1:
            pattern = history[n_hist - n:]
            idx = (cand - (n - 1))[:, None] + np.arange(n)[None, :]
            cand = cand[(history[idx] == pattern[None, :]).all(axis=1)]
            if cand.size == 0:
                continue
        starts = cand + 1
        # The most recent occurrence with a full k-token continuation,
        # else the most recent at all, whose short continuation (the
        # period of a periodic tail) repeats cyclically.
        full = starts[starts + k <= n_hist]
        start = int(full[-1] if full.size else starts[-1])
        proposal = history[start:start + k]
        if proposal.size < k:
            proposal = np.resize(history[start:], k)
        return proposal.astype(np.int32)
    return _NO_DRAFT


def _true_token_len(row: np.ndarray) -> int:
    """Real prompt length of a 1-D token row: trailing pad ids (token
    0, the framework-wide pad convention) do not count.  An all-pad row
    keeps its full width — there is no basis to trim it."""
    nz = np.flatnonzero(row)
    return int(nz[-1]) + 1 if nz.size else int(row.shape[0])


def _page_stack(pages, n: int):
    """Host pages ``(values, scale)`` ([L, >= n, bt, hkv, d], scale None
    for a pool of the compute dtype) cut to n pages, in the form
    ``KvImport`` takes: a tensor, or a QTensor of values and scales."""
    values, scale = pages
    if scale is None:
        return values[:, :n]
    return QTensor(values[:, :n], scale[:, :n], (-1,))


def _wire_side(pages, n: int):
    """Host pages ``(values, scale)`` cut to n pages, in the export form
    of a handoff or fetch payload: the page tensor, or ``{"values",
    "scale"}`` for an int8 pool."""
    values, scale = pages
    if scale is None:
        return values[:, :n]
    return {"values": values[:, :n], "scale": scale[:, :n]}


def _host_tensor(raw) -> torch.Tensor:
    return raw if isinstance(raw, torch.Tensor) \
        else torch.from_numpy(np.asarray(raw))


def _not_ported(what: str, item: int) -> NotPortedError:
    return NotPortedError(
        f"{what} is not ported to the decode engine yet (ROADMAP queue 1 "
        f"item {item})")


def copy_adapter_stack(dst: Dict[str, Dict[str, torch.Tensor]],
                       stack) -> None:
    """Copy a registry's host stack (numpy leaves) INTO the device stack
    ``dst``, each leaf cast to its tensor's dtype, without blocking: on
    CUDA from pinned memory, queued on the current stream after every
    call already queued there.  ``dst``'s tensors keep their storage."""
    for grp, leaves in stack.items():
        for k, arr in leaves.items():
            t = dst[grp][k]
            host = torch.from_numpy(np.asarray(arr)).to(t.dtype)
            if t.device.type == "cuda":
                host = host.pin_memory()
            t.copy_(host, non_blocking=t.device.type == "cuda")


class _Readback:
    """Program results on their way to the host without blocking the
    loop: on CUDA, pinned buffers filled by non-blocking copies behind
    one event, waited on only when the results are read; on the CPU,
    copies.  Either way the copies are taken at once, so the program's
    next call may overwrite its output buffers."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type != "cuda":
            self.host = [t.clone() for t in tensors]
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class DecodeEngine:
    """Continuous-batching decode over a persistent slot-based KV cache.

    Args:
      model/decode: the loaded model, a ``Transformer`` on its device,
        and its decode settings (loaders.lm_generate exposes them as
        ``predict.engine_spec``).  The pool and every program run on
        the model's device.
      slots: concurrent sequences.
      prefill_len: static prompt width bound; prompts with more REAL
        tokens (trailing pad ids don't count) fall back to the direct
        generate() path.
      max_len: cache positions per slot (default prefill_len +
        decode.max_new_tokens).
      sync_lag: how many step calls the host may run ahead of token
        materialization (0 = fully synchronous loop).
      steps_per_call: decode steps fused into one step-program call.
      decode_rounds: > 1 replaces the per-step loop with one
        ``decode_rounds`` call advancing every slot up to this many
        steps, drained at each round boundary (sync_lag applies to the
        k=1 path only); the width adapts between 1 and this value.
      admit_width: how many admissions may be MID-PREFILL at once;
        further queued requests wait even when slots are free.  Chunk
        scheduling among them is FIFO (best TTFT for the head of the
        line); which queued request is admitted next is FIFO too, or,
        while a queued request names an adapter, the per-tenant fair
        pick (``_fair_pick_locked``).
      prefill_chunk_tokens: per-step prefill token budget AND the static
        chunk width (clamped to prefill_len).
      kv_block_tokens: paged-KV page size in cache positions, also the
        prefix hash/share granularity.
      kv_pool_blocks: device pool capacity in pages; 0 sizes it to
        ``slots x ceil(max_len / kv_block_tokens)``.
      prefix_caching: publish/reuse shared prefixes as refcounted block
        aliases (False disables lookup and publication).
      max_queue_depth: a submit arriving with this many requests
        already waiting fails fast with Overloaded; 0 = unbounded.
      overload_retry_after_s: the Retry-After hint of a shed.
      speculative_tokens: the static draft width k of the verify
        program (0 disables); clamped to ``max_new_tokens - 1``, dropped
        with a warning when the export samples (speculation is greedy
        only), and it forces ``sync_lag`` to 0: the drafter reads each
        slot's delivered history.
      host_spill_blocks: host-memory spill tier capacity in pages (0
        disables it, as does ``prefix_caching=False``: the tier is
        looked up by the prefix index's digests).  Idle cached pages
        spill there under pool pressure, parked sessions (``park_kv``)
        are copied there at delivery, and ``fetch_kv`` serves it.
      adapters: a serving/adapters.py ``AdapterRegistry`` to serve
        per-tenant low-rank variants from.  Its stacked factors are
        copied to the device in the model dtype, and every program reads
        that copy as a fixed buffer, so the engine runs the same
        programs, no more, for every mix of variants.  Admission
        resolves ``inputs["adapter"]`` to a row (or sheds typed 404 /
        429), pins it until release, and salts the request's
        prefix-digest chain with the adapter's content digest, so
        variants never alias each other's KV pages.  Without it a
        request naming an adapter is refused with ``AdapterNotFound``.
      mesh, partition_rules: the JAX engine's tensor-parallel options,
        not ported yet; any value but None raises ``NotPortedError``.
      cuda_graphs: None (the default) captures the programs as CUDA
        graphs on a CUDA device and runs them eagerly on the CPU; False
        runs them eagerly on CUDA too (a comparison baseline); True on
        the CPU raises.
    """

    def __init__(
        self,
        model,
        decode,
        *,
        slots: int = 8,
        prefill_len: int = 256,
        max_len: Optional[int] = None,
        sync_lag: int = 2,
        steps_per_call: int = 1,
        decode_rounds: int = 1,
        admit_width: int = 4,
        prefill_chunk_tokens: int = 64,
        kv_block_tokens: int = 16,
        kv_pool_blocks: int = 0,
        prefix_caching: bool = True,
        host_spill_blocks: int = 0,
        max_queue_depth: int = 0,
        overload_retry_after_s: float = 1.0,
        speculative_tokens: int = 0,
        mesh=None,
        partition_rules=None,
        adapters=None,
        name: str = "engine",
        cuda_graphs: Optional[bool] = None,
    ):
        from kubeflow_tpu_torch.models.generate import init_paged_state
        from kubeflow_tpu_torch.runtime.prom import REGISTRY

        if mesh is not None or partition_rules is not None:
            raise _not_ported("mesh (tensor-parallel decode)", 6)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.embed.device
        self.decode = decode
        self.slots = slots
        self.prefill_len = int(prefill_len)
        if self.prefill_len < 1:
            # A non-positive width silently rejects EVERY prompt via
            # accepts(): all traffic would fall back to the direct path
            # while the engine holds a pool and a thread.
            raise ValueError(
                f"prefill_len must be >= 1, got {self.prefill_len}")
        self.max_len = int(max_len or prefill_len + decode.max_new_tokens)
        if self.max_len <= self.prefill_len:
            raise ValueError(
                f"max_len {self.max_len} leaves no decode room beyond "
                f"prefill_len {self.prefill_len}")
        if cfg.max_seq_len < self.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds model max_seq_len "
                f"{cfg.max_seq_len}")
        self.sync_lag = max(0, int(sync_lag))
        self.steps_per_call = max(1, int(steps_per_call))
        self.decode_rounds = max(1, int(decode_rounds))
        self.admit_width = max(1, min(int(admit_width), slots))
        self.prefill_chunk_tokens = max(1, int(prefill_chunk_tokens))
        self.chunk_w = min(self.prefill_chunk_tokens, self.prefill_len)
        self.kv_block_tokens = max(1, int(kv_block_tokens))
        # Per-slot block-table span: enough logical pages to cover
        # max_len positions (a static program shape).
        self._table_blocks = -(-self.max_len // self.kv_block_tokens)
        self.kv_pool_blocks = int(kv_pool_blocks) \
            or slots * self._table_blocks
        if self.kv_pool_blocks < 1:
            raise ValueError(
                f"kv_pool_blocks must be >= 1, got {self.kv_pool_blocks}")
        self.prefix_caching = bool(prefix_caching)
        # The host tier rides the prefix index (spilled records are looked
        # up by the same chained digests), so it requires caching.
        self.host_spill_blocks = max(0, int(host_spill_blocks)) \
            if self.prefix_caching else 0
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.overload_retry_after_s = overload_retry_after_s
        self._eos = decode.eos_token >= 0
        # Speculative draft width: greedy exports only, and never more
        # than the largest completion less its free verify token.
        spec = max(0, int(speculative_tokens))
        spec = min(spec, max(0, int(decode.max_new_tokens) - 1))
        if spec and decode.temperature > 0:
            log.warning(
                "engine %r: speculative_tokens=%d ignored: the export "
                "samples at temperature %g and speculation is greedy-only",
                name, spec, decode.temperature)
            spec = 0
        self.speculative_tokens = spec
        if spec:
            # The drafter proposes from each slot's delivered history,
            # so every call drains in its own loop turn.
            self.sync_lag = 0
        self._state = init_paged_state(cfg, slots, self.kv_pool_blocks,
                                       self.kv_block_tokens,
                                       decode.kv_cache_dtype,
                                       device=self.device)
        # Adapter-array serving: the registry's stacked factors on the
        # device, in the model dtype.  Every program reads these tensors
        # as fixed buffers; a new registry version is copied INTO them
        # between program calls (_apply_adapter_updates), never rebound,
        # so the captured graphs read the new rows.
        self._registry = adapters
        self._adapter_version = None
        self._adapter_stack = None
        if adapters is not None:
            stack, self._adapter_version = adapters.stack_snapshot()
            self._adapter_stack = {
                grp: {k: torch.from_numpy(np.array(arr)).to(
                    device=self.device, dtype=cfg.dtype)
                    for k, arr in leaves.items()}
                for grp, leaves in stack.items()}
        # Host-owned per-slot block tables, passed into every program
        # call; the sentinel value (== pool size) sends writes and reads
        # of unallocated logical pages to the pool's scratch block.
        # Loop-thread-owned.  The device copy is re-uploaded (from
        # pinned memory, non-blocking) only when a host edit marked it
        # dirty.
        self._tables = np.full(
            (slots, self._table_blocks), self.kv_pool_blocks, np.int32)
        self._tables_dev = torch.full(
            self._tables.shape, self.kv_pool_blocks, dtype=torch.int64,
            device=self.device)
        self._tables_dirty = False
        # The engine's programs over the state, the device tables and
        # their own buffers, all of which keep their storage for the
        # engine's life; the fused-round program replaces the step
        # program when decode_rounds > 1, as in JAX.  The verify program
        # exists when the engine speculates; the import program always
        # (a decode tier may receive a handoff at any time, and every
        # program is captured before the first admission).
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        self.cuda_graphs = bool(cuda_graphs)
        stack = self._adapter_stack
        self._chunk_prog = programs.ChunkedPrefill(
            model, decode, self._state, self._tables_dev, self.chunk_w,
            graphs=self.cuda_graphs, adapters=stack)
        if self.decode_rounds > 1:
            self._decode_prog = programs.Rounds(
                model, decode, self._state, self._tables_dev,
                self.decode_rounds, graphs=self.cuda_graphs,
                adapters=stack)
        else:
            self._decode_prog = programs.Step(
                model, decode, self._state, self._tables_dev,
                self.steps_per_call, graphs=self.cuda_graphs,
                adapters=stack)
        self._verify_prog = programs.Verify(
            model, decode, self._state, self._tables_dev,
            self.speculative_tokens, graphs=self.cuda_graphs,
            adapters=stack) if self.speculative_tokens else None
        self._import_prog = programs.KvImport(
            model, decode, self._state, self._tables_dev,
            self._table_blocks, graphs=self.cuda_graphs)
        # Capture time and graph-pool bytes, set once the loop thread has
        # captured the programs (None when they run eagerly).
        self.capture_info: Optional[Dict[str, Any]] = None
        self._ready = threading.Event()
        self._capture_error: Optional[BaseException] = None
        # Paged-KV bookkeeping: physical refcounts, admission
        # reservations and the block-hashed prefix index.  Mutated by the
        # loop thread ONLY, always under self._lock (submit reads
        # available() for shed attribution).
        self._mgr = BlockManager(self.kv_pool_blocks,
                                 self.kv_block_tokens,
                                 caching=self.prefix_caching,
                                 host_blocks=self.host_spill_blocks)
        self._evict_rec_seen = 0
        self._evict_blk_seen = 0
        # Which programs have run (the JAX engine's compiled executables;
        # see compiled_programs()).  Loop-thread-owned.
        self._chunk_built = False
        self._step_built = False
        self._rounds_built = False
        self._verify_built = False
        self._import_built = False
        # Fused decode rounds: the adaptive round width, the realized
        # steps-per-round reservoir and the per-token pace EMA the
        # deadline clamp reads.  Loop-thread-owned.
        self._round_k = self.decode_rounds
        self._round_steps: List[int] = []
        self._step_pace_ema: Optional[float] = None
        # Speculation (loop-thread-owned): the drafting-scan stride
        # backoff, the measured delivered-rate EMAs of the decode and
        # verify programs (the throughput gate's inputs) and the
        # gated-round probe counter.
        self._spec_stride = 1
        self._spec_tick = 0
        self._rate_step_ema: Optional[float] = None
        self._rate_verify_ema: Optional[float] = None
        self._spec_probe = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # Streaming delivery: submit_stream() readers wait here and
        # _drain_one notifies after each materialized emission.
        self._emit = threading.Condition(self._lock)
        self._queue: List[dict] = []
        # Per-tenant fair admission: the admission sequence number at
        # which each adapter key ("" = base traffic) was last admitted.
        # Mutated only under the lock.
        self._fair_last: Dict[str, int] = {}
        self._fair_seq = 0
        self._stopped = False
        self._drain_deadline: Optional[float] = None
        # Host-side slot table: None = free, else the live request entry.
        self._slot_req: List[Optional[dict]] = [None] * slots
        # Admitted entries whose prompts are still chunk-prefilling
        # (FIFO).  Loop-thread-owned; the admission pop reads its length.
        self._prefilling: List[dict] = []
        # (_Readback, [(slot, entry), ...], has_counts) emissions not yet
        # read.
        self._pending: List[tuple] = []
        # Counters (mutated by the loop thread, snapshotted under the
        # lock).
        self._counters = {
            "requests": 0, "tokens": 0, "steps": 0, "prefills": 0,
            "occupancy_sum": 0, "busy_s": 0.0, "in_flight": 0,
            "shed": 0, "expired": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_evictions": 0,
            "prefill_chunks": 0, "cached_tokens": 0, "prompt_tokens": 0,
            "spec_drafted": 0, "spec_accepted": 0, "spec_steps": 0,
            "kv_evictions": 0, "kv_shed_no_blocks": 0,
            "handoff_pages_out": 0, "handoff_pages_in": 0,
            "fused_rounds": 0, "fused_steps_wasted": 0,
            "spill_pages_out": 0, "spill_pages_in": 0,
            "parked_sessions": 0, "fetches": 0,
        }
        # Host-clock seconds the loop spent gathering pages into the host
        # tier (spill-out and park) and re-importing them (spill-in), and
        # the pages those timed calls moved; loop-thread-owned, read for
        # measurement, not part of stats().
        self.spill_timing = {"out_s": 0.0, "out_pages": 0, "in_s": 0.0,
                             "in_pages": 0}
        self._step_times: List[float] = []   # bounded reservoirs
        self._chunk_times: List[float] = []
        self._gap_times: List[float] = []
        self._ttft_times: List[float] = []
        self._last_step_end: Optional[float] = None
        self._metric_name = name
        self._occ_gauge = REGISTRY.gauge(
            "kft_engine_active_slots",
            "decode engine live slots, by engine")
        self._queue_gauge = REGISTRY.gauge(
            "kft_engine_queue_depth",
            "decode engine admission queue depth, by engine")
        self._tok_counter = REGISTRY.counter(
            "kft_engine_tokens_total",
            "tokens emitted by the decode engine, by engine")
        self._step_hist = REGISTRY.histogram(
            "kft_engine_step_seconds",
            "decode engine per-step (= per-token) latency, by engine",
            buckets=_STEP_BUCKETS,
        ).declare(engine=name)
        self._hits_ctr = REGISTRY.counter(
            PREFIX_HITS_TOTAL, PREFIX_HITS_HELP)
        self._misses_ctr = REGISTRY.counter(
            PREFIX_MISSES_TOTAL, PREFIX_MISSES_HELP)
        self._evict_ctr = REGISTRY.counter(
            PREFIX_EVICTIONS_TOTAL, PREFIX_EVICTIONS_HELP)
        self._chunks_ctr = REGISTRY.counter(
            PREFILL_CHUNKS_TOTAL, PREFILL_CHUNKS_HELP)
        self._kv_blocks_gauge = REGISTRY.gauge(
            KV_BLOCKS_GAUGE, KV_BLOCKS_HELP)
        self._kv_used_gauge = REGISTRY.gauge(
            KV_BLOCKS_USED_GAUGE, KV_BLOCKS_USED_HELP)
        self._kv_evict_ctr = REGISTRY.counter(
            KV_EVICTIONS_TOTAL, KV_EVICTIONS_HELP)
        self._kv_shed_ctr = REGISTRY.counter(
            KV_SHED_TOTAL, KV_SHED_HELP)
        self._fused_rounds_ctr = REGISTRY.counter(
            FUSED_ROUNDS_TOTAL, FUSED_ROUNDS_HELP)
        self._fused_wasted_ctr = REGISTRY.counter(
            FUSED_WASTED_TOTAL, FUSED_WASTED_HELP)
        self._spec_drafted_ctr = REGISTRY.counter(
            SPEC_DRAFTED_TOTAL, SPEC_DRAFTED_HELP)
        self._spec_accepted_ctr = REGISTRY.counter(
            SPEC_ACCEPTED_TOTAL, SPEC_ACCEPTED_HELP)
        self._handoff_ctr = REGISTRY.counter(
            HANDOFF_PAGES_TOTAL, HANDOFF_PAGES_HELP)
        self._kv_spilled_gauge = REGISTRY.gauge(
            KV_SPILLED_GAUGE, KV_SPILLED_HELP)
        self._host_tier_gauge = REGISTRY.gauge(
            HOST_TIER_GAUGE, HOST_TIER_HELP)
        self._kv_spill_ctr = REGISTRY.counter(
            KV_SPILL_TOTAL, KV_SPILL_HELP)
        self._adapter_req_ctr = REGISTRY.counter(
            ADAPTER_REQUESTS_TOTAL, ADAPTER_REQUESTS_HELP)
        # Fault-layer series: same names as the static batchers', so
        # shed/expired rates read uniformly across batching planes.
        self._shed_ctr = REGISTRY.counter(SHED_TOTAL, SHED_HELP)
        self._expired_ctr = REGISTRY.counter(EXPIRED_TOTAL, EXPIRED_HELP)
        self._occ_gauge.set(0, engine=name)
        self._queue_gauge.set(0, engine=name)
        self._kv_blocks_gauge.set(self.kv_pool_blocks, engine=name)
        self._kv_used_gauge.set(0, engine=name)
        self._kv_spilled_gauge.set(0, engine=name)
        self._host_tier_gauge.set(self.host_spill_blocks, engine=name)
        # Last values pushed to the gauges: the step loop only touches
        # the (locked) registry when a value actually changes.
        self._occ_last = 0
        self._queue_last = 0
        self._kv_used_last = 0
        self._kv_spilled_last = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"decode-engine-{name}")
        self._thread.start()
        # The programs are captured on the loop thread before it admits
        # anything; no request can reach the engine before this returns.
        self._ready.wait()
        if self._capture_error is not None:
            self._thread.join(timeout=5.0)
            raise RuntimeError(
                f"engine {name!r}: CUDA graph capture of its programs "
                f"failed: {self._capture_error!r}") from self._capture_error

    # -- client surface ---------------------------------------------------

    def accepts(self, inputs: Dict[str, Any]) -> bool:
        """ModelServer routing hook: prompts whose REAL token count (an
        explicit ``prompt_len``, else the width minus trailing pad ids)
        exceeds the static prefill width fall back to the direct
        generate() path.  A short prompt arriving right-padded is
        admitted at its true length."""
        tokens = np.asarray(inputs.get("tokens", ()))
        if tokens.ndim == 0 or tokens.size == 0:
            return False
        row = tokens.reshape(-1)
        if "prompt_len" in inputs:
            length = int(np.asarray(inputs["prompt_len"]).reshape(()))
            if not 0 < length <= row.shape[0]:
                return False
        else:
            length = _true_token_len(row)
        # A resume's delivered tokens join the context, so they count
        # against the static prefill width too.
        length += int(np.asarray(
            inputs.get("resume_tokens", ())).size)
        return bool(0 < length <= self.prefill_len)

    def submit(self, inputs: Dict[str, Any],
               deadline: Optional[float] = None) -> Dict[str, Any]:
        """One request: tokens [t] or [1, t]; optional per-request
        ``max_new_tokens`` (<= the export's budget), sampling ``seed``,
        and ``prompt_len`` (real token count of a right-padded prompt;
        without it trailing pad ids, token 0, are trimmed).  Blocks until
        the completion is ready; returns {"tokens": [1, true_len +
        emitted]}.  With ``return_timing`` truthy the result also
        carries ``ttft_s`` / ``latency_s`` / ``cached_tokens``.

        ``resume_tokens`` (mid-generation failover): tokens a prior
        attempt of this request already emitted.  They join the prompt
        as context and the budget shrinks by their count, so the engine
        emits exactly the suffix an uninterrupted greedy run would have
        produced after them.

        ``deadline`` (absolute faults.monotonic() instant) is enforced
        everywhere the request lives: on arrival, in the queue, and in
        flight, where an expired request is retired through the
        deterministic-retirement path and its slot frees for the next
        admission."""
        entry = self._admit(inputs, deadline)
        entry["event"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    def prefill_export(self, inputs: Dict[str, Any],
                       deadline: Optional[float] = None) -> Dict[str, Any]:
        """Disaggregated serving, prefill tier: admit the prompt as an
        ordinary request clamped to one generated token and return the
        result with its finished full-block pages under ``kv_handoff``
        (see _attach_export).  A prompt too short to cover one full page
        returns no payload."""
        fwd = dict(inputs)
        fwd["kv_export"] = True
        fwd["max_new_tokens"] = 1
        return self.submit(fwd, deadline=deadline)

    def submit_stream(self, inputs: Dict[str, Any],
                      deadline: Optional[float] = None):
        """Streaming twin of :meth:`submit`: admits the request (the same
        validation, deadlines, resume and typed sheds, all raised here
        before any token) and returns ``(meta, iterator)``.  ``meta``
        says whether a replay with ``resume_tokens`` is token-identical
        (``resumable``: a greedy export), whether a sampling seed was
        given (``seeded``), the admitted context width and the granted
        budget.  The iterator yields lists of newly emitted token ints as
        the loop delivers them, and raises the request's typed error if
        it fails after admission."""
        entry = self._admit(inputs, deadline)
        meta = {
            "resumable": self.decode.temperature <= 0.0,
            "seeded": inputs.get("seed") is not None,
            "prompt_tokens": int(entry["tokens"].shape[1]),
            "max_new_tokens": entry["new"],
        }

        def stream():
            sent = 0
            while True:
                with self._emit:
                    n = len(entry["emitted"])
                    if n <= sent and not entry["event"].is_set():
                        self._emit.wait(timeout=0.02)
                        continue
                if n > sent:
                    chunk = [int(t) for t in entry["emitted"][sent:n]]
                    sent = n
                    yield chunk
                if entry["event"].is_set() \
                        and sent >= len(entry["emitted"]):
                    if entry["err"] is not None:
                        raise entry["err"]
                    return

        return meta, stream()

    def fetch_kv(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """Fleet-wide session fetch (any thread): the longest HOST-TIER
        match of ``tokens`` in the export form (``{"kv_handoff",
        "tokens_covered"}``; serving/http.py's ``encode_kv_handoff``
        makes it portable), or ``{"kv_handoff": None, "tokens_covered":
        0}`` on a miss.  Host tier only, by design: the device pool and
        the programs' buffers belong to the loop thread and its queued
        graphs, so this never touches a device tensor, and parked or
        spilled sessions, what a failover survivor needs, are
        host-resident by construction.  ``adapter_digest`` salts the
        lookup as the JAX engine's does (a variant's pages are addressed
        by its content digest)."""
        tokens = np.asarray(inputs["tokens"], np.int32).reshape(-1)
        salt = b""
        digest = inputs.get("adapter_digest")
        if digest:
            salt = bytes.fromhex(str(digest))
        # Chaos hook: the cross-replica fetch path (raise = fetch failure,
        # the caller falls back to recompute; sleep = slow fetch).
        faults.fire("engine.fetch")
        with self._lock:
            self._counters["fetches"] += 1
            payload, depth = self._mgr.lookup_spilled(
                tokens, int(tokens.shape[0]), salt=salt)
        if payload is None:
            return {"kv_handoff": None, "tokens_covered": 0}
        covered = depth * self.kv_block_tokens
        return {
            "kv_handoff": {
                "block_tokens": self.kv_block_tokens,
                "tokens_covered": covered,
                "k": _wire_side(payload["k"], depth),
                "v": _wire_side(payload["v"], depth),
            },
            "tokens_covered": covered,
        }

    def _admit(self, inputs: Dict[str, Any],
               deadline: Optional[float]) -> dict:
        """Validate + enqueue one request (submit and submit_stream share
        it); returns the live entry whose ``event`` resolves it."""
        tokens = np.asarray(inputs["tokens"], np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        n, width = tokens.shape
        if n != 1:
            raise ValueError(
                f"DecodeEngine.submit takes one prompt per call (got "
                f"batch dim {n}); submit rows separately")
        if "prompt_len" in inputs:
            length = int(np.asarray(inputs["prompt_len"]).reshape(()))
            if not 0 < length <= width:
                raise ValueError(
                    f"prompt_len {length} outside (0, {width}] "
                    f"(the tokens width)")
        else:
            length = _true_token_len(tokens[0])
        if length <= 0:
            raise ValueError(
                f"true prompt length {length} must be positive")
        tokens = np.ascontiguousarray(tokens[:, :length])
        # Mid-generation resume: a prior attempt's delivered tokens join
        # the context and the budget shrinks by their count.
        resume = np.asarray(
            inputs.get("resume_tokens", ()), np.int32).reshape(-1)
        resume_len = int(resume.shape[0])
        total_budget = int(np.asarray(inputs.get(
            "max_new_tokens", self.decode.max_new_tokens)).reshape(()))
        if total_budget < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {total_budget}")
        total_budget = min(total_budget, self.decode.max_new_tokens)
        if resume_len:
            faults.fire("engine.resume")
            if resume_len > total_budget:
                raise ValueError(
                    f"resume_tokens carries {resume_len} tokens but "
                    f"the budget is {total_budget}")
            tokens = np.concatenate([tokens, resume[None]], axis=1)
            length += resume_len
            if resume_len == total_budget or (
                    self._eos
                    and bool(np.any(resume == self.decode.eos_token))):
                # The prior attempt already finished the generation:
                # resolve as a completed request, nothing to emit.
                return self._completed_entry(tokens, inputs)
        if not 0 < length <= self.prefill_len:
            raise ValueError(
                f"true context length {length} (prompt + "
                f"{resume_len} resumed) outside "
                f"(0, {self.prefill_len}] (engine prefill width)")
        # The export config's max_new_tokens is the ceiling, and the
        # cache headroom caps it further, both against the TRUE length.
        new = min(total_budget - resume_len, self.max_len - length)
        seed = int(np.asarray(inputs.get("seed", 0)).reshape(()))
        # Disaggregated serving: ``kv_export`` marks a prefill-tier
        # request whose result carries its finished pages; ``kv_handoff``
        # is the decode tier's import payload, validated here so a
        # malformed one answers 400 before any device work.
        export = bool(inputs.get("kv_export"))
        handoff = self._parse_handoff(inputs.get("kv_handoff"), length)
        if deadline is not None and faults.monotonic() >= deadline:
            with self._lock:
                self._counters["expired"] += 1
            self._expired_ctr.inc(batcher=self._metric_name)
            raise DeadlineExceeded(
                f"deadline expired before engine "
                f"{self._metric_name!r} admission")
        # Adapter resolution: name -> stacked row, PINNED from here to
        # release so LRU eviction never recycles a row under an in-flight
        # request.  Unknown names shed typed 404, exhausted slots or an
        # open load breaker 429, all before any queue state exists.
        # Every terminal path below unpins (_unpin_adapter is
        # idempotent), so "evictable" is exactly "no live request".
        adapter_name = inputs.get("adapter")
        adapter_idx, adapter_salt, adapter_pin = 0, b"", None
        if adapter_name:
            adapter_name = str(adapter_name)
            if self._registry is None:
                raise AdapterNotFound(
                    f"engine {self._metric_name!r} serves no adapters "
                    f"(requested {adapter_name!r})")
            adapter_idx, digest = self._registry.acquire(adapter_name)
            adapter_pin = adapter_idx
            # KV is scoped by the adapter's CONTENT digest (stable across
            # replicas, unlike the row index).
            adapter_salt = bytes.fromhex(digest)
            self._adapter_req_ctr.inc(
                engine=self._metric_name, adapter=adapter_name)
        else:
            adapter_name = None
        # Worst-case paged-KV reservation: every position the request
        # could ever write (prompt + full budget) in whole pages.
        # Reserving it at admission is what makes block exhaustion a
        # typed shed instead of a mid-flight deadlock.
        res_blocks = -(-(length + new) // self.kv_block_tokens)
        trace_ctx = tracing.current_ctx()
        entry = {
            "tokens": tokens, "new": new, "seed": seed,
            "emitted": [], "scheduled": 0, "slot": None,
            "trace": trace_ctx,
            "t_perf": time.perf_counter()
            if trace_ctx is not None else 0.0,
            "t_first_perf": None, "spec_acc": 0,
            "prefilling": False, "pos": 0, "cached": 0,
            "res_blocks": res_blocks, "res_left": 0, "blocks": [],
            "released": False,
            "export": export, "handoff": handoff,
            "park": bool(inputs.get("park_kv")),
            "spill_in": None,
            "adapter": adapter_idx, "adapter_salt": adapter_salt,
            "adapter_name": adapter_name,
            # Adaptive draft width: grows on full accepts, shrinks on
            # full rejects; 0 = backed off (re-probes after cooldown).
            "spec_k": self.speculative_tokens, "spec_cool": 0,
            # Drafting history (prompt + emitted), kept by the drain.
            "hist": None, "hist_len": 0,
            "deadline": deadline,
            "want_timing": bool(inputs.get("return_timing")),
            "event": threading.Event(), "out": None, "err": None,
            "t": faults.monotonic(), "t_first": None,
        }
        if adapter_pin is not None:
            entry["adapter_pin"] = adapter_pin
        if self.speculative_tokens:
            hist = np.empty((length + new,), np.int32)
            hist[:length] = tokens[0]
            entry["hist"] = hist
            entry["hist_len"] = length
            # Only a prompt that repeats a bigram can draft at
            # admission, so only such an admission resets the backoff.
            if length >= 3:
                pairs = (hist[:length - 1].astype(np.int64) << 32) \
                    | hist[1:length].astype(np.int64)
                entry["spec_seed"] = bool(
                    np.unique(pairs).size < length - 1)
            else:
                entry["spec_seed"] = False
        with self._lock:
            if self._stopped:
                self._unpin_adapter(entry)
                raise BatcherClosed(
                    f"engine {self._metric_name!r} is closed")
            if res_blocks > self.kv_pool_blocks:
                # The request's worst case can NEVER fit this pool:
                # queueing it would wedge the admission head forever.
                self._counters["shed"] += 1
                self._counters["kv_shed_no_blocks"] += 1
                self._shed_ctr.inc(batcher=self._metric_name)
                self._kv_shed_ctr.inc(engine=self._metric_name)
                self._unpin_adapter(entry)
                raise Overloaded(
                    f"request needs {res_blocks} KV blocks but engine "
                    f"{self._metric_name!r}'s pool holds "
                    f"{self.kv_pool_blocks}",
                    retry_after_s=self.overload_retry_after_s)
            if self.max_queue_depth \
                    and len(self._queue) >= self.max_queue_depth:
                # Bounded admission: fail fast instead of queueing
                # unboundedly.  When the pool, not the slot count, is
                # what binds, the kv counter says so.
                self._counters["shed"] += 1
                if self._mgr.available() < res_blocks:
                    self._counters["kv_shed_no_blocks"] += 1
                    self._kv_shed_ctr.inc(engine=self._metric_name)
                self._shed_ctr.inc(batcher=self._metric_name)
                self._unpin_adapter(entry)
                raise Overloaded(
                    f"engine {self._metric_name!r} admission queue "
                    f"full ({len(self._queue)} waiting, "
                    f"{self.slots} slots busy)",
                    retry_after_s=self.overload_retry_after_s)
            self._queue.append(entry)
            self._set_queue_gauge(len(self._queue))
            self._work.notify()
        return entry

    def _completed_entry(self, tokens: np.ndarray,
                         inputs: Dict[str, Any]) -> dict:
        """A resume whose prior attempt already finished: resolve
        without touching the loop — the full context IS the result."""
        entry = {
            "tokens": tokens, "new": 0, "emitted": [],
            "out": {"tokens": tokens}, "err": None,
            "event": threading.Event(),
        }
        if inputs.get("return_timing"):
            entry["out"]["ttft_s"] = 0.0
            entry["out"]["latency_s"] = 0.0
            entry["out"]["cached_tokens"] = 0
        entry["event"].set()
        return entry

    def compiled_programs(self) -> Dict[str, int]:
        """Which programs this engine has run, in the JAX engine's terms
        (it counts AOT-compiled executables; this port counts a program
        once the engine has run it, captured or not): {"chunked_prefill",
        "step", "verify"} ("verify" once a slot drafted and a verify
        call ran), plus ``kv_import`` once a handoff was imported and
        ``decode_rounds`` once the fused program ran."""
        out = {"chunked_prefill": int(self._chunk_built),
               "step": int(self._step_built),
               "verify": int(self._verify_built)}
        if self._import_built:
            out["kv_import"] = 1
        if self._rounds_built:
            out["decode_rounds"] = 1
        return out

    def adapter_info(self) -> List[Dict[str, Any]]:
        """Resident adapters (name, digest, index, pins) for the /readyz
        advertisement; empty when this engine serves no adapters."""
        return self._registry.loaded() if self._registry is not None \
            else []

    def stats(self) -> Dict[str, Any]:
        """Locked snapshot of the engine counters: occupancy, queue
        depth, throughput, per-token latency, prefix-cache
        effectiveness and prefill-interference bounds.  The keys are
        the JAX engine's (``mesh_devices`` is 1: the port's engine runs
        on one device)."""
        c, extra = locked_snapshot(
            self._lock, self._counters,
            lambda: {
                "queue_depth": len(self._queue),
                "active_slots": sum(
                    r is not None for r in self._slot_req),
                "kv_used": self._mgr.used_blocks(),
                "host_used": self._mgr.host_used_blocks(),
                "step_times": list(self._step_times),
                "chunk_times": list(self._chunk_times),
                "gap_times": list(self._gap_times),
                "ttft_times": list(self._ttft_times),
                "round_steps": list(self._round_steps),
            })
        steps = c["steps"]
        # Sort each reservoir ONCE, outside the lock.
        times = sorted(extra["step_times"])
        gaps = sorted(extra["gap_times"])
        chunks = sorted(extra["chunk_times"])
        ttfts = sorted(extra["ttft_times"])
        rounds = sorted(extra["round_steps"])

        def pct_raw(sorted_values, q):
            if not sorted_values:
                return 0
            return sorted_values[min(len(sorted_values) - 1,
                                     int(len(sorted_values) * q))]

        def pct(sorted_values, q):
            return round(pct_raw(sorted_values, q) * 1e3, 3) \
                if sorted_values else 0.0

        prompt_toks = c["prompt_tokens"]
        out = {
            "requests": c["requests"],
            "tokens": c["tokens"],
            "steps": steps,
            "prefills": c["prefills"],
            "slots": self.slots,
            "active_slots": extra["active_slots"],
            "queue_depth": extra["queue_depth"],
            # Admitted but not yet delivered: THIS is the drain signal
            # (deterministic retirement frees a slot at dispatch, before
            # the lagged emission reaches its client).
            "in_flight_requests": c["in_flight"],
            "shed": c["shed"],
            "deadline_expired": c["expired"],
            "prefix_hits": c["prefix_hits"],
            "prefix_misses": c["prefix_misses"],
            "prefix_evictions": c["prefix_evictions"],
            "cached_prompt_tokens": c["cached_tokens"],
            "prompt_tokens": prompt_toks,
            "cached_token_ratio": round(
                c["cached_tokens"] / prompt_toks, 4)
            if prompt_toks else 0.0,
            "kv_blocks": self.kv_pool_blocks,
            "kv_blocks_used": extra["kv_used"],
            "kv_block_tokens": self.kv_block_tokens,
            "kv_block_evictions": c["kv_evictions"],
            "kv_shed_no_blocks": c["kv_shed_no_blocks"],
            "tokens_resident": extra["kv_used"] * self.kv_block_tokens,
            "kv_utilization": round(
                extra["kv_used"] / self.kv_pool_blocks, 4)
            if self.kv_pool_blocks else 0.0,
            # The host spill tier: its occupancy and flow.
            # tokens_addressable is the two-tier capacity (positions
            # servable without a cold prefill, pool plus host tier);
            # kv_spill_ratio the host tier's used / capacity.
            "host_spill_blocks": self.host_spill_blocks,
            "host_tier_used": extra["host_used"],
            "kv_spill_pages_out": c["spill_pages_out"],
            "kv_spill_pages_in": c["spill_pages_in"],
            "parked_sessions": c["parked_sessions"],
            "kv_fetches": c["fetches"],
            "tokens_addressable": (self.kv_pool_blocks
                                   + self.host_spill_blocks)
            * self.kv_block_tokens,
            "kv_spill_ratio": round(
                extra["host_used"] / self.host_spill_blocks, 4)
            if self.host_spill_blocks else 0.0,
            "mesh_devices": 1,
            "handoff_pages_out": c["handoff_pages_out"],
            "handoff_pages_in": c["handoff_pages_in"],
            # Speculation: drafted and accepted tokens and the extra
            # tokens a verify call delivered beyond a decode step's one.
            "spec_drafted": c["spec_drafted"],
            "spec_accepted": c["spec_accepted"],
            "spec_steps": c["spec_steps"],
            "spec_acceptance_rate": round(
                c["spec_accepted"] / c["spec_drafted"], 4)
            if c["spec_drafted"] else 0.0,
            "accepted_per_step": round(
                c["spec_accepted"] / c["spec_steps"], 3)
            if c["spec_steps"] else 0.0,
            "decode_rounds": self.decode_rounds,
            "fused_rounds": c["fused_rounds"],
            "fused_steps_wasted": c["fused_steps_wasted"],
            "steps_per_round_p50": pct_raw(rounds, 0.50),
            "steps_per_round_p99": pct_raw(rounds, 0.99),
            "compiled_programs": self.compiled_programs(),
            "prefill_chunks": c["prefill_chunks"],
            "prefill_chunk_p95_ms": pct(chunks, 0.95),
            "mean_occupancy": round(c["occupancy_sum"] / steps, 2)
            if steps else 0.0,
            "tokens_per_sec": round(c["tokens"] / c["busy_s"], 1)
            if c["busy_s"] else 0.0,
            "token_latency_p50_ms": pct(times, 0.50),
            "token_latency_p95_ms": pct(times, 0.95),
            "token_latency_p99_ms": pct(times, 0.99),
            # Wall time between consecutive step-call completions while
            # slots were live: the client-visible inter-token gap,
            # including interleaved admission/prefill work.
            "inter_token_gap_p50_ms": pct(gaps, 0.50),
            "inter_token_gap_p99_ms": pct(gaps, 0.99),
            "inter_token_gap_max_ms": round(gaps[-1] * 1e3, 3)
            if gaps else 0.0,
            "ttft_p50_ms": pct(ttfts, 0.50),
            "ttft_p99_ms": pct(ttfts, 0.99),
        }
        if self._registry is not None:
            # Registry occupancy and the resident name/digest list.
            out["adapters"] = self._registry.stats()
            out["adapters"]["loaded"] = self._registry.loaded()
        return out

    def close(self, drain_s: float = 10.0) -> None:
        """Deterministic shutdown: refuse new work, give in-flight
        requests ``drain_s`` to finish, fail whatever remains with
        BatcherClosed, and join the loop thread (bounded)."""
        with self._lock:
            if self._stopped:
                self._work.notify_all()
            else:
                self._stopped = True
                self._drain_deadline = faults.monotonic() \
                    + max(0.0, drain_s)
                self._work.notify_all()
        self._thread.join(timeout=max(5.0, drain_s + 5.0))
        if not self._thread.is_alive():
            # A hot swap builds a new engine: this one's graphs and
            # their pool go now, not when the object is collected.
            for prog in self._programs():
                prog.release()
        # The prefix index dies with the engine (reload invalidation:
        # the serving layer rebuilds engine + pool per model version).
        with self._lock:
            self._mgr.invalidate()
        # A closed engine exports no live slots, queue or resident KV.
        self._set_occ_gauge(0)
        self._set_queue_gauge(0)
        self._kv_blocks_gauge.set(0, engine=self._metric_name)
        self._set_kv_used_gauge(0)
        self._kv_spilled_gauge.set(0, engine=self._metric_name)
        self._kv_spilled_last = 0
        self._host_tier_gauge.set(0, engine=self._metric_name)

    # -- step loop --------------------------------------------------------

    def _free_slots_locked(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _fair_pick_locked(self) -> int:
        """Per-tenant fair admission: among the queued requests, pick the
        one whose adapter key ("" = base traffic) was admitted least
        recently, oldest first within a tenant, so a hot adapter's burst
        cannot starve co-batched neighbours.  FIFO when nothing queued
        names an adapter.  The caller still stops on the first pick the
        pool cannot plan, so a waiting request is never jumped
        indefinitely."""
        if self._registry is None or len(self._queue) < 2:
            return 0
        if all(e.get("adapter_name") is None for e in self._queue):
            return 0
        best, best_key = 0, None
        for i, e in enumerate(self._queue):
            key = (self._fair_last.get(e.get("adapter_name") or "", -1), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _apply_adapter_updates(self) -> None:
        """Hot adapter load/evict, device side (loop thread, between
        program calls): when the registry's version moved, copy its
        stacked factors INTO the resident device tensors.  The copies are
        queued on the programs' stream, so calls already queued read the
        old rows and the next call the new; the tensors keep their
        storage, which the captured graphs read (rebinding them would
        leave the graphs serving the old rows).  Shapes never change, so
        nothing is recaptured."""
        stack, version = self._registry.stack_snapshot()
        if version == self._adapter_version:
            return
        copy_adapter_stack(self._adapter_stack, stack)
        self._adapter_version = version

    def _sweep_expired_locked(self) -> List[dict]:
        """Pull every deadline-expired request out of the queue AND the
        live slot table (caller fails them outside the lock).

        In-flight expiry rides the deterministic-retirement path: the
        slot is freed NOW (the next admission's first chunk freezes it on
        the device), and the request's lagged emissions still in
        _pending are dropped by _drain_one's event-set check."""
        pnow = faults.monotonic()
        expired: List[dict] = []
        live = []
        for entry in self._queue:
            d = entry["deadline"]
            if d is not None and d <= pnow:
                expired.append(entry)
            else:
                live.append(entry)
        if len(live) != len(self._queue):
            self._queue[:] = live
            self._set_queue_gauge(len(self._queue))
        for i, entry in enumerate(self._slot_req):
            if entry is None:
                continue
            d = entry["deadline"]
            if d is not None and d <= pnow:
                self._slot_req[i] = None
                # Park the dead occupant's table row: its in-flight
                # device state (done may still be False) keeps advancing
                # harmlessly, but every write now lands on the scratch
                # block, so its freed pages can be reallocated at once.
                self._tables[i][:] = self.kv_pool_blocks
                self._tables_dirty = True
                self._release_entry_locked(entry)
                self._counters["in_flight"] -= 1
                expired.append(entry)
        # Deterministically-retired requests live in NEITHER the queue
        # nor the slot table while their lagged emissions sit in
        # _pending: a request is in flight until delivery, so its
        # deadline is enforced on this tail too.
        for _, snapshot, _ in self._pending:
            for _, entry in snapshot:
                if entry["event"].is_set():
                    continue
                d = entry["deadline"]
                if d is None or d > pnow:
                    continue
                if any(entry is e for e in expired):
                    continue
                self._release_entry_locked(entry)
                self._counters["in_flight"] -= 1
                expired.append(entry)
        if expired:
            self._counters["expired"] += len(expired)
        return expired

    def _fail_expired(self, expired: List[dict]) -> None:
        if not expired:
            return
        self._expired_ctr.inc(len(expired), batcher=self._metric_name)
        for entry in expired:
            # Queue-expired entries never reach _release_entry_locked
            # (they hold no pages): unpin their adapters here.
            self._unpin_adapter(entry)
        for entry in expired:
            if not entry["event"].is_set():
                if entry["trace"] is not None:
                    tracing.record_span(
                        "engine.request", entry["trace"],
                        entry["t_perf"], time.perf_counter(),
                        status="deadline_expired",
                        attrs={"engine": self._metric_name,
                               "emitted": len(entry["emitted"]),
                               "budget": entry["new"]})
                entry["err"] = DeadlineExceeded(
                    f"deadline expired after {len(entry['emitted'])} "
                    f"of {entry['new']} tokens "
                    f"(engine {self._metric_name!r})")
                entry["event"].set()

    def _unpin_adapter(self, entry: dict) -> None:
        """Drop an entry's adapter pin (idempotent: the pin is popped
        once).  Every terminal path calls this (release, expiry, queue
        failure, abort and the typed admission sheds), so an adapter row
        is LRU-evictable exactly when no live request references it."""
        pin = entry.pop("adapter_pin", None)
        if pin is not None and self._registry is not None:
            self._registry.release(pin)

    def _release_entry_locked(self, entry: dict) -> None:
        """Return an entry's physical pages (slot refs) and never-taken
        reservation to the pool.  Pages a published prefix record
        advertises stay resident as evictable cache.  Idempotent; never
        touches the slot's table row (it may belong to a successor)."""
        self._unpin_adapter(entry)
        if entry["released"]:
            return
        entry["released"] = True
        self._mgr.release(entry["blocks"], unreserve=entry["res_left"])
        entry["blocks"] = []
        entry["res_left"] = 0

    def _plan_blocks_locked(self, entry: dict):
        """Reserve the entry's worst-case page count (aliasing the
        longest cached prefix for free); None = the pool cannot cover it
        yet, leave the request at the queue head.  A handoff's pages
        arrive from the prefill tier into private blocks, so its whole
        worst case reserves (no prefix lookup).  When the HOST tier
        covers more of the prompt than the device index, the admission
        plans like a handoff too (a full private reservation) and
        re-imports the spilled pages through ``KvImport``."""
        prompt = entry["tokens"][0]
        # Adapter-scoped KV: a variant's chain is salted with its digest.
        salt = entry.get("adapter_salt", b"")
        limit = 0 if entry.get("handoff") else int(prompt.shape[0]) - 1
        spill_in = None
        if limit > 0 and self.host_spill_blocks:
            payload, depth = self._mgr.lookup_spilled(prompt, limit,
                                                      salt=salt)
            if payload is not None and depth * self.kv_block_tokens \
                    > self._mgr.peek(prompt, limit, salt=salt):
                spill_in = (payload, depth)
                limit = 0
        plan = self._mgr.admit(prompt, limit, entry["res_blocks"],
                               salt=salt)
        if plan is not None:
            entry["spill_in"] = spill_in
        return plan

    # -- disaggregated prefill/decode handoff ----------------------------

    def _parse_handoff(self, payload, length: int):
        """Validate + normalize a KV-handoff payload against this
        engine's pool geometry; returns {"covered", "k", "v"} (the full
        pages covering at most ``length - 1`` positions, CPU tensors, or
        QTensors of int8 values and float32 scales for an int8 pool: at
        least one prompt token recomputes locally, and its final chunk
        arms the slot's scalars), or None when nothing is importable.  A
        geometry or dtype mismatch raises ValueError (a 400): a payload
        from a differently configured replica must not reach the pool,
        and a pool of one kind refuses a payload of the other.  Pages of
        another floating dtype are cast to the pool's, as JAX casts
        them."""
        if payload is None:
            return None
        if not isinstance(payload, dict):
            raise ValueError("kv_handoff must be an object")
        bt = int(payload.get("block_tokens", 0))
        if bt != self.kv_block_tokens:
            raise ValueError(
                f"kv_handoff block_tokens {bt} != engine page size "
                f"{self.kv_block_tokens}")
        cfg = self.cfg
        int8 = self.decode.kv_cache_dtype == "int8"
        dtype_name = str(cfg.dtype).replace("torch.", "")
        page_shape = (cfg.n_layers, self.kv_block_tokens, cfg.n_kv_heads,
                      cfg.head_dim)

        def norm(side, raw):
            if int8:
                if not isinstance(raw, dict) or "values" not in raw \
                        or "scale" not in raw:
                    raise ValueError(
                        f"kv_handoff {side}: engine pool is int8 — "
                        f"payload needs values + scale")
                values = _host_tensor(raw["values"]).to(torch.int8)
                scale = _host_tensor(raw["scale"]).to(torch.float32)
                if scale.shape != values.shape[:-1]:
                    raise ValueError(
                        f"kv_handoff {side}: scale {tuple(scale.shape)} "
                        f"must match values {tuple(values.shape)} minus "
                        f"the trailing dim")
                return values, scale
            if isinstance(raw, dict):
                raise ValueError(
                    f"kv_handoff {side}: engine pool is {dtype_name} "
                    f"— got a quantized payload")
            pages = _host_tensor(raw)
            if not pages.dtype.is_floating_point:
                raise ValueError(
                    f"kv_handoff {side}: pages of dtype {pages.dtype} "
                    f"cannot fill a {dtype_name} pool")
            return pages, None

        k_pages = norm("k", payload.get("k"))
        v_pages = norm("v", payload.get("v"))
        for side, (values, _) in (("k", k_pages), ("v", v_pages)):
            if values.ndim != 5 or (values.shape[0],) \
                    + tuple(values.shape[2:]) != page_shape:
                raise ValueError(
                    f"kv_handoff {side} pages {tuple(values.shape)} do not "
                    f"match pool pages [layers={page_shape[0]}, n, "
                    f"block_tokens={page_shape[1]}, hkv={page_shape[2]}, "
                    f"d={page_shape[3]}]")
        if k_pages[0].shape[1] != v_pages[0].shape[1]:
            raise ValueError("kv_handoff k/v page counts differ")
        n = min(int(k_pages[0].shape[1]),
                (int(length) - 1) // self.kv_block_tokens)
        if n <= 0:
            return None
        return {"covered": n * self.kv_block_tokens,
                "k": _page_stack(k_pages, n), "v": _page_stack(v_pages, n)}

    def _import_pages(self, entry: dict, pages: dict) -> int:
        """The shared page-import tail (loop thread, slot claimed): take
        the covered pages from the entry's reservation, scatter the page
        data into them (one ``kv_import`` call over the table-wide span,
        padded with the sentinel as JAX's ``_pad_pages`` pads it) and
        start chunked prefill at the covered offset, from where the
        request is a local prefix-cache resume.  ``pages`` is the
        normalized {"covered", "k", "v"} form; returns pages imported."""
        self._ensure_cover(entry, pages["covered"] - 1)
        n = pages["covered"] // self.kv_block_tokens
        ids = np.full((self._table_blocks,), self.kv_pool_blocks, np.int64)
        ids[:n] = entry["blocks"][:n]
        self._import_prog.run(pages["k"], pages["v"], ids)
        self._import_built = True
        entry["pos"] = pages["covered"]
        return n

    def _import_handoff(self, entry: dict) -> None:
        """Admission, decode-tier side: import the prefill tier's
        transferred pages and prefill the rest."""
        # Chaos hook: sleep = slow cross-replica transfer, raise = import
        # failure.
        faults.fire("engine.kv_handoff")
        n = self._import_pages(entry, entry["handoff"])
        with self._lock:
            self._counters["handoff_pages_in"] += n
        self._handoff_ctr.inc(n, engine=self._metric_name,
                              direction="import")

    def _import_spill(self, entry: dict) -> None:
        """Admission, host-tier side: re-import the spilled pages the plan
        matched through the same ``KvImport`` program a handoff uses, so
        re-admitting a spilled session costs one page scatter plus the
        uncovered suffix's chunks, never a full re-prefill.  A fault here
        sheds THIS admission typed 429 (the caller releases its pages;
        the host record is untouched, so no page leaks in either tier)
        instead of killing the engine."""
        payload, depth = entry.pop("spill_in")
        try:
            # Chaos hook: the spill-in import path (raise = spill-tier
            # failure mid-admission -> typed 429; sleep = slow host copy).
            faults.fire("engine.spill")
        except Exception as exc:
            raise _SpillShed(str(exc)) from exc
        t0 = time.perf_counter()
        n = self._import_pages(entry, {
            "covered": depth * self.kv_block_tokens,
            "k": _page_stack(payload["k"], depth),
            "v": _page_stack(payload["v"], depth)})
        self.spill_timing["in_s"] += time.perf_counter() - t0
        self.spill_timing["in_pages"] += n
        with self._lock:
            self._counters["spill_pages_in"] += n
            self._mgr.spills_in += n
        self._kv_spill_ctr.inc(n, engine=self._metric_name,
                               direction="in")

    def _attach_export(self, entry: dict) -> None:
        """Delivery, prefill side (loop thread, pages still held): gather
        the finished full-block prompt pages into the result, in the form
        ``kv_handoff`` imports.  It runs before release, so nothing can
        overwrite the pages mid-gather."""
        from kubeflow_tpu_torch.models.generate import gather_kv_pages

        true_len = int(entry["tokens"].shape[1])
        n = min((true_len - 1) // self.kv_block_tokens,
                len(entry["blocks"]))
        if n <= 0:
            return
        # Chaos hook: raise = export failure at delivery.
        faults.fire("engine.kv_handoff")
        pages_k, pages_v = gather_kv_pages(self._state, entry["blocks"][:n])
        entry["out"]["kv_handoff"] = {
            "block_tokens": self.kv_block_tokens,
            "tokens_covered": n * self.kv_block_tokens,
            "k": _wire_side(pages_k, n),
            "v": _wire_side(pages_v, n),
        }
        with self._lock:
            self._counters["handoff_pages_out"] += n
        self._handoff_ctr.inc(n, engine=self._metric_name,
                              direction="export")

    def _ensure_cover(self, entry: dict, upto_pos: int) -> None:
        """Grow the slot's block table to cover position ``upto_pos``,
        taking physical pages from the entry's admission reservation
        (capped there: positions past the reservation stay on the table
        sentinel and their writes go to the scratch block; only
        positions the frontier can never reach land there)."""
        target = min(upto_pos // self.kv_block_tokens + 1,
                     entry["res_blocks"])
        if target <= len(entry["blocks"]):
            return
        # Chaos hook: raise = allocation failure (engine death at the
        # growth site; _abort resolves every waiter), sleep = slow
        # allocator under pool pressure.
        faults.fire("engine.alloc_block")
        row = self._tables[entry["slot"]]
        with self._lock:
            while len(entry["blocks"]) < target:
                blk = self._mgr.take()
                row[len(entry["blocks"])] = blk
                entry["blocks"].append(blk)
                entry["res_left"] -= 1
            rec_d, blk_d = self._flush_evictions_locked()
            self._tables_dirty = True
        if rec_d:
            self._evict_ctr.inc(rec_d, engine=self._metric_name)
        if blk_d:
            self._kv_evict_ctr.inc(blk_d, engine=self._metric_name)

    def _trim_cover(self, entry: dict, next_write_pos: int) -> None:
        """Speculative rollback, pool side: pages past the one covering
        ``next_write_pos`` hold only rejected-draft k/v (already behind
        the attention mask); give them back to the pool and restore the
        entry's reservation."""
        target = max(1, next_write_pos // self.kv_block_tokens + 1)
        n = len(entry["blocks"])
        if n <= target:
            return
        row = self._tables[entry["slot"]]
        row[target:n] = self.kv_pool_blocks
        with self._lock:
            self._tables_dirty = True
            tail = entry["blocks"][target:]
            del entry["blocks"][target:]
            entry["res_left"] += len(tail)
            self._mgr.rollback(tail)

    def _flush_evictions_locked(self):
        """Fold the manager's eviction totals into the engine counters;
        returns the (records, blocks) deltas for the prom counters."""
        rec_d = self._mgr.evictions - self._evict_rec_seen
        blk_d = self._mgr.block_evictions - self._evict_blk_seen
        if rec_d:
            self._evict_rec_seen = self._mgr.evictions
            self._counters["prefix_evictions"] += rec_d
        if blk_d:
            self._evict_blk_seen = self._mgr.block_evictions
            self._counters["kv_evictions"] += blk_d
        return rec_d, blk_d

    def _set_queue_gauge(self, depth: int) -> None:
        if depth != self._queue_last:
            self._queue_last = depth
            self._queue_gauge.set(depth, engine=self._metric_name)

    def _set_occ_gauge(self, active: int) -> None:
        if active != self._occ_last:
            self._occ_last = active
            self._occ_gauge.set(active, engine=self._metric_name)

    def _set_kv_used_gauge(self, used: int) -> None:
        if used != self._kv_used_last:
            self._kv_used_last = used
            self._kv_used_gauge.set(used, engine=self._metric_name)

    def _set_kv_spilled_gauge(self, spilled: int) -> None:
        if spilled != self._kv_spilled_last:
            self._kv_spilled_last = spilled
            self._kv_spilled_gauge.set(spilled, engine=self._metric_name)

    # -- host spill tier -------------------------------------------------

    def _spill_tick(self, max_records: int = 4) -> int:
        """Evacuate LRU-cold idle records to the host tier while take()
        pressure would otherwise destroy-evict them (loop thread, between
        program calls).  Each spill is select-under-lock,
        gather-outside-the-lock (a device read never runs under the
        engine lock), complete-under-lock; ``spill()`` revalidates the
        candidate, so the off-lock window is race-free.  The gather runs
        on the stream the programs use, after every program already
        queued, and its ``.cpu()`` waits for them.  A gather fault leaves
        the record resident: destructive LRU eviction remains the
        fallback.  Returns records spilled."""
        from kubeflow_tpu_torch.models.generate import gather_kv_pages

        spilled = 0
        while spilled < max_records and self._mgr.spill_pressure() > 0:
            with self._lock:
                cands = self._mgr.spill_candidates(1)
            if not cands:
                break
            rec = cands[0]
            n = len(rec.blocks)
            with self._lock:
                # Gather-free fast path: a parked session's chain is
                # already host-resident (host_put at delivery), so its
                # device pages drop without another copy.
                freed = self._mgr.spill(rec, None)
                if freed is not None:
                    self._counters["spill_pages_out"] += n
            if freed is not None:
                self._kv_spill_ctr.inc(n, engine=self._metric_name,
                                       direction="out")
                spilled += 1
                continue
            try:
                # Chaos hook: the spill-out gather (raise = gather failure,
                # the record stays resident; sleep = slow host copy).
                faults.fire("engine.spill")
                t0 = time.perf_counter()
                pages_k, pages_v = gather_kv_pages(self._state, rec.blocks)
                self.spill_timing["out_s"] += time.perf_counter() - t0
                self.spill_timing["out_pages"] += n
            except Exception:  # noqa: BLE001 -- degrade to eviction
                log.debug("engine %r: spill-out gather failed",
                          self._metric_name, exc_info=True)
                break
            with self._lock:
                freed = self._mgr.spill(rec, {"k": pages_k, "v": pages_v})
                if freed is None:
                    continue  # went stale off-lock; reselect
                self._counters["spill_pages_out"] += n
            self._kv_spill_ctr.inc(n, engine=self._metric_name,
                                   direction="out")
            spilled += 1
        self._set_kv_spilled_gauge(self._mgr.host_used_blocks())
        return spilled

    def _shed_admitted(self, entry: dict, slot: int, why: str) -> None:
        """Shed one ALREADY-CLAIMED admission typed 429 (a spill-tier
        fault mid-admission): release its pages and reservation, free the
        slot (no chunk was dispatched, so the previous occupant's
        claim-time freeze still holds) and resolve the waiter.  The host
        tier is untouched: its record serves the next attempt."""
        with self._lock:
            if self._slot_req[slot] is entry:
                self._slot_req[slot] = None
            self._tables[slot][:] = self.kv_pool_blocks
            self._tables_dirty = True
            self._release_entry_locked(entry)
            self._counters["in_flight"] -= 1
            self._counters["shed"] += 1
            self._counters["kv_shed_no_blocks"] += 1
        self._shed_ctr.inc(batcher=self._metric_name)
        self._kv_shed_ctr.inc(engine=self._metric_name)
        entry["err"] = Overloaded(
            f"engine {self._metric_name!r} spill-tier re-import "
            f"failed mid-admission: {why}",
            retry_after_s=self.overload_retry_after_s)
        entry["event"].set()

    def _park_kv(self, entry: dict) -> None:
        """Delivery-side session park (loop thread, pages still
        slot-held): publish the FULL context (prompt + emitted; the last
        sampled token has no cache entry) as an ordinary device record
        AND copy its full-block pages into the host tier.  The next turn
        resumes through the device index while the record is warm,
        through host-tier re-import once pressure spilled it, and over
        ``fetch_kv`` from a peer after failover.  A gather fault
        degrades to device-resident-only parking."""
        from kubeflow_tpu_torch.models.generate import gather_kv_pages

        context = np.concatenate(
            [entry["tokens"][0], np.asarray(entry["emitted"], np.int32)])
        true_len = int(context.shape[0]) - 1
        n = min(true_len // self.kv_block_tokens, len(entry["blocks"]))
        salt = entry.get("adapter_salt", b"")
        with self._lock:
            self._counters["parked_sessions"] += 1
            if n > 0 and self.prefix_caching:
                self._mgr.publish(context, true_len, entry["blocks"],
                                  salt=salt)
        if n <= 0 or not self.host_spill_blocks:
            return
        try:
            # Chaos hook: the park-side gather, with the pressure spill's
            # site and degradation.
            faults.fire("engine.spill")
            t0 = time.perf_counter()
            pages_k, pages_v = gather_kv_pages(
                self._state, entry["blocks"][:n])
            self.spill_timing["out_s"] += time.perf_counter() - t0
            self.spill_timing["out_pages"] += n
        except Exception:  # noqa: BLE001 -- degrade to device-only park
            log.debug("engine %r: park gather failed", self._metric_name,
                      exc_info=True)
            return
        with self._lock:
            stored = self._mgr.host_put(
                context, true_len, {"k": pages_k, "v": pages_v}, salt=salt)
            if stored:
                self._counters["spill_pages_out"] += stored
        if stored:
            self._kv_spill_ctr.inc(stored, engine=self._metric_name,
                                   direction="out")
        self._set_kv_spilled_gauge(self._mgr.host_used_blocks())

    def _refresh_tables_dev(self) -> None:
        """Upload the host block tables to their device copy, only when
        a host edit marked them dirty.  The copy is ordered on the
        stream after every program already queued (which read the old
        tables) and before every later one."""
        with self._lock:
            if not self._tables_dirty:
                return
            self._tables_dirty = False
            tables = self._tables.astype(np.int64)
        programs.upload(self._tables_dev, tables)

    def _begin_prefill(self, entry: dict, slot: int) -> None:
        """Admission, host side.  The admission plan already aliased the
        longest cached prefix into the slot's block table, so all that
        remains is accounting and the FIRST prefill chunk, dispatched at
        claim time: its unconditional device-side ``done`` freeze is what
        makes reusing a deadline-expired slot safe."""
        prompt = entry["tokens"][0]
        true_len = int(prompt.shape[0])
        cached = entry["cached"]
        # Chaos hook: sleep = slow admission; raise = device death at
        # admission (propagates to _abort, every waiter resolved).
        faults.fire("engine.admit")
        with self._lock:
            self._counters["prompt_tokens"] += true_len
            if self.prefix_caching:
                # Hit/miss accounting only when caching is ON.
                if cached:
                    self._counters["prefix_hits"] += 1
                    self._counters["cached_tokens"] += cached
                else:
                    self._counters["prefix_misses"] += 1
        if self.prefix_caching:
            (self._hits_ctr if cached else self._misses_ctr).inc(
                engine=self._metric_name)
        if entry["trace"] is not None:
            tracing.record_span(
                "engine.admission", entry["trace"], entry["t_perf"],
                time.perf_counter(),
                attrs={"engine": self._metric_name, "slot": slot,
                       "prompt_tokens": true_len,
                       "cached_tokens": cached,
                       "prefix": "hit" if cached else "miss"})
        if entry.get("handoff"):
            # Disaggregated decode tier: import the prefill tier's pages,
            # then chunk-prefill only the uncovered suffix (>= 1 token).
            self._import_handoff(entry)
        elif entry.get("spill_in"):
            # Host-tier re-import: the same mechanics, the pages from
            # this engine's own spill tier.
            self._import_spill(entry)
        entry["prefilling"] = True
        self._prefill_chunk(entry)  # claim-time freeze + first chunk
        if entry["prefilling"]:
            self._prefilling.append(entry)

    def _prefill_chunk(self, entry: dict) -> None:
        """One static-width chunk of one entry's prompt into its slot
        (dispatch only: the final chunk's first sampled token joins the
        lagged pending stream)."""
        w = self.chunk_w
        prompt = entry["tokens"][0]
        true_len = int(prompt.shape[0])
        # The chunk's [start, start+w) window may overhang the reserved
        # pages on the final chunk (right-pad columns past the prompt):
        # those positions sit on the table sentinel and land on the
        # scratch block, beyond every frontier the slot can reach.
        start = entry["pos"]
        self._ensure_cover(entry, start + w - 1)
        self._refresh_tables_dev()
        finished = start + w >= true_len
        t0 = time.perf_counter()
        tok = self._chunk_prog.run(
            prompt[start:start + w], start, true_len, entry["new"],
            entry["slot"], entry["seed"], entry.get("adapter", 0))
        readback = _Readback(tok) if finished else None
        dt = time.perf_counter() - t0
        self._chunk_built = True
        entry["pos"] = start + w
        if finished:
            entry["prefilling"] = False
            entry["scheduled"] = 1
            self._pending.append((readback, [(0, entry)], False))
            if self.prefix_caching:
                # Publication is free: the full-block prefix pages this
                # prefill just wrote ARE the cache entry.
                with self._lock:
                    self._mgr.publish(prompt, true_len, entry["blocks"],
                                      salt=entry.get("adapter_salt", b""))
        with self._lock:
            self._counters["prefill_chunks"] += 1
            # Prefill dispatch time belongs in busy_s beside the steps'.
            self._counters["busy_s"] += dt
            self._chunk_times.append(dt)
            if len(self._chunk_times) > 4096:
                del self._chunk_times[:2048]
            if finished:
                self._counters["prefills"] += 1
        self._chunks_ctr.inc(engine=self._metric_name)
        if entry["trace"] is not None:
            tracing.record_span(
                "engine.prefill_chunk", entry["trace"], t0, t0 + dt,
                attrs={"engine": self._metric_name, "start": start,
                       "width": w,
                       **({"final": True} if finished else {})})

    def _finish(self, entry: dict) -> None:
        """Resolve a completed request: prompt + emitted tokens."""
        out = np.concatenate(
            [entry["tokens"],
             np.asarray(entry["emitted"], np.int32)[None]], axis=1)
        entry["out"] = {"tokens": out}
        if entry.get("export"):
            # Prefill-tier delivery: the finished pages ride the result.
            self._attach_export(entry)
        if entry.get("park"):
            # Session park: publish and host-copy the full context before
            # release frees its pages.
            self._park_kv(entry)
        if entry["want_timing"]:
            now = faults.monotonic()
            entry["out"]["ttft_s"] = (
                (entry["t_first"] or now) - entry["t"])
            entry["out"]["latency_s"] = now - entry["t"]
            entry["out"]["cached_tokens"] = entry["cached"]
        if entry["trace"] is not None:
            # ONE decode span per request, stamped at delivery.
            end = time.perf_counter()
            tracing.record_span(
                "engine.decode", entry["trace"],
                entry["t_first_perf"] or end, end,
                attrs={"engine": self._metric_name,
                       "tokens": len(entry["emitted"]),
                       "spec_accepted": entry["spec_acc"]})
        entry["event"].set()

    def _drain_one(self) -> None:
        """Materialize the oldest pending emission and hand its tokens
        to their requests; retire + resolve the ones that completed.

        Three emission shapes ride the one stream: a prefill's [1] first
        token, a decode call's [steps, slots] grid, and a fused round's
        slot-major [slots, k] grid with a per-slot ``counts`` vector
        (row s carries counts[s] real tokens), the shape a verify call's
        [slots, k + 1] emissions take too."""
        readback, snapshot, has_counts = self._pending.pop(0)
        arrays = readback.numpy()
        host = arrays[0]
        counts = arrays[1] if has_counts else None
        emitted = 0
        finished = 0
        finished_entries: List[dict] = []
        ttfts: List[float] = []
        for col, entry in snapshot:
            if counts is not None:       # fused round: row per slot
                toks = host[col, :int(counts[col])]
            elif host.ndim >= 2:         # decode: [steps, slots]
                toks = host[:, col]
            else:                        # prefill first token: [1]
                toks = host
            for tok in toks:
                if entry["event"].is_set() or len(entry["emitted"]) >= \
                        entry["new"]:
                    break
                tok = int(tok)
                if entry["t_first"] is None:
                    entry["t_first"] = faults.monotonic()
                    if entry["trace"] is not None:
                        entry["t_first_perf"] = time.perf_counter()
                entry["emitted"].append(tok)
                if entry["hist"] is not None:
                    entry["hist"][entry["hist_len"]] = tok
                    entry["hist_len"] += 1
                emitted += 1
                complete = len(entry["emitted"]) >= entry["new"] or (
                    self._eos and tok == self.decode.eos_token)
                if complete:
                    # The device `done` flag froze this slot at the same
                    # step, so freeing it here (possibly sync_lag calls
                    # late on the EOS path) never races the cache.
                    if self._slot_req[entry["slot"]] is entry:
                        self._slot_req[entry["slot"]] = None
                    self._finish(entry)
                    finished_entries.append(entry)
                    ttfts.append(entry["t_first"] - entry["t"])
                    finished += 1
                    break
        with self._lock:
            self._counters["tokens"] += emitted
            self._counters["requests"] += finished
            self._counters["in_flight"] -= finished
            # Delivered requests return their private KV pages to the
            # pool; published prefix pages stay resident as evictable
            # cache until LRU eviction needs them.
            for e in finished_entries:
                self._release_entry_locked(e)
            self._ttft_times.extend(ttfts)
            if len(self._ttft_times) > 4096:
                del self._ttft_times[:2048]
            # Wake streaming readers: their tokens materialized above.
            self._emit.notify_all()
        if emitted:
            self._tok_counter.inc(emitted, engine=self._metric_name)

    @staticmethod
    def _blend_rate(ema, rate):
        return rate if ema is None else (
            (1 - _SPEC_RATE_ALPHA) * ema + _SPEC_RATE_ALPHA * rate)

    def _record_step_timing(self, t0, end, norm, steps, occupancy,
                            extra=None, delivered=None, program="step",
                            round_steps=None):
        """Shared per-call accounting for every step program (decode
        step, fused round, verify): busy time, step/occupancy counters,
        the per-token latency and inter-token gap reservoirs, the step
        histogram and the throughput gate's rate EMAs.  ``norm`` is
        tokens per slot stream this call; ``extra`` merges further
        counters under the same lock; ``delivered`` (tokens the call
        delivered, after EOS and budget cuts) over the call's time feeds
        the ``program``'s rate EMA, one sample a call, each call timed
        from its dispatch to the end of its drain on the host clock;
        ``round_steps`` appends to the steps-per-round reservoir (fused
        rounds only)."""
        dt = end - t0
        per_tok = dt / norm
        gap = (end - self._last_step_end
               if self._last_step_end is not None else None)
        self._last_step_end = end
        # Pace EMA (loop-thread-owned): the fused-round deadline clamp
        # reads this as its step-latency estimate.
        self._step_pace_ema = per_tok if self._step_pace_ema is None \
            else ((1 - _ROUND_PACE_ALPHA) * self._step_pace_ema
                  + _ROUND_PACE_ALPHA * per_tok)
        with self._lock:
            self._counters["steps"] += steps
            self._counters["occupancy_sum"] += occupancy
            self._counters["busy_s"] += dt
            if extra:
                for key, value in extra.items():
                    self._counters[key] += value
            self._step_times.append(per_tok)
            if len(self._step_times) > 4096:
                del self._step_times[:2048]
            if gap is not None:
                self._gap_times.append(gap / norm)
                if len(self._gap_times) > 4096:
                    del self._gap_times[:2048]
            if round_steps is not None:
                self._round_steps.append(round_steps)
                if len(self._round_steps) > 4096:
                    del self._round_steps[:2048]
        self._step_hist.observe(per_tok, engine=self._metric_name)
        if delivered is not None and delivered > 0 and dt > 0:
            rate = delivered / dt
            if program == "verify":
                self._rate_verify_ema = self._blend_rate(
                    self._rate_verify_ema, rate)
            else:
                self._rate_step_ema = self._blend_rate(
                    self._rate_step_ema, rate)

    def _round_width(self) -> int:
        """Current fused-round step width: the adaptive value, clamped
        so ``width x pace`` stays under the tightest live deadline's
        remaining tolerance (deadline expiry granularity is the round)."""
        width = self._round_k
        pace = self._step_pace_ema
        if width > 1 and pace and pace > 0:
            now = faults.monotonic()
            tightest = None
            for r in self._slot_req:
                if r is None or r["deadline"] is None:
                    continue
                rem = r["deadline"] - now
                tightest = rem if tightest is None \
                    else min(tightest, rem)
            if tightest is not None:
                width = min(width, max(1, int(tightest / pace)))
        return max(1, min(width, self.decode_rounds))

    def _fused_round(self, live: int) -> None:
        """One fused decode round (decode_rounds > 1): a single
        ``decode_rounds`` call advances every live slot up to ``width``
        steps, and the host work for the NEXT round (cover growth, the
        table upload) runs while the device computes.  Drains at the
        round boundary: admissions and expiries join between rounds.
        Greedy tokens equal the k=1 loop's: the device math is
        ``decode_step``'s body, and slots are independent rows.  When
        the engine speculates, the drafting scan for the next boundary's
        verify runs in the overlap window too (``_draft_ahead``)."""
        kmax = self.decode_rounds
        width = self._round_width()
        snapshot = [(i, r) for i, r in enumerate(self._slot_req)
                    if r is not None and not r["prefilling"]]
        # Worst-case cover for the WHOLE round before dispatch (the
        # admission reservation guarantees the pages).
        for _, r in snapshot:
            self._ensure_cover(
                r, r["tokens"].shape[1] + r["scheduled"] + width - 1)
        self._refresh_tables_dev()
        # Chaos hook: the same site as the unfused step.
        faults.fire("engine.step")
        tok_before = self._counters["tokens"]
        t0 = time.perf_counter()
        readback = _Readback(*self._decode_prog.run(width))
        self._rounds_built = True
        # ---- overlap window: everything until the readback below runs
        # while the device computes.
        # Deterministic retirement at dispatch: with no EOS a slot whose
        # remaining budget fits this round is KNOWN to finish.
        for i, r in snapshot:
            r["scheduled"] = min(r["new"], r["scheduled"] + width)
            if not self._eos and r["scheduled"] >= r["new"]:
                self._slot_req[i] = None
        # Grow the NEXT round's covers and start their table upload now.
        for i, r in snapshot:
            if self._slot_req[i] is r:
                self._ensure_cover(
                    r, r["tokens"].shape[1] + r["scheduled"] + kmax - 1)
        self._refresh_tables_dev()
        if self.speculative_tokens:
            self._draft_ahead(snapshot, width)
        # Overlapped spill: evacuate one cold record in the window.  Its
        # gather queues behind the round and waits for it, where the
        # readback below would wait anyway.
        if self.host_spill_blocks:
            self._spill_tick(1)
        # ---- round boundary: materialize ONCE, deliver, account.
        steps = int(readback.numpy()[2])
        self._pending.append((readback, snapshot, True))
        while self._pending:
            self._drain_one()
        end = time.perf_counter()
        delivered = self._counters["tokens"] - tok_before
        dispatched = steps * len(snapshot)
        wasted = max(0, dispatched - delivered)
        # Adaptive width: shrink on early-exit waste or a waiting
        # admission, grow one step per full, waste-free round.
        if dispatched and (self._queue
                           or wasted > _ROUND_WASTE_FRAC * dispatched):
            self._round_k = max(1, self._round_k // 2)
        elif steps >= width and not wasted:
            self._round_k = min(kmax, self._round_k + 1)
        norm = max(1, steps)
        self._record_step_timing(
            t0, end, norm, steps=norm, occupancy=live * norm,
            extra={"fused_rounds": 1, "fused_steps_wasted": wasted},
            delivered=delivered, round_steps=steps)
        self._fused_rounds_ctr.inc(1, engine=self._metric_name)
        if wasted:
            self._fused_wasted_ctr.inc(wasted,
                                       engine=self._metric_name)

    def _step(self, live: int) -> None:
        """One ``decode_step`` call of ``steps_per_call`` steps, read
        back ``sync_lag`` calls later."""
        k = self.steps_per_call
        # Cover every advancing slot's next k write positions with pages
        # from its admission reservation BEFORE dispatch.
        for r in self._slot_req:
            if r is None or r["prefilling"]:
                continue
            self._ensure_cover(
                r, r["tokens"].shape[1] + r["scheduled"] + k - 1)
        self._refresh_tables_dev()
        # Chaos hook: sleep = slow/wedged step (deadlines expire
        # mid-generation); raise = device death.
        faults.fire("engine.step")
        # The tokens this call delivers (the drain below runs on this
        # thread) feed the speculation gate's decode-side rate.
        tok_before = self._counters["tokens"]
        t0 = time.perf_counter()
        readback = _Readback(self._decode_prog.run())
        self._step_built = True
        self._pending.append((readback, [
            (i, r) for i, r in enumerate(self._slot_req)
            if r is not None and not r["prefilling"]], False))
        # Deterministic retirement: with no EOS in play a request's
        # completion step is known at dispatch, so free the slot NOW
        # and let the next admission overlap the lagged read.
        for i, r in enumerate(self._slot_req):
            if r is None or r["prefilling"]:
                continue
            r["scheduled"] = min(r["new"], r["scheduled"] + k)
            if not self._eos and r["scheduled"] >= r["new"]:
                self._slot_req[i] = None
        while len(self._pending) > self.sync_lag:
            self._drain_one()
        end = time.perf_counter()
        self._record_step_timing(
            t0, end, k, steps=k, occupancy=live * k,
            delivered=(self._counters["tokens"] - tok_before
                       if self.speculative_tokens else None))

    # -- speculation -----------------------------------------------------

    def _draft_ahead(self, snapshot, width: int) -> None:
        """Overlapped drafting (fused rounds): while the round computes,
        scan each slot's dispatch-time history and keep the proposal on
        the entry, drafted ``width`` tokens deeper than the verify window
        so that it outlives the round in flight.  At the boundary,
        ``_harvest_ahead_drafts`` keeps the proposals whose heads match
        what the round delivered.  The scan-stride backoff and the
        per-slot cooldown tick here, as in ``_collect_drafts``."""
        k = self.speculative_tokens
        self._spec_tick += 1
        if self._spec_tick < self._spec_stride:
            return
        self._spec_tick = 0
        proposed = False
        for i, entry in snapshot:
            if self._slot_req[i] is not entry or entry["event"].is_set():
                continue    # retired at this round's dispatch
            if entry["spec_k"] <= 0:
                entry["spec_cool"] -= 1
                if entry["spec_cool"] <= 0:
                    entry["spec_k"] = max(1, k // 2)
                continue
            room = entry["new"] - len(entry["emitted"]) - 1
            if room <= 0:
                continue
            depth = width + min(k, entry["spec_k"], room)
            proposal = _ngram_propose(
                entry["hist"][:entry["hist_len"]], depth)
            if proposal.size:
                proposed = True
                entry["draft_ahead"] = (entry["hist_len"], proposal)
        if proposed:
            self._spec_stride = 1
        else:
            self._spec_stride = min(self._spec_stride * 2,
                                    _SPEC_SCAN_STRIDE_MAX)

    def _harvest_ahead_drafts(self):
        """The boundary side of overlapped drafting: (snapshot, draft
        [S, k], draft_len [S]) from the ahead-proposals whose heads equal
        the tokens the round delivered, clipped to the verify window at
        the new frontier; None when nothing survived (the loop then runs
        a plain fused round, which drafts again while it computes)."""
        k = self.speculative_tokens
        draft = draft_len = None
        snapshot: List[tuple] = []
        for i, entry in enumerate(self._slot_req):
            if entry is None or entry["prefilling"]:
                continue
            snapshot.append((i, entry))
            ahead = entry.pop("draft_ahead", None)
            if ahead is None:
                continue
            at_len, proposal = ahead
            grown = entry["hist_len"] - at_len
            if grown < 0 or grown >= proposal.size:
                continue
            if grown and not np.array_equal(
                    entry["hist"][at_len:entry["hist_len"]],
                    proposal[:grown]):
                continue
            room = entry["new"] - len(entry["emitted"]) - 1
            width = min(int(proposal.size) - grown, k, entry["spec_k"],
                        room)
            if width <= 0:
                continue
            if draft is None:
                draft = np.zeros((self.slots, k), np.int32)
                draft_len = np.zeros((self.slots,), np.int32)
            draft[i, :width] = proposal[grown:grown + width]
            draft_len[i] = width
        if draft is None:
            return None
        return snapshot, draft, draft_len

    def _collect_drafts(self):
        """The host's n-gram drafting pass over the live slots: (snapshot,
        draft [S, k], draft_len [S]) when at least one slot proposed,
        else None (the loop then runs the plain decode program).  The
        histories are exact: speculation forces sync_lag 0."""
        k = self.speculative_tokens
        draft = draft_len = None
        snapshot: List[tuple] = []
        for i, entry in enumerate(self._slot_req):
            if entry is None or entry["prefilling"]:
                continue
            snapshot.append((i, entry))
            if entry["spec_k"] <= 0:
                # Backed off: tick the cooldown, then re-probe at a width
                # that can clear the draft-mass floor on its own.
                entry["spec_cool"] -= 1
                if entry["spec_cool"] <= 0:
                    entry["spec_k"] = max(1, k // 2)
                continue
            # The last budgeted token is the verify call's free one.
            room = entry["new"] - len(entry["emitted"]) - 1
            width = min(k, entry["spec_k"], room)
            if width <= 0:
                continue
            proposal = _ngram_propose(
                entry["hist"][:entry["hist_len"]], width)
            if proposal.size:
                if draft is None:
                    draft = np.zeros((self.slots, k), np.int32)
                    draft_len = np.zeros((self.slots,), np.int32)
                draft[i, :proposal.size] = proposal
                draft_len[i] = proposal.size
        if draft is None:
            return None
        return snapshot, draft, draft_len

    def _spec_gates_pass(self, draft_len) -> bool:
        """Should this round's proposals dispatch verify?  Mass gate: the
        window is statically k+1 wide, so a round proposing under half a
        window cannot win.  Throughput gate: verify runs only while its
        measured delivered rate is at least ``_SPEC_RATE_MARGIN`` of the
        decode program's (EMAs over real calls); while gated, a probe
        verify every ``_SPEC_PROBE_EVERY`` rounds refreshes the
        estimate."""
        if int(draft_len.sum()) < max(1, self.speculative_tokens // 2):
            return False
        if self._rate_step_ema is not None \
                and self._rate_verify_ema is not None:
            if self._rate_verify_ema \
                    < _SPEC_RATE_MARGIN * self._rate_step_ema:
                self._spec_probe += 1
                if self._spec_probe < _SPEC_PROBE_EVERY:
                    return False
            self._spec_probe = 0
        return True

    def _verify_round(self, snapshot, draft, draft_len, live: int) -> None:
        """One speculative round: a verify call over every live slot,
        drained in this loop turn, its outcome folded into the adaptive
        widths and counters.  Rejected columns are already behind the
        attention mask (the call advanced ``lengths`` over the emitted
        prefix only); the host gives whole rejected-tail pages back to
        the pool.  Prefix publication covers full prompt pages written
        by prefill only, so a rejected draft never enters one."""
        k = self.speculative_tokens
        # Cover every slot's window [len, len + k] before dispatch;
        # positions past the reservation can only be rejected or past
        # the budget, and land on the scratch block.
        for _, entry in snapshot:
            self._ensure_cover(
                entry, entry["tokens"].shape[1] + len(entry["emitted"]) + k)
        self._refresh_tables_dev()
        faults.fire("engine.step")
        t0 = time.perf_counter()
        readback = _Readback(*self._verify_prog.run(draft, draft_len))
        self._verify_built = True
        self._pending.append((readback, snapshot, True))
        while len(self._pending) > self.sync_lag:   # sync: drains all
            self._drain_one()
        end = time.perf_counter()
        toks_np, counts_np = readback.numpy()
        drafted = int(draft_len.sum())
        accepted = 0
        for col, entry in snapshot:
            d = int(draft_len[col])
            if not d:
                continue
            lim = min(d, int(counts_np[col]))
            a = 0
            while a < lim and toks_np[col, a] == draft[col, a]:
                a += 1
            accepted += a
            entry["spec_acc"] += a
            # Additive increase on a full accept, decrease on a full
            # reject; at zero the slot stops drafting until the cooldown
            # re-probe.
            if a == d:
                entry["spec_k"] = min(k, entry["spec_k"] + 1)
            elif a == 0:
                entry["spec_k"] -= 1
                if entry["spec_k"] <= 0:
                    entry["spec_k"] = 0
                    entry["spec_cool"] = _SPEC_COOLDOWN
        # ``scheduled`` follows the delivered count: the plain rounds
        # that follow size their page cover from it.
        for _, entry in snapshot:
            entry["scheduled"] = max(entry["scheduled"],
                                     len(entry["emitted"]))
            if not entry["released"]:
                self._trim_cover(
                    entry, entry["tokens"].shape[1] + len(entry["emitted"]))
        total = int(counts_np.sum())
        advancing = int(np.count_nonzero(counts_np))
        # Per-token latency: normalized by the mean emissions of the
        # slots that advanced, the client-visible stream pace.
        norm = max(1.0, total / advancing) if advancing else 1.0
        self._record_step_timing(
            t0, end, norm, steps=1, occupancy=live,
            extra={"spec_steps": 1, "spec_drafted": drafted,
                   "spec_accepted": accepted},
            delivered=total, program="verify")
        if drafted:
            self._spec_drafted_ctr.inc(drafted, engine=self._metric_name)
        if accepted:
            self._spec_accepted_ctr.inc(accepted, engine=self._metric_name)

    def _speculate(self, live: int, admissions) -> bool:
        """The loop's speculation branch; True when a verify round ran in
        place of this turn's decode step or round.  Fused mode harvests
        the proposals drafted in the previous round's overlap window;
        the per-step mode drafts here, and a truly empty scan stretches
        the scan stride.  A draftable admission resets the stride and
        lets the first drafted round probe past the throughput gate."""
        seeded = any(e.get("spec_seed") for e, _ in admissions)
        if self.decode_rounds > 1:
            if seeded:
                self._spec_stride = 1
                self._spec_tick = self._spec_stride
                self._spec_probe = _SPEC_PROBE_EVERY
            drafts = self._harvest_ahead_drafts()
        else:
            self._spec_tick += 1
            if seeded:
                self._spec_stride = 1
                self._spec_tick = self._spec_stride
                self._spec_probe = _SPEC_PROBE_EVERY
            if self._spec_tick < self._spec_stride:
                return False
            self._spec_tick = 0
            drafts = self._collect_drafts()
            if drafts is None:
                self._spec_stride = min(self._spec_stride * 2,
                                        _SPEC_SCAN_STRIDE_MAX)
                return False
            self._spec_stride = 1
        if drafts is None or not self._spec_gates_pass(drafts[2]):
            return False
        self._verify_round(*drafts, live)
        return True

    def _run(self) -> None:
        # inference_mode is per thread: the programs run on this one.
        device_ctx = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with torch.inference_mode(), device_ctx:
                try:
                    self._capture()
                except BaseException as exc:
                    self._capture_error = exc
                    raise
                finally:
                    self._ready.set()
                while self._loop_once():
                    pass
        except BaseException as exc:  # noqa: BLE001 -- fail loudly to waiters
            self._abort(exc)

    def _capture(self) -> None:
        """Capture the engine's programs as CUDA graphs in one shared
        memory pool, on the fresh state, before the first admission (the
        constructor waits for this).  Its time falls outside every timed
        window, as the JAX engine compiles outside them."""
        if not self.cuda_graphs:
            return
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        progs = self._programs()
        for prog in progs:
            prog.capture(pool)
        torch.cuda.synchronize(self.device)
        self.capture_info = {
            "seconds": time.perf_counter() - t0,
            "programs": [type(p).__name__ for p in progs],
            # The graphs' private pool: its segments stay reserved for
            # the graphs' life, so their size is the pool's peak.
            "pool_bytes": sum(
                seg["total_size"]
                for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == tuple(pool)),
        }
        log.info("engine %r captured %s as CUDA graphs in %.3f s "
                 "(graph pool %d bytes)", self._metric_name,
                 self.capture_info["programs"],
                 self.capture_info["seconds"],
                 self.capture_info["pool_bytes"])

    def _programs(self) -> List[programs._Program]:
        """The engine's programs, in capture order."""
        return [prog for prog in (self._chunk_prog, self._decode_prog,
                                  self._verify_prog, self._import_prog)
                if prog is not None]

    def _loop_once(self) -> bool:
        """One turn of the loop: sweep, admit, prefill under the chunk
        budget, then one step or fused round.  False ends the loop."""
        with self._lock:
            while (not self._queue
                   and all(r is None for r in self._slot_req)
                   and not self._pending and not self._stopped):
                self._work.wait()
            if self._stopped and not self._queue \
                    and all(r is None for r in self._slot_req) \
                    and not self._pending:
                return False
            stopping = self._stopped
            past_drain = (stopping and self._drain_deadline is not None
                          and faults.monotonic() > self._drain_deadline)
            expired = self._sweep_expired_locked()
            admissions = []
            if not stopping:
                free = self._free_slots_locked()
                while (free and self._queue
                       and len(self._prefilling) + len(admissions)
                       < self.admit_width):
                    pick = self._fair_pick_locked()
                    entry = self._queue[pick]
                    plan = self._plan_blocks_locked(entry)
                    if plan is None:
                        # Tokens-resident admission bound: the pool
                        # cannot reserve this request's worst case yet.
                        # It HOLDS its queue position until retirements
                        # free pages.
                        break
                    self._queue.pop(pick)
                    self._fair_seq += 1
                    self._fair_last[entry.get("adapter_name") or ""] = \
                        self._fair_seq
                    slot = free.pop(0)
                    shared, cached = plan
                    # Claim the slot and bump in_flight in the same locked
                    # section that pops the queue: stats() must never see
                    # queue_depth == 0 AND in_flight_requests == 0 while a
                    # request is live.
                    entry["slot"] = slot
                    entry["cached"] = cached
                    entry["pos"] = cached
                    entry["blocks"] = list(shared)
                    entry["res_left"] = \
                        entry["res_blocks"] - len(shared)
                    # Zero-copy prefix resume: the cached blocks slide
                    # into the table's leading entries; prefill starts at
                    # the cached offset.
                    row = self._tables[slot]
                    row[:] = self.kv_pool_blocks
                    row[:len(shared)] = shared
                    self._tables_dirty = True
                    self._slot_req[slot] = entry
                    self._counters["in_flight"] += 1
                    admissions.append((entry, slot))
                self._set_queue_gauge(len(self._queue))
        self._fail_expired(expired)
        if expired and self._prefilling:
            # Mid-prefill expiries leave the chunk schedule (the sweep
            # already released their pages and parked their table rows).
            self._prefilling = [
                p for p in self._prefilling
                if not any(p is e for e in expired)]
        if past_drain:
            self._abort(RuntimeError(
                f"engine {self._metric_name!r} drain deadline "
                "exceeded at close"))
            return False
        if stopping:
            # Refuse queued work immediately; keep stepping only to drain
            # in-flight slots.
            self._fail_queue(BatcherClosed(
                f"engine {self._metric_name!r} is closed"))
        if self._registry is not None:
            # Hot adapter load/evict: fold a pending stack version into
            # the device stack before this turn's program calls.
            self._apply_adapter_updates()
        if self.host_spill_blocks:
            # Spill-then-admit: evacuate LRU-cold idle records to the host
            # tier BEFORE this turn's take() calls (admission prefills,
            # the chunk budget, decode covers) can destroy-evict them.
            self._spill_tick()
        for entry, slot in admissions:
            try:
                self._begin_prefill(entry, slot)
            except _SpillShed as exc:
                self._shed_admitted(entry, slot, str(exc))
        # Chunked prefill BETWEEN decode steps, under the per-step token
        # budget: the head admission (FIFO) gets chunks until the budget
        # is spent, then the loop returns to decoding.
        budget = self.prefill_chunk_tokens
        while budget > 0 and self._prefilling:
            entry = self._prefilling[0]
            self._prefill_chunk(entry)
            budget -= self.chunk_w
            if not entry["prefilling"]:
                self._prefilling.pop(0)
        self._set_occ_gauge(sum(r is not None for r in self._slot_req))
        live = sum(1 for r in self._slot_req
                   if r is not None and not r["prefilling"])
        if live and self.speculative_tokens \
                and self._speculate(live, admissions):
            pass    # a verify round took this turn's decode
        elif live and self.decode_rounds > 1:
            self._fused_round(live)
        elif live:
            self._step(live)
        else:
            self._last_step_end = None
            if not self._prefilling:
                while self._pending:
                    self._drain_one()
        self._set_occ_gauge(sum(r is not None for r in self._slot_req))
        # Pages resident (the loop thread is the pool's only mutator).
        self._set_kv_used_gauge(self._mgr.used_blocks())
        if self.host_spill_blocks:
            self._set_kv_spilled_gauge(self._mgr.host_used_blocks())
        return True

    def _fail_queue(self, exc: Exception) -> None:
        with self._lock:
            queued, self._queue = self._queue, []
            self._set_queue_gauge(0)
        for entry in queued:
            self._unpin_adapter(entry)
            entry["err"] = exc
            entry["event"].set()

    def _abort(self, exc: BaseException) -> None:
        """Engine death: every waiter gets the error, nobody hangs."""
        with self._lock:
            self._stopped = True
            self._counters["in_flight"] = 0
        err = exc if isinstance(exc, Exception) else \
            RuntimeError(f"engine loop died: {exc!r}")
        self._fail_queue(err)
        # Fail live slots AND requests whose slots were already
        # deterministically retired but whose lagged emissions still sit
        # in _pending: those are in neither the queue nor the slot table.
        for i, entry in enumerate(self._slot_req):
            if entry is not None and not entry["event"].is_set():
                self._unpin_adapter(entry)
                entry["err"] = err
                entry["event"].set()
            self._slot_req[i] = None
        for _, snapshot, _ in self._pending:
            for _, entry in snapshot:
                if not entry["event"].is_set():
                    self._unpin_adapter(entry)
                    entry["err"] = err
                    entry["event"].set()
        self._pending.clear()
        self._prefilling.clear()
        self._set_occ_gauge(0)

