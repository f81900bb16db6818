"""The decode engine's compiled programs: the counterpart of the JAX
engine's ``lower().compile()`` sites (kubeflow_tpu/serving/engine.py).

JAX builds each slot program once per engine as one executable whose
per-call scalars are traced operands.  Here each program is one object
over fixed buffers, built once per engine:

  - ``ChunkedPrefill``: ``prefill_chunk_into_slot`` for one static-width
    chunk; its tokens and its scalars (start, prompt_len, new_tokens,
    slot, seed, adapter id) are one int64 device buffer, and the slot's
    block-table row is picked on the device by the slot scalar;
  - ``Step``: ``decode_step``, the engine's ``steps_per_call`` unrolled;
  - ``Rounds``: one guarded step of ``decode_rounds`` that writes its
    tokens at a device step index; the host issues it up to the round's
    width and stops on the lagged all-done read, so one program serves
    every adaptive width;
  - ``Verify``: ``verify_step`` at the engine's static draft width k;
    the drafts and their lengths are one int32 device buffer;
  - ``KvImport``: ``import_kv_pages`` over a page span padded to the
    block tables' width, as JAX's ``_pad_pages`` pads it; the padding's
    ids are the pool-size sentinel, so its pages land on the scratch
    block.  It serves the disaggregated handoff and the host spill
    tier's re-import alike.

An int8 state's pool sides are ``QTensor``s (ops/quantize.py): int8
values and float32 scales, four tensors in all, each a fixed buffer the
graphs read and write as they do the model-dtype pool's two, each with
its scratch block.  ``KvImport`` then holds int8 and float32 page
buffers.

An engine that serves adapters passes its stacked adapter factors
(``adapters``, ``[rows, layers, ...]`` tensors in the model dtype) to
every program, which reads them as fixed buffers, as the int8 pool's
scales are read: the engine copies a new registry version into their
storage between calls and never rebinds them, so the captured graphs
read the new rows.  The number of programs does not change.

Under a tensor mesh (serving/sharding.py) each rank's programs run over
its slice of the model and its kv heads of the pool, eagerly: the
collectives inside the bodies are staged through the host over gloo on
one GPU, which a CUDA graph cannot hold, and ``capture()`` refuses.
The engine issues a round's steps one lockstep call at a time
(``Rounds.begin``, ``issue``, ``end``), so every rank runs as many.

Every program writes the engine's state in place, so the state's
tensors, the block tables and the buffers keep their storage for the
engine's life.  On CUDA, ``capture()`` records each body as a CUDA graph
(one memory pool shared by the engine's graphs) and a call is an upload
into the buffers and one ``replay()``.  On the CPU the same objects run
the same bodies eagerly on the same buffers.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.models import generate
from kubeflow_tpu_torch.ops.quantize import QTensor

# Warm-up runs of a body before its capture: the first run of each op
# on a fresh stream initialises what a capture cannot (cuBLAS handles
# and workspaces, lazily loaded kernels).
_WARMUP_RUNS = 2


def upload(dst: torch.Tensor, array: np.ndarray) -> None:
    """Copy a host array into the device buffer ``dst`` without blocking:
    the source is a fresh pinned tensor, which the caching host allocator
    keeps until the copy has run, so no staging buffer is overwritten
    while its copy may still be queued."""
    host = torch.from_numpy(array)
    if dst.device.type == "cuda":
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)


class _Program:
    """One slot program: a subclass's ``_body()`` over fixed buffers, run
    eagerly or captured once and replayed."""

    def __init__(self, model, decode, state: Dict[str, torch.Tensor],
                 tables: torch.Tensor, graphs: bool,
                 adapters: Optional[generate.Adapters] = None):
        self.model = model
        self.decode = decode
        self.state = state
        self.tables = tables
        self.adapters = adapters
        self.device = state["done"].device
        if graphs and self.device.type != "cuda":
            raise ValueError(
                f"CUDA graphs need a CUDA device; the state is on "
                f"{self.device}")
        self.graphs = graphs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None

    def capture(self, pool) -> None:
        """Record the body as a CUDA graph in the memory pool ``pool``.
        A model split over a tensor group refuses: its collectives are
        staged through the host over gloo on one GPU, and no machine
        with one GPU a rank has tested NCCL collectives inside a graph
        (ROADMAP queue 1 item 25).

        The warm-up runs execute the body for real, on a side stream, so
        the slot scalars are snapshot before them and restored after;
        on a fresh engine state every slot is done and every table entry
        is the sentinel, so their pool writes land on the scratch block.
        A capture that fails raises."""
        if getattr(self.model, "mesh", None) is not None:
            raise NotPortedError(
                "CUDA graph capture of a program under a tensor mesh is "
                "not ported yet (ROADMAP queue 1 item 25)")
        saved = {name: value.clone() for name, value in self.state.items()
                 if name not in ("cache_k", "cache_v")}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_RUNS):
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for name, value in saved.items():
            self.state[name].copy_(value)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = self._body()
        self.graph, self.out = graph, out

    def release(self) -> None:
        """Free the graph and its outputs (their pool memory with them)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.out = None

    def _launch(self):
        if self.graph is not None:
            self.graph.replay()
            return self.out
        if self.graphs:
            raise RuntimeError(
                f"{type(self).__name__} runs as a CUDA graph and has not "
                "been captured")
        return self._body()


class ChunkedPrefill(_Program):
    """``prefill_chunk_into_slot`` over one ``[w + 6]`` int64 input
    buffer: the chunk's tokens, then (start, prompt_len, new_tokens,
    slot, seed, adapter id)."""

    def __init__(self, model, decode, state, tables, chunk_w: int,
                 graphs: bool, adapters=None):
        super().__init__(model, decode, state, tables, graphs, adapters)
        self.chunk_w = chunk_w
        self.inputs = torch.zeros((chunk_w + 6,), dtype=torch.int64,
                                  device=self.device)
        self.tokens = self.inputs[:chunk_w].view(1, chunk_w)
        self.scalars = self.inputs[chunk_w:]

    def _body(self) -> torch.Tensor:
        start, prompt_len, new_tokens, slot, seed, adapter = \
            self.scalars.unbind()
        row = self.tables.index_select(0, self.scalars[3:4])
        _, tok = generate.prefill_chunk_into_slot(
            self.model, self.state, self.decode, self.tokens, start,
            prompt_len, new_tokens, slot, seed, row, adapter,
            in_place=True, adapters=self.adapters)
        return tok

    def run(self, segment: np.ndarray, start: int, prompt_len: int,
            new_tokens: int, slot: int, seed: int,
            adapter: int = 0) -> torch.Tensor:
        """Prefill ``segment`` (the prompt's tokens [start, start + w),
        at most w of them; right-padded with 0) into ``slot`` under
        adapter row ``adapter`` (0: base); returns the first sampled
        token [1], an output buffer the next call overwrites."""
        host = np.zeros((self.chunk_w + 6,), np.int64)
        host[:len(segment)] = segment
        host[self.chunk_w:] = (start, prompt_len, new_tokens, slot, seed,
                               adapter)
        upload(self.inputs, host)
        return self._launch()


class Step(_Program):
    """``decode_step`` with the engine's static ``steps`` unrolled."""

    def __init__(self, model, decode, state, tables, steps: int,
                 graphs: bool, adapters=None):
        super().__init__(model, decode, state, tables, graphs, adapters)
        self.steps = steps

    def _body(self) -> torch.Tensor:
        _, sampled = generate.decode_step(
            self.model, self.state, self.decode, self.steps, self.tables,
            in_place=True, adapters=self.adapters)
        return sampled

    def run(self) -> torch.Tensor:
        """One call; returns the sampled tokens [steps, S], an output
        buffer the next call overwrites."""
        return self._launch()


class Rounds(_Program):
    """``decode_rounds`` of width up to ``k``: the program is one guarded
    step (``decode_round_step``), issued by the host."""

    def __init__(self, model, decode, state, tables, k: int, graphs: bool,
                 adapters=None):
        super().__init__(model, decode, state, tables, graphs, adapters)
        self.k = k
        slots = state["done"].shape[0]
        self.park = tables.shape[1] * generate._pool_block_tokens(
            state["cache_k"])
        self.toks = torch.zeros((slots, k), dtype=torch.int32,
                                device=self.device)
        self.counts = torch.zeros_like(state["lengths"])
        self.steps_run = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)
        self.len0 = torch.zeros_like(state["lengths"])

    def _body(self) -> torch.Tensor:
        return generate.decode_round_step(
            self.model, self.decode, self.tables, self.park, self.state,
            self.toks, self.step, self.steps_run, self.adapters)

    def begin(self) -> None:
        """Reset the round's buffers before its first step."""
        self.toks.zero_()
        self.steps_run.zero_()
        self.step.zero_()
        self.len0.copy_(self.state["lengths"])

    def issue(self) -> torch.Tensor:
        """One guarded step; returns the 0-d all-done flag after it."""
        return self._launch()

    def end(self):
        """The round's buffers (toks [S, k], counts [S], steps_run),
        which the next round overwrites."""
        torch.sub(self.state["lengths"], self.len0, out=self.counts)
        return self.toks, self.counts, self.steps_run

    def run(self, max_steps: int):
        """One round of up to ``min(max_steps, k)`` steps (``begin``,
        the host-issued steps, ``end``); returns ``end()``'s buffers."""
        self.begin()
        generate.run_round(self.issue, self.k, max_steps, self.device)
        return self.end()


class Verify(_Program):
    """``verify_step`` at the static draft width ``k`` over one
    ``[S, k + 1]`` int32 input buffer: each row's k draft tokens, then
    its draft length."""

    def __init__(self, model, decode, state, tables, k: int, graphs: bool,
                 adapters=None):
        super().__init__(model, decode, state, tables, graphs, adapters)
        self.k = k
        slots = state["done"].shape[0]
        self.inputs = torch.zeros((slots, k + 1), dtype=torch.int32,
                                  device=self.device)

    def _body(self):
        _, tokens, emit = generate.verify_step(
            self.model, self.state, self.decode, self.k,
            self.inputs[:, :self.k], self.inputs[:, self.k], self.tables,
            in_place=True, adapters=self.adapters)
        return tokens, emit

    def run(self, draft: np.ndarray, draft_len: np.ndarray):
        """One verify call on ``draft`` [S, k] and ``draft_len`` [S];
        returns (tokens [S, k + 1], emit [S]), output buffers the next
        call overwrites."""
        host = np.empty(tuple(self.inputs.shape), np.int32)
        host[:, :self.k] = draft
        host[:, self.k] = draft_len
        upload(self.inputs, host)
        return self._launch()


def _page_buffer(cache, span: int):
    """Zeroed page buffer of ``span`` pages shaped like the pool ``cache``
    ([L, nb, bt, ...] -> [L, span, bt, ...]), a QTensor of two for an
    int8 pool."""
    if isinstance(cache, QTensor):
        return QTensor(_page_buffer(cache.values, span),
                       _page_buffer(cache.scale, span), cache.axes)
    shape = (cache.shape[0], span) + tuple(cache.shape[2:])
    return torch.zeros(shape, dtype=cache.dtype, device=cache.device)


def _fill_pages(buf: torch.Tensor, pages: torch.Tensor) -> None:
    """Copy host pages [L, n, ...] into the first n pages of ``buf``, cast
    to its dtype (pinned first on CUDA, so the copy does not block)."""
    pages = pages.to(buf.dtype)
    if buf.device.type == "cuda":
        pages = pages.pin_memory()
    buf[:, :pages.shape[1]].copy_(pages, non_blocking=True)


class KvImport(_Program):
    """``import_kv_pages`` over fixed page buffers of ``span`` pages a
    side (values and scales for an int8 pool) and their int64 block ids.
    The ids start at the pool-size sentinel, so a capture's warm-up runs
    scatter onto the scratch block, scales included, whatever the pool
    holds."""

    def __init__(self, model, decode, state, tables, span: int,
                 graphs: bool):
        super().__init__(model, decode, state, tables, graphs)
        cache = state["cache_k"]
        self.pages_k = _page_buffer(cache, span)
        self.pages_v = _page_buffer(cache, span)
        self.ids = torch.full((span,), cache.shape[1], dtype=torch.int64,
                              device=self.device)

    def _body(self):
        generate.import_kv_pages(self.state, self.pages_k, self.pages_v,
                                 self.ids)

    def run(self, pages_k, pages_v, ids: np.ndarray) -> None:
        """Scatter ``n`` pages a side (host tensors [L, n, bt, hkv, d],
        cast to the pool's dtype; QTensors of values and scales for an
        int8 pool) into blocks ``ids`` ([span], the pages' n ids, then the
        sentinel).  Pages past ``n`` in the buffers are left as they
        were: their ids send them to the scratch block."""
        for buf, pages in ((self.pages_k, pages_k), (self.pages_v, pages_v)):
            if isinstance(buf, QTensor):
                _fill_pages(buf.values, pages.values)
                _fill_pages(buf.scale, pages.scale)
            else:
                _fill_pages(buf, pages)
        upload(self.ids, np.asarray(ids, np.int64))
        self._launch()
