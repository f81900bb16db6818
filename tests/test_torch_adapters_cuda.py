"""Adapter-array serving in the engine's captured programs, on an NVIDIA
GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_adapters_cuda.py

Elsewhere every test skips (CUDA graphs have no CPU mode).  A small
float32 model with TF32 off and a stacked adapter array of three tenant
rows at rank 4 beside the base row.  Each program (chunked prefill, step,
rounds, verify), captured with the stack as a fixed buffer, replays equal
to the same program run eagerly on a twin state with slots of mixed
adapter rows: integer state and tokens equal, pool and logits within
1e-6.  A new revision of an adapter copied INTO the stack after capture
changes the replayed tokens to the new revision's (those of an eager run
with the new factors), which is how the engine's hot load reaches its
graphs.  An engine with graphs and an adapter registry gives, per request
of a mixed burst, the tokens of the same engine run eagerly, captures the
programs a base-only engine captures, and serves a reloaded adapter's new
tokens from the graphs it captured at construction.
"""

import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving import programs
from kubeflow_tpu_torch.serving.adapters import (
    AdapterRegistry,
    random_adapter_factors,
)
from kubeflow_tpu_torch.serving.engine import DecodeEngine

VOCAB = 512
SMALL = dict(vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, head_dim=16, max_seq_len=128)
SLOTS, NB, BT, MB, W, K, RANK = 3, 24, 4, 8, 8, 8, 4
TOL = dict(atol=1e-6, rtol=1e-6)
INTS = ("lengths", "stop_len", "last_token", "done", "keys", "adapter_ids")
WAIT_S = 120


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture
def model(cuda_device):
    cfg = TransformerConfig(dtype=torch.float32, attention="dot", **SMALL)
    return Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(9)
                       ).to(cuda_device)


def _registry(cfg, seeds=(101, 102, 103), **kw):
    kw.setdefault("slots", 4)
    reg = AdapterRegistry(cfg, rank=RANK, **kw)
    for i, seed in enumerate(seeds):
        reg.put(f"t{i + 1}", random_adapter_factors(cfg, RANK, seed,
                                                    scale=0.3))
    return reg


def _device_stack(reg):
    stack, _ = reg.stack_snapshot()
    return {grp: {k: torch.from_numpy(np.array(a)).cuda()
                  for k, a in leaves.items()}
            for grp, leaves in stack.items()}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n)


def _fresh_pairs(model):
    return [(pgen.init_paged_state(model.cfg, SLOTS, NB, BT, device="cuda"),
             torch.full((SLOTS, MB), NB, dtype=torch.int64, device="cuda"))
            for _ in range(2)]


def _cover(pairs, slot, blocks):
    for _, tables in pairs:
        tables[slot] = NB
        tables[slot, :len(blocks)] = torch.tensor(blocks)


def _logits(model, state, tables, stack):
    scratch = pgen.init_paged_state(model.cfg, SLOTS, NB, BT, device="cuda")
    for name in ("cache_k", "cache_v"):
        scratch[name].copy_(state[name])
    with torch.inference_mode():
        return pgen._forward_with_cache(
            model, state["last_token"].long()[:, None],
            (scratch["cache_k"], scratch["cache_v"]), state["lengths"],
            tables=tables, adapter_ids=state["adapter_ids"],
            adapters=stack)


def _check(model, pairs, stack):
    (got, got_tables), (want, want_tables) = pairs
    torch.cuda.synchronize()
    for name in INTS:
        assert torch.equal(got[name], want[name]), name
    for name in ("cache_k", "cache_v"):
        torch.testing.assert_close(got[name], want[name], **TOL)
    torch.testing.assert_close(_logits(model, got, got_tables, stack),
                               _logits(model, want, want_tables, stack),
                               **TOL)


class Twin:
    """One program per (state, tables) pair over one adapter stack, fed
    the same calls: the first captured, the second eager."""

    def __init__(self, model, pairs, stack, make, graphs=True):
        self.model = model
        self.pairs = pairs
        self.stack = stack
        self.progs = [make(state, tables, g, stack) for (state, tables), g
                      in zip(pairs, (graphs, False))]

    def capture(self):
        with torch.inference_mode():
            self.progs[0].capture(torch.cuda.graph_pool_handle())
        assert self.progs[0].graph is not None
        _check(self.model, self.pairs, self.stack)

    def call(self, *args):
        outs = []
        with torch.inference_mode():
            for prog in self.progs:
                out = prog.run(*args)
                out = out if isinstance(out, tuple) else (out,)
                outs.append([t.clone() for t in out])
        for got, want in zip(*outs):
            assert torch.equal(got, want)
        _check(self.model, self.pairs, self.stack)
        return outs[0]

    def prefill(self, slot, n, new, seed, adapter):
        prompt = _prompt(n, seed)
        for start in range(0, n, W):
            self.call(prompt[start:start + W], start, n, new, slot, seed,
                      adapter)


def _chunk(model, decode):
    return lambda state, tables, graphs, stack: programs.ChunkedPrefill(
        model, decode, state, tables, W, graphs, adapters=stack)


def _admit_three(model, decode, pairs, stack, rows=(1, 0, 3)):
    """Slots 0-2 live under adapter rows ``rows``, prefilled by eager
    programs on both sides."""
    chunk = Twin(model, pairs, stack, _chunk(model, decode), graphs=False)
    for slot, (n, row) in enumerate(zip((9, 5, 11), rows)):
        _cover(pairs, slot, list(range(slot * MB, slot * MB + 6)))
        chunk.prefill(slot, n, 16, slot + 2, row)


@pytest.mark.cuda
def test_prefill_replays_mixed_adapter_rows(cuda_device, model):
    decode = pgen.DecodeConfig(max_new_tokens=8)
    stack = _device_stack(_registry(model.cfg))
    twin = Twin(model, _fresh_pairs(model), stack, _chunk(model, decode))
    twin.capture()
    state = twin.pairs[0][0]
    for slot, row in ((0, 2), (1, 0), (2, 3)):
        _cover(twin.pairs, slot, list(range(slot * MB, slot * MB + 5)))
        twin.prefill(slot, 13 - 3 * slot, 6, 20 + slot, row)
    assert state["adapter_ids"].tolist() == [2, 0, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["step", "rounds", "verify"])
def test_decode_programs_replay_mixed_adapter_rows(cuda_device, model,
                                                   program):
    decode = pgen.DecodeConfig(max_new_tokens=16)
    stack = _device_stack(_registry(model.cfg))
    make = {
        "step": lambda state, tables, graphs, stack: programs.Step(
            model, decode, state, tables, 2, graphs, adapters=stack),
        "rounds": lambda state, tables, graphs, stack: programs.Rounds(
            model, decode, state, tables, K, graphs, adapters=stack),
        "verify": lambda state, tables, graphs, stack: programs.Verify(
            model, decode, state, tables, 4, graphs, adapters=stack),
    }[program]
    pairs = _fresh_pairs(model)
    twin = Twin(model, pairs, stack, make)
    twin.capture()                      # every slot done
    _admit_three(model, decode, pairs, stack)
    rng = np.random.default_rng(5)
    for width in (1, 3, 8):
        if program == "rounds":
            twin.call(width)
        elif program == "step":
            twin.call()
        else:
            draft = rng.integers(1, VOCAB, (SLOTS, 4)).astype(np.int32)
            twin.call(draft, np.asarray([4, 2, 0], np.int32))


def _round_tokens(model, decode, stack, graphs, update=None):
    """Slots 0-2 prefilled under rows (1, 0, 3), then one round of K
    steps through a Rounds program over ``stack`` (captured when
    ``graphs``, before ``update`` copies new factors into the stack)."""
    state = pgen.init_paged_state(model.cfg, SLOTS, NB, BT, device="cuda")
    tables = torch.full((SLOTS, MB), NB, dtype=torch.int64, device="cuda")
    rounds = programs.Rounds(model, decode, state, tables, K, graphs,
                             adapters=stack)
    chunk = programs.ChunkedPrefill(model, decode, state, tables, W, False,
                                    adapters=stack)
    with torch.inference_mode():
        if graphs:
            rounds.capture(torch.cuda.graph_pool_handle())
        if update is not None:
            update(stack)
        for slot, (n, row) in enumerate(zip((9, 5, 11), (1, 0, 3))):
            tables[slot, :6] = torch.arange(slot * MB, slot * MB + 6)
            prompt = _prompt(n, slot + 2)
            for start in range(0, n, W):
                chunk.run(prompt[start:start + W], start, n, 16, slot,
                          slot + 2, row)
        toks, counts, _ = rounds.run(K)
        torch.cuda.synchronize()
        out = toks.clone(), counts.clone()
    rounds.release()
    return out


@pytest.mark.cuda
def test_in_place_update_after_capture_reaches_the_graph(cuda_device,
                                                         model):
    """Rows 1 and 3 get a new revision copied into the stack's own
    storage after the round was captured: the replay decodes the new
    revision's tokens (an eager round over a stack that held them from
    the start), not the old ones, and the base row's tokens stay."""
    decode = pgen.DecodeConfig(max_new_tokens=16)
    old = _registry(model.cfg)
    new = _registry(model.cfg, seeds=(201, 102, 203))
    new_stack = _device_stack(new)

    def update(stack):
        for grp, leaves in stack.items():
            for k, t in leaves.items():
                t.copy_(new_stack[grp][k])

    before, _ = _round_tokens(model, decode, _device_stack(old), True)
    after, counts = _round_tokens(model, decode, _device_stack(old), True,
                                  update)
    want, want_counts = _round_tokens(model, decode, _device_stack(new),
                                      False)
    assert torch.equal(after, want) and torch.equal(counts, want_counts)
    assert torch.equal(after[1], before[1])       # the base row
    assert not torch.equal(after[0], before[0])
    assert not torch.equal(after[2], before[2])


def _burst(engine, work):
    outs = [None] * len(work)

    def call(i):
        adapter, prompt = work[i]
        req = {"tokens": prompt, "max_new_tokens": 12}
        if adapter:
            req["adapter"] = adapter
        outs[i] = np.asarray(engine.submit(req)["tokens"])[0].tolist()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert None not in outs, "a request did not complete"
    return outs


@pytest.mark.cuda
def test_engine_graphs_with_adapters_equal_eager(cuda_device, model):
    """A mixed burst through the captured engine equals the same engine
    run eagerly, with the programs of a base-only engine; after a hot
    reload of t1 the captured engine serves t1's new tokens."""
    decode = pgen.DecodeConfig(max_new_tokens=12)
    work = [(a, _prompt(n, 30 + i)) for i, (a, n) in enumerate(
        [(None, 9), ("t1", 14), ("t2", 5), ("t3", 20), ("t1", 7),
         (None, 16)])]
    geometry = dict(slots=4, prefill_len=32, prefill_chunk_tokens=8,
                    kv_block_tokens=4, decode_rounds=4)
    outs = {}
    for graphs in (True, False):
        reg = _registry(model.cfg)
        engine = DecodeEngine(model, decode, adapters=reg,
                              cuda_graphs=graphs, name=f"ad-g{graphs}",
                              **geometry)
        try:
            assert (engine.capture_info is not None) == graphs
            first = _burst(engine, work)
            reg.put("t1", random_adapter_factors(model.cfg, RANK, 301,
                                                 scale=0.3))
            second = _burst(engine, work[1:2])
            outs[graphs] = (first, second, engine.compiled_programs(),
                            [type(p).__name__ for p in engine._programs()])
        finally:
            engine.close()
    base = DecodeEngine(model, decode, name="ad-base", **geometry)
    try:
        _burst(base, [w for w in work if w[0] is None])
        base_programs = (base.compiled_programs(),
                         [type(p).__name__ for p in base._programs()])
    finally:
        base.close()
    assert outs[True][:2] == outs[False][:2]
    assert outs[True][1] != [outs[True][0][1]]
    assert tuple(outs[True][2:]) == base_programs
