"""The decode engine's programs captured as CUDA graphs, on an NVIDIA GPU.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m cuda --noconftest tests/test_torch_engine_graphs_cuda.py

Elsewhere every test skips.  A small float32 model with TF32 off.  Each
program is captured on a fresh state with one set of scalars, then
replayed with three others (other slots, starts, seeds and prompt
lengths; final and non-final chunks; round widths 1, 3 and 8; EOS inside
a round; verify windows fully accepted, rejected, clipped and undrafted;
page imports of other spans and ids); each replay must equal the same
program run eagerly on a twin state: integer state and tokens equal,
pool and logits within 1e-6, and an import leaves every page outside
its ids unchanged.  On an int8 state (int8 weights over an int8 pool)
each of the five programs replays equal to its eager run the same way,
the pools' int8 values equal and their scales within 1e-6.  An engine
with graphs must give ``generate()``'s greedy tokens, speculating too, a
decode tier importing a prefill tier's pages must give the unified
engine's, and a session parked, dropped from the device and re-imported
from the host spill tier through the captured ``KvImport`` must give
the tokens of an engine that never spilled it (model dtype and int8); a
capture forced to fail must raise from the engine's constructor.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import (
    load_params,
    params_from_jax,
    params_to_device,
    params_to_jax,
)
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.ops.quantize import QTensor, quantize_params
from kubeflow_tpu_torch.serving import programs
from kubeflow_tpu_torch.serving.engine import DecodeEngine

VOCAB = 512
SMALL = dict(vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, head_dim=16, max_seq_len=128)
SLOTS, NB, BT, MB, W, K = 3, 24, 4, 8, 8, 8
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


@pytest.fixture
def model_q(model):
    """``model``'s weights quantized to int8, on the card."""
    params = quantize_params(params_from_jax(params_to_jax(model)))
    return load_params(Transformer(model.cfg, device="meta"),
                       params_to_device(params, "cuda"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n)


def _fresh_pairs(model, kv="model"):
    """Two fresh (state, tables): the captured side's and the eager
    side's, with a pool of the model's dtype or an int8 one."""
    return [(pgen.init_paged_state(model.cfg, SLOTS, NB, BT, kv,
                                   device="cuda"),
             torch.full((SLOTS, MB), NB, dtype=torch.int64, device="cuda"))
            for _ in range(2)]


def _copy_pool(dst, src):
    if isinstance(src, QTensor):
        dst.values.copy_(src.values)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


def _check_pool(got, want):
    """Model-dtype pools within 1e-6; int8 pools' values equal and
    scales within 1e-6."""
    if isinstance(want, QTensor):
        assert torch.equal(got.values, want.values)
        torch.testing.assert_close(got.scale, want.scale, **TOL)
    else:
        torch.testing.assert_close(got, want, **TOL)


def _cover(pairs, slot, blocks):
    for _, tables in pairs:
        tables[slot] = NB
        tables[slot, :len(blocks)] = torch.tensor(blocks)


def _logits(model, state, tables):
    """The paged forward of every slot's last token, on a copy of the
    pools."""
    kv = "int8" if isinstance(state["cache_k"], QTensor) else "model"
    scratch = pgen.init_paged_state(model.cfg, SLOTS, NB, BT, kv,
                                    device="cuda")
    for name in ("cache_k", "cache_v"):
        _copy_pool(scratch[name], state[name])
    with torch.inference_mode():
        return pgen._forward_with_cache(
            model, state["last_token"].long()[:, None],
            (scratch["cache_k"], scratch["cache_v"]), state["lengths"],
            tables=tables)


def _check(model, pairs):
    (got, got_tables), (want, want_tables) = pairs
    torch.cuda.synchronize()
    for name in INTS:
        assert torch.equal(got[name], want[name]), name
    for name in ("cache_k", "cache_v"):
        _check_pool(got[name], want[name])
    torch.testing.assert_close(_logits(model, got, got_tables),
                               _logits(model, want, want_tables), **TOL)


class Twin:
    """One program per (state, tables) pair, fed the same calls: the
    first captured (when ``graphs``), the second eager."""

    def __init__(self, model, pairs, make, graphs=True):
        self.model = model
        self.pairs = pairs
        self.progs = [make(state, tables, g) for (state, tables), g
                      in zip(pairs, (graphs, False))]

    def capture(self):
        with torch.inference_mode():
            self.progs[0].capture(torch.cuda.graph_pool_handle())
        assert self.progs[0].graph is not None
        _check(self.model, self.pairs)

    def call(self, *args):
        """Both programs on the same arguments; their outputs must be
        equal, then their states."""
        outs = []
        with torch.inference_mode():
            for prog in self.progs:
                out = prog.run(*args)
                out = out if isinstance(out, tuple) else (out,)
                outs.append([t.clone() for t in out])
        for got, want in zip(*outs):
            assert torch.equal(got, want)
        _check(self.model, self.pairs)
        return outs[0]

    def prefill(self, slot, n, new, seed):
        prompt = _prompt(n, seed)
        for start in range(0, n, W):
            self.call(prompt[start:start + W], start, n, new, slot, seed)


def _chunk(model, decode):
    return lambda state, tables, graphs: programs.ChunkedPrefill(
        model, decode, state, tables, W, graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_prefill_replays_other_scalars(cuda_device, model, sampling):
    decode = pgen.DecodeConfig(max_new_tokens=8)
    if sampling == "sampled":
        decode = dataclasses.replace(decode, temperature=1.0, top_k=40)
    twin = Twin(model, _fresh_pairs(model), _chunk(model, decode))
    # Captured with (start 0, prompt_len 5, new_tokens 3, slot 0, seed 4,
    # adapter row 0).
    twin.progs[0].inputs[W:] = torch.tensor([0, 5, 3, 0, 4, 0])
    twin.capture()
    state = twin.pairs[0][0]
    # Replayed with others: a non-final, then a final chunk of slot 1.
    _cover(twin.pairs, 1, [5, 9, 2, 7])
    prompt = _prompt(13, 1)
    twin.call(prompt[:W], 0, 13, 6, 1, 21)
    assert bool(state["done"][1]) and int(state["lengths"][1]) == 0
    twin.call(prompt[W:], W, 13, 6, 1, 21)
    assert not bool(state["done"][1]) and int(state["lengths"][1]) == 13
    assert state["keys"][1].tolist() == [21, 1]
    # A one-chunk prompt of slot 2 with a budget of one token.
    _cover(twin.pairs, 2, [0, 1, 3])
    twin.prefill(2, 7, 1, 33)
    assert bool(state["done"][2]) and int(state["stop_len"][2]) == 7
    # Slot 1 reused by another request.
    _cover(twin.pairs, 1, [10, 11, 12, 13])
    twin.prefill(1, 11, 5, 8)
    assert state["keys"][1].tolist() == [8, 1]


def _admit_two(model, decode, pairs):
    """Slots 0 and 2 live, prefilled by eager programs on both sides."""
    chunk = Twin(model, pairs, _chunk(model, decode), graphs=False)
    _cover(pairs, 0, [0, 1, 2, 3, 4, 5])
    chunk.prefill(0, 9, 16, 2)
    _cover(pairs, 2, [6, 7, 8, 9, 10, 11])
    chunk.prefill(2, 4, 5, 3)


def _rounds(model, decode):
    return lambda state, tables, graphs: programs.Rounds(
        model, decode, state, tables, K, graphs)


WIDTHS = (1, 3, 8)


def _eos_inside_a_round(model, decode):
    """(token, round, step): a token that a slot first emits at a step
    after the first of a round, and that no slot emitted before."""
    pairs = _fresh_pairs(model)
    twin = Twin(model, pairs, _rounds(model, decode), graphs=False)
    _admit_two(model, decode, pairs)
    seen = set(pairs[0][0]["last_token"].tolist())
    for r, width in enumerate(WIDTHS):
        toks, _, _ = twin.call(width)
        for j in range(width):
            for s in (0, 2):
                tok = int(toks[s, j])
                if j and tok not in seen:
                    return tok, r, j
            seen.update(toks[:, j].tolist())
    raise AssertionError("no token to end a round with")


@pytest.mark.cuda
@pytest.mark.parametrize("eos", [False, True])
def test_rounds_replay_widths_and_eos(cuda_device, model, eos):
    decode = pgen.DecodeConfig(max_new_tokens=16)
    if eos:
        tok, r, j = _eos_inside_a_round(model, decode)
        decode = dataclasses.replace(decode, eos_token=tok)
    pairs = _fresh_pairs(model)
    twin = Twin(model, pairs, _rounds(model, decode))
    twin.capture()                     # every slot done
    _admit_two(model, decode, pairs)
    results = [twin.call(width) for width in WIDTHS]
    if eos:
        toks, counts, _ = results[r]
        assert any(int(counts[s]) == j + 1 and int(toks[s, j]) == tok
                   for s in (0, 2))
    else:
        assert [int(steps) for _, _, steps in results] == [1, 3, 8]


@pytest.mark.cuda
def test_step_replays(cuda_device, model):
    decode = pgen.DecodeConfig(max_new_tokens=16)
    pairs = _fresh_pairs(model)
    twin = Twin(model, pairs, lambda state, tables, graphs: programs.Step(
        model, decode, state, tables, 2, graphs))
    twin.capture()
    _admit_two(model, decode, pairs)
    for _ in range(3):
        twin.call()


def _verify(model, decode):
    return lambda state, tables, graphs: programs.Verify(
        model, decode, state, tables, SPEC_K, graphs)


SPEC_K = 4


@pytest.mark.cuda
def test_verify_replays_drafts_and_slots(cuda_device, model):
    decode = pgen.DecodeConfig(max_new_tokens=16)
    pairs = _fresh_pairs(model)
    twin = Twin(model, pairs, _verify(model, decode))
    twin.capture()                     # every slot done
    _admit_two(model, decode, pairs)
    state = pairs[0][0]
    # Each live slot's greedy continuation (prompts as _admit_two's).
    conts = {}
    for slot, (n, seed) in ((0, (9, 2)), (2, (4, 3))):
        want, _ = pgen.generate(model, torch.tensor([_prompt(n, seed).tolist()]),
                                pgen.DecodeConfig(max_new_tokens=16))
        conts[slot] = (n, want[0, n:].tolist())

    def oracle(slot):
        n, cont = conts[slot]
        at = int(state["lengths"][slot]) - n + 1     # tokens emitted
        return cont[at:at + SPEC_K]

    rng = np.random.default_rng(7)
    for call in range(4):
        draft = rng.integers(1, VOCAB, (SLOTS, SPEC_K)).astype(np.int32)
        draft_len = np.asarray([SPEC_K, 2, 3], np.int32)
        if call in (0, 2):
            draft[0, :len(oracle(0))] = oracle(0)
        if call in (1, 2):
            draft[2, :len(oracle(2))] = oracle(2)
        if call == 3:
            draft_len[:] = 0
        toks, emit = twin.call(draft, draft_len)
        if call == 0:
            assert int(emit[0]) == SPEC_K + 1 and int(emit[1]) == 0
    assert bool(state["done"][2])          # slot 2's budget of 5 is spent


def _import(model):
    return lambda state, tables, graphs: programs.KvImport(
        model, None, state, tables, MB, graphs)


@pytest.mark.cuda
def test_kv_import_replays_spans_and_ids(cuda_device, model):
    pairs = _fresh_pairs(model)
    progs = [_import(model)(state, tables, g)
             for (state, tables), g in zip(pairs, (True, False))]
    with torch.inference_mode():
        progs[0].capture(torch.cuda.graph_pool_handle())
    _check(model, pairs)
    gen = torch.Generator().manual_seed(5)
    cfg = model.cfg
    for ids in ([5, 9, 2], [11], list(range(12, 12 + MB))):
        n = len(ids)
        shape = (cfg.n_layers, n, BT, cfg.n_kv_heads, cfg.head_dim)
        pages_k = torch.randn(shape, generator=gen)
        pages_v = torch.randn(shape, generator=gen)
        padded = np.full((MB,), NB, np.int64)
        padded[:n] = ids
        before = pairs[0][0]["cache_k"].clone()
        with torch.inference_mode():
            for prog in progs:
                prog.run(pages_k, pages_v, padded)
        _check(model, pairs)
        got = pairs[0][0]
        for name, pages in (("cache_k", pages_k), ("cache_v", pages_v)):
            assert torch.equal(got[name][:, ids].cpu(), pages)
        outside = [b for b in range(NB) if b not in ids]
        assert torch.equal(got["cache_k"][:, outside], before[:, outside])


def _serve(engine, prompts):
    outs = [None] * len(prompts)

    def client(i):
        outs[i] = engine.submit(
            {"tokens": np.asarray(prompts[i], np.int32)})["tokens"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_engine_with_graphs_matches_generate(cuda_device, model,
                                             decode_rounds):
    decode = pgen.DecodeConfig(max_new_tokens=12)
    prompts = [_prompt(n, 50 + n).tolist() for n in (5, 17, 30, 9, 24)]
    engine = DecodeEngine(model, decode, slots=3, prefill_len=32,
                          prefill_chunk_tokens=8, kv_block_tokens=4,
                          decode_rounds=decode_rounds, name="graphs-test")
    try:
        assert engine.cuda_graphs and engine.capture_info["seconds"] > 0
        outs = _serve(engine, prompts)
        want_programs = {"chunked_prefill": 1, "verify": 0}
        want_programs.update({"step": 1} if decode_rounds == 1
                             else {"step": 0, "decode_rounds": 1})
        assert engine.compiled_programs() == want_programs
    finally:
        engine.close()
    assert engine._decode_prog.graph is None       # freed at close
    for prompt, out in zip(prompts, outs):
        want, _ = pgen.generate(model, torch.tensor([prompt]), decode)
        assert np.asarray(out)[0].tolist() == want[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_speculating_engine_with_graphs_matches_generate(cuda_device, model,
                                                         decode_rounds):
    decode = pgen.DecodeConfig(max_new_tokens=16)
    rng = np.random.default_rng(60)
    prompts = [np.tile(rng.integers(1, VOCAB, 4), 3).tolist()
               if i % 2 == 0 else _prompt(10, 70 + i).tolist()
               for i in range(6)]
    engine = DecodeEngine(model, decode, slots=3, prefill_len=32,
                          prefill_chunk_tokens=8, kv_block_tokens=4,
                          decode_rounds=decode_rounds,
                          speculative_tokens=SPEC_K, name="graphs-spec")
    try:
        assert type(engine._verify_prog).__name__ in \
            engine.capture_info["programs"]
        outs = _serve(engine, prompts)
        programs_run = engine.compiled_programs()
    finally:
        engine.close()
    for prompt, out in zip(prompts, outs):
        want, _ = pgen.generate(model, torch.tensor([prompt]), decode)
        assert np.asarray(out)[0].tolist() == want[0].tolist()
    assert programs_run["chunked_prefill"] == 1


@pytest.mark.cuda
def test_decode_tier_import_with_graphs_matches_unified(cuda_device, model):
    decode = pgen.DecodeConfig(max_new_tokens=8)
    prompt = _prompt(30, 80)

    def engine(name):
        return DecodeEngine(model, decode, slots=2, prefill_len=32,
                            prefill_chunk_tokens=8, kv_block_tokens=4,
                            prefix_caching=False, name=name)

    pre, dec, uni = engine("pre"), engine("dec"), engine("uni")
    try:
        out = pre.prefill_export({"tokens": prompt})
        ho = out["kv_handoff"]
        assert ho["tokens_covered"] == 28 and ho["k"].device.type == "cpu"
        got = dec.submit({"tokens": prompt, "kv_handoff": ho})["tokens"]
        want = uni.submit({"tokens": prompt})["tokens"]
        assert dec.compiled_programs()["kv_import"] == 1
    finally:
        for e in (pre, dec, uni):
            e.close()
    assert np.asarray(got).tolist() == np.asarray(want).tolist()


@pytest.mark.cuda
def test_failed_capture_raises_from_the_engine(cuda_device, model,
                                               monkeypatch):
    def fails(self, pool):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(programs._Program, "capture", fails)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        DecodeEngine(model, pgen.DecodeConfig(max_new_tokens=4), slots=1,
                     prefill_len=16, name="fails")


# -- int8 weights over an int8 pool -------------------------------------------

INT8 = pgen.DecodeConfig(max_new_tokens=16, kv_cache_dtype="int8")


@pytest.mark.cuda
def test_int8_prefill_replays(cuda_device, model_q):
    pairs = _fresh_pairs(model_q, "int8")
    twin = Twin(model_q, pairs, _chunk(model_q, INT8))
    twin.capture()
    _cover(pairs, 1, [5, 9, 2, 7])
    twin.prefill(1, 13, 6, 21)
    _cover(pairs, 2, [0, 1, 3])
    twin.prefill(2, 7, 1, 33)
    assert pairs[0][0]["cache_k"].scale[:, [5, 9]].abs().sum() > 0


@pytest.mark.cuda
def test_int8_rounds_and_step_replay(cuda_device, model_q):
    for make, args in ((_rounds(model_q, INT8), [(w,) for w in WIDTHS]),
                       (lambda state, tables, graphs: programs.Step(
                           model_q, INT8, state, tables, 2, graphs),
                        [()] * 3)):
        pairs = _fresh_pairs(model_q, "int8")
        twin = Twin(model_q, pairs, make)
        twin.capture()
        _admit_two(model_q, INT8, pairs)
        for a in args:
            twin.call(*a)


@pytest.mark.cuda
def test_int8_verify_replays(cuda_device, model_q):
    pairs = _fresh_pairs(model_q, "int8")
    twin = Twin(model_q, pairs, _verify(model_q, INT8))
    twin.capture()
    _admit_two(model_q, INT8, pairs)
    rng = np.random.default_rng(8)
    for draft_len in ([SPEC_K, 2, 3], [0, 0, 0], [1, 0, SPEC_K]):
        draft = rng.integers(1, VOCAB, (SLOTS, SPEC_K)).astype(np.int32)
        twin.call(draft, np.asarray(draft_len, np.int32))


@pytest.mark.cuda
def test_int8_kv_import_replays(cuda_device, model_q):
    pairs = _fresh_pairs(model_q, "int8")
    progs = [_import(model_q)(state, tables, g)
             for (state, tables), g in zip(pairs, (True, False))]
    with torch.inference_mode():
        progs[0].capture(torch.cuda.graph_pool_handle())
    _check(model_q, pairs)
    gen = torch.Generator().manual_seed(6)
    cfg = model_q.cfg
    for ids in ([5, 9, 2], list(range(12, 12 + MB))):
        n = len(ids)
        shape = (cfg.n_layers, n, BT, cfg.n_kv_heads, cfg.head_dim)

        def pages():
            return QTensor(
                torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8),
                torch.rand(shape[:-1], generator=gen), (-1,))

        pages_k, pages_v = pages(), pages()
        padded = np.full((MB,), NB, np.int64)
        padded[:n] = ids
        before = pairs[0][0]["cache_k"].scale.clone()
        with torch.inference_mode():
            for prog in progs:
                prog.run(pages_k, pages_v, padded)
        _check(model_q, pairs)
        got = pairs[0][0]
        for name, want in (("cache_k", pages_k), ("cache_v", pages_v)):
            assert torch.equal(got[name].values[:, ids].cpu(), want.values)
            assert torch.equal(got[name].scale[:, ids].cpu(), want.scale)
        outside = [b for b in range(NB) if b not in ids]
        assert torch.equal(got["cache_k"].scale[:, outside],
                           before[:, outside])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_spill_reimport_with_graphs_matches_uninterrupted(cuda_device,
                                                          model, model_q,
                                                          kv):
    """A parked session whose device records are dropped resumes through
    the host tier's re-import (the captured KvImport); its second turn
    equals that of an engine whose device record stayed."""
    served = model_q if kv == "int8" else model
    decode = pgen.DecodeConfig(max_new_tokens=8, kv_cache_dtype=kv)

    def engine(name, **kw):
        return DecodeEngine(served, decode, slots=2, prefill_len=48,
                            prefill_chunk_tokens=8, kv_block_tokens=4,
                            name=name, **kw)

    prompt = _prompt(21, 90)
    spill, keep = (engine("spill", kv_pool_blocks=24, host_spill_blocks=64),
                   engine("keep"))
    try:
        turns = {}
        for name, eng in (("spill", spill), ("keep", keep)):
            turn1 = eng.submit({"tokens": prompt, "park_kv": True})
            turns[name] = np.asarray(turn1["tokens"])[0]
        assert turns["spill"].tolist() == turns["keep"].tolist()
        with spill._lock:
            while spill._mgr._lru:
                _, rec = spill._mgr._lru.popitem(last=False)
                spill._mgr._drop_record(rec, count=False)
        turn2 = np.concatenate([turns["spill"], _prompt(3, 91)])
        got = spill.submit({"tokens": turn2})["tokens"]
        want = keep.submit({"tokens": turn2})["tokens"]
        stats = spill.stats()
        assert stats["kv_spill_pages_in"] > 0
        assert spill.compiled_programs()["kv_import"] == 1
        assert keep.stats()["kv_spill_pages_in"] == 0
    finally:
        spill.close()
        keep.close()
    assert np.asarray(got).tolist() == np.asarray(want).tolist()
