"""The decode engine's program objects (serving/programs.py) on the CPU.

Each program runs its body over fixed buffers: the chunk's tokens and
scalars uploaded into one int64 buffer, the slot's table row picked on
the device, the state written in place.  Over a sequence of different
slots, starts, seeds, prompt lengths and round widths (EOS inside a
round included), every result must EQUAL the direct function calls of
models/generate.py on a copy of the same state: the same ops on the same
values.  Across a whole engine burst no state tensor, device table or
program buffer may move (a CUDA graph reads and writes fixed
addresses); ``cuda_graphs=True`` on the CPU raises."""

import dataclasses
import itertools
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving import programs
from kubeflow_tpu_torch.serving.engine import DecodeEngine

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

VOCAB = 256
SMALL = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, head_dim=8, max_seq_len=64)
SLOTS, NB, BT, MB, W, K = 3, 14, 4, 6, 4, 4
WAIT_S = 60
# (slot, prompt length, new tokens, seed, table blocks): multi-chunk,
# single-chunk and chunk-aligned prompts, a slot reused.
ADMISSIONS = [(1, 10, 9, 7, [3, 7, 1, 9, 12]),
              (0, 3, 12, 3, [0, 2, 4, 5, 6]),
              (2, 8, 2, 11, [8, 10, 11, 13]),
              (2, 5, 6, 5, [8, 10, 11, 13])]
WIDTHS = (3, 1, 8, 2, 4, 4)


@pytest.fixture(scope="module")
def model():
    cfg = TransformerConfig(dtype=torch.float32, attention="dot", **SMALL)
    return Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n)


def _copy(model, state):
    twin = pgen.init_paged_state(model.cfg, SLOTS, NB, BT, device="cpu")
    for name, value in state.items():
        twin[name].copy_(value)
    return twin


def _assert_states_equal(got, want):
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _sequence(model, decode, round_fn, direct_round):
    """Admissions through ChunkedPrefill, one decode call after every
    chunk (a mid-prefill slot stays frozen, a reused slot's occupant is
    frozen by its successor's first chunk), each against the direct
    calls on a twin state; returns the tokens every decode call
    emitted."""
    state = pgen.init_paged_state(model.cfg, SLOTS, NB, BT, device="cpu")
    tables = torch.full((SLOTS, MB), NB, dtype=torch.int64)
    chunk = programs.ChunkedPrefill(model, decode, state, tables, W,
                                    graphs=False)
    twin = _copy(model, state)
    emitted = []
    with torch.inference_mode():
        for slot, n, new, seed, blocks in ADMISSIONS:
            tables[slot] = NB
            tables[slot, :len(blocks)] = torch.tensor(blocks)
            prompt = _prompt(n, seed)
            for start in range(0, n, W):
                seg = prompt[start:start + W]
                tok = chunk.run(seg, start, n, new, slot, seed)
                padded = torch.zeros((1, W), dtype=torch.int64)
                padded[0, :len(seg)] = torch.from_numpy(seg)
                twin, want = pgen.prefill_chunk_into_slot(
                    model, twin, decode, padded, start, n, new, slot, seed,
                    tables[slot:slot + 1])
                assert torch.equal(tok, want)
                _assert_states_equal(state, twin)
                got = round_fn(state, tables)
                twin, want = direct_round(twin, tables)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                _assert_states_equal(state, twin)
                emitted.append(got[0].clone())
    return emitted


def _rounds(model, decode, widths):
    calls = itertools.cycle(widths)
    prog = {}

    def run(state, tables):
        if not prog:
            prog["p"] = programs.Rounds(model, decode, state, tables, K,
                                        graphs=False)
        return prog["p"].run(next(calls))

    direct_calls = itertools.cycle(widths)

    def direct(twin, tables):
        twin, toks, counts, steps = pgen.decode_rounds(
            model, twin, decode, K, tables, next(direct_calls))
        return twin, (toks, counts, steps)

    return run, direct


def _eos_inside_a_round(model, decode):
    """A token that some slot emits at step j >= 1 of a round and at no
    earlier step of that round."""
    run, direct = _rounds(model, decode, WIDTHS)
    for toks in _sequence(model, decode, run, direct):
        for j in range(1, toks.shape[1]):
            for s in range(SLOTS):
                tok = int(toks[s, j])
                if tok and tok not in toks[:, :j].flatten().tolist():
                    return tok
    raise AssertionError("no token to end a round with")


@pytest.mark.parametrize("sampling", ["greedy", "eos", "sampled"])
def test_rounds_and_prefill_match_direct_calls(model, sampling):
    decode = pgen.DecodeConfig(max_new_tokens=12)
    if sampling == "eos":
        decode = dataclasses.replace(
            decode, eos_token=_eos_inside_a_round(model, decode))
    elif sampling == "sampled":
        decode = dataclasses.replace(decode, temperature=1.0, top_k=20)
    run, direct = _rounds(model, decode, WIDTHS)
    emitted = _sequence(model, decode, run, direct)
    assert any(int(t.count_nonzero()) for t in emitted)
    if sampling == "eos":
        # Some slot's round ended at EOS after its first step.
        assert any(bool((t[:, 1:] == decode.eos_token).any())
                   for t in emitted)


def test_step_matches_direct_calls(model):
    decode = pgen.DecodeConfig(max_new_tokens=12)
    prog = {}

    def run(state, tables):
        if not prog:
            prog["p"] = programs.Step(model, decode, state, tables, 2,
                                      graphs=False)
        return (prog["p"].run(),)

    def direct(twin, tables):
        twin, sampled = pgen.decode_step(model, twin, decode, 2, tables)
        return twin, (sampled,)

    _sequence(model, decode, run, direct)


def _pointers(engine):
    bufs = dict(engine._state)
    bufs["tables_dev"] = engine._tables_dev
    for owner in (engine._chunk_prog, engine._decode_prog):
        for name, value in vars(owner).items():
            if isinstance(value, torch.Tensor):
                bufs[f"{type(owner).__name__}.{name}"] = value
    return {name: value.data_ptr() for name, value in bufs.items()}


@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_buffers_keep_their_storage_across_a_burst(model, decode_rounds):
    decode = pgen.DecodeConfig(max_new_tokens=6)
    engine = DecodeEngine(model, decode, slots=2, prefill_len=16,
                          prefill_chunk_tokens=4, kv_block_tokens=4,
                          decode_rounds=decode_rounds, name="ptr-test")
    prompts = [_prompt(n, 40 + n).tolist() for n in (3, 9, 14, 6, 11)]
    outs = [None] * len(prompts)
    try:
        before = _pointers(engine)
        assert engine._chunk_prog.state is engine._state
        assert engine._decode_prog.state is engine._state

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
        assert _pointers(engine) == before
        assert engine.stats()["requests"] == len(prompts)
    finally:
        engine.close()
    for prompt, out in zip(prompts, outs):
        want, _ = pgen.generate(model, torch.tensor([prompt]), decode)
        assert np.asarray(out)[0].tolist() == want[0].tolist()


def test_cuda_graphs_on_the_cpu_raise(model):
    decode = pgen.DecodeConfig(max_new_tokens=4)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        DecodeEngine(model, decode, slots=1, prefill_len=8,
                     cuda_graphs=True)
    engine = DecodeEngine(model, decode, slots=1, prefill_len=8,
                          cuda_graphs=False)
    try:
        assert not engine.cuda_graphs and engine.capture_info is None
    finally:
        engine.close()
