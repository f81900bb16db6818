"""The port's continuous-batching DecodeEngine against the JAX package's.

The twins of tests/test_lm_serving.py's TestDecodeEngine and
tests/test_fused_decode.py, minus mesh (speculation is
tests/test_torch_speculative.py's, int8 tests/test_torch_int8_engine.py's,
the host spill tier tests/test_torch_kv_spill.py's and adapters
tests/test_torch_adapters.py's): the same numpy
weights serve
through both engines at float32 on the CPU, and the port's greedy
tokens must equal the JAX engine's (which takes the requests one at a
time) and the port's own single-request ``generate()``, across mixed
lengths with slot reuse, per-step and fused rounds, prefix caching on
and off under eviction, EOS retirement and deadline expiry.
``compiled_programs()`` must report what the JAX engine reports.
Sampled decode is held to the port's own determinism: the same seed
gives the same stream, alone or co-batched.  Every wait has its own
timeout and every engine is closed in ``finally``."""

import dataclasses
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving.adapters import AdapterNotFound
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.errors import (
    BatcherClosed,
    DeadlineExceeded,
    Overloaded,
)
from kubeflow_tpu_torch.testing import faults

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SEED = 20261017
VOCAB, NEW_TOKENS = 256, 12
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}
WAIT_S = 60
# The engine geometry of the JAX twins: 3 slots, prefill width 16,
# 8-token chunks, 4-token blocks.
GEOMETRY = dict(slots=3, prefill_len=16, admit_width=2,
                prefill_chunk_tokens=8, kv_block_tokens=4)
MIXED_LENS = [3, 9, 16, 2, 9, 16, 3, 16, 2]
MIXED_NEWS = [12, 6, 3, 8, 12, 4, 10, 5, 12]


@pytest.fixture(scope="module")
def spec():
    """The JAX engine_spec and the port's model over the same weights."""
    jcfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    variables = JaxTransformer(jcfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))
    params = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **OVERRIDES),
                    device="meta"),
        params_from_jax(params))
    from kubeflow_tpu.models.generate import DecodeConfig as JaxDecode

    return SimpleNamespace(
        jcfg=jcfg, params=jax.device_put(params), model=model,
        jdecode=JaxDecode(max_new_tokens=NEW_TOKENS),
        decode=pgen.DecodeConfig(max_new_tokens=NEW_TOKENS))


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=(n,)).tolist() for n in lens]


def _port_engine(spec, decode=None, **kw):
    kw.setdefault("name", "port-test")
    return DecodeEngine(spec.model, decode or spec.decode, **kw)


def _jax_engine(spec, decode=None, **kw):
    kw.setdefault("name", "jax-twin")
    return JaxDecodeEngine(spec.jcfg, spec.params, decode or spec.jdecode,
                           **kw)


def _serve(engine, prompts, news=None, seeds=None, deadlines=None):
    """Submit every prompt from its own thread; returns each result's
    token list, or the exception it raised."""
    outs = [None] * len(prompts)

    def client(i):
        inputs = {"tokens": np.asarray(prompts[i], np.int32)}
        if news is not None:
            inputs["max_new_tokens"] = news[i]
        if seeds is not None:
            inputs["seed"] = seeds[i]
        try:
            out = engine.submit(
                inputs, deadline=None if deadlines is None
                else deadlines[i])
            outs[i] = np.asarray(out["tokens"])[0].tolist()
        except Exception as exc:  # noqa: BLE001 -- handed to the test
            outs[i] = exc

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return outs


def _submit(engine, inputs, deadline=None):
    """engine.submit() from a thread joined with a timeout: the result,
    or the exception the submit raised, re-raised here."""
    box = {}

    def call():
        try:
            box["out"] = engine.submit(inputs, deadline=deadline)
        except Exception as exc:  # noqa: BLE001 -- re-raised below
            box["err"] = exc

    thread = threading.Thread(target=call)
    thread.start()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive(), "submit hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _run(make, prompts, news=None, **kw):
    engine = make(**kw)
    try:
        outs = _serve(engine, prompts, news)
        return outs, engine.stats(), engine.compiled_programs(), engine
    finally:
        engine.close()


def _cut(prompt, new, budget, eos):
    """prompt + the first ``budget`` new tokens, through EOS at most
    (greedy decode is prefix-stable)."""
    new = list(new)[:budget]
    if eos >= 0 and eos in new:
        new = new[:new.index(eos) + 1]
    return list(prompt) + new


def _generate_rows(spec, prompts, news, decode=None):
    """The port's single-request generate() per prompt, cut to its
    budget and EOS."""
    decode = decode or spec.decode
    rows = []
    for prompt, new in zip(prompts, news):
        out, _ = pgen.generate(spec.model, torch.tensor([prompt]), decode)
        rows.append(_cut(prompt, out[0, len(prompt):].tolist(), new,
                         decode.eos_token))
    return rows


def _jax_generate_rows(spec, prompts, news, jdecode=None):
    """The JAX package's single-request generate(), cut the same way."""
    from kubeflow_tpu.models.generate import generate as jax_generate

    jdecode = jdecode or spec.jdecode
    rows = []
    for prompt, new in zip(prompts, news):
        out, _ = jax_generate(spec.jcfg, spec.params,
                              np.asarray([prompt], np.int32), jdecode)
        rows.append(_cut(prompt, np.asarray(out)[0, len(prompt):].tolist(),
                         new, jdecode.eos_token))
    return rows


def _jax_twin(spec, prompts, news, jdecode=None, **kw):
    """The JAX engine's tokens and compiled_programs() on the same
    requests, submitted one at a time in order.  With one request in
    flight, what the JAX engine batches together does not depend on
    thread timing; co-batched under a loaded test run, its near-tie
    argmaxes have drifted from its own generate() (ROADMAP queue 3).
    Nothing stands in for its rows: the port is held to them as they
    come."""
    engine = _jax_engine(spec, jdecode, **kw)
    try:
        rows = []
        for i, prompt in enumerate(prompts):
            inputs = {"tokens": np.asarray(prompt, np.int32)}
            if news is not None:
                inputs["max_new_tokens"] = news[i]
            rows.append(np.asarray(_submit(engine, inputs)["tokens"])[0]
                        .tolist())
        return rows, engine.compiled_programs()
    finally:
        engine.close()


@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_mixed_lengths_slot_reuse_matches_jax_and_generate(spec,
                                                           decode_rounds):
    """9 requests through 3 slots: every slot reused, multi-chunk
    prefill, admission waves, prefix caching on with 4-token pages."""
    prompts = _prompts(MIXED_LENS, SEED)
    want = _generate_rows(spec, prompts, MIXED_NEWS)
    got, stats, programs, _ = _run(
        lambda **kw: _port_engine(spec, **kw), prompts, MIXED_NEWS,
        decode_rounds=decode_rounds, **GEOMETRY)
    twin, jax_programs = _jax_twin(
        spec, prompts, MIXED_NEWS, decode_rounds=decode_rounds, **GEOMETRY)
    assert want == _jax_generate_rows(spec, prompts, MIXED_NEWS)
    for i in range(len(prompts)):
        assert got[i] == want[i], f"request {i} drifted from generate()"
        assert got[i] == twin[i], f"request {i} drifted from JAX's engine"
    assert programs == jax_programs
    assert programs == ({"chunked_prefill": 1, "step": 1, "verify": 0}
                        if decode_rounds == 1 else
                        {"chunked_prefill": 1, "step": 0, "verify": 0,
                         "decode_rounds": 1})
    assert stats["requests"] == len(prompts)
    assert stats["tokens"] == sum(MIXED_NEWS)
    assert stats["active_slots"] == 0 and stats["queue_depth"] == 0
    assert stats["in_flight_requests"] == 0
    assert stats["decode_rounds"] == decode_rounds
    if decode_rounds > 1:
        assert stats["fused_rounds"] > 0
        assert stats["steps_per_round_p99"] \
            >= stats["steps_per_round_p50"] >= 1


@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_eos_retirement_matches_jax_and_generate(spec, decode_rounds):
    prompts = _prompts((3, 9, 16), SEED + 1)
    # EOS: a token the first prompt's continuation emits at step 3 and
    # not before.
    row = _generate_rows(spec, prompts[:1], [NEW_TOKENS])[0][3:]
    eos = next(t for j, t in enumerate(row) if j >= 2 and t not in row[:j])
    decode = dataclasses.replace(spec.decode, eos_token=eos)
    jdecode = dataclasses.replace(spec.jdecode, eos_token=eos)
    want = _generate_rows(spec, prompts, [NEW_TOKENS] * 3, decode)
    got, stats, _, _ = _run(
        lambda **kw: _port_engine(spec, decode, **kw), prompts,
        slots=2, prefill_len=16, decode_rounds=decode_rounds)
    twin, _ = _jax_twin(spec, prompts, None, jdecode, slots=2,
                        prefill_len=16, decode_rounds=decode_rounds)
    assert got == want == twin
    assert want == _jax_generate_rows(spec, prompts, [NEW_TOKENS] * 3,
                                      jdecode)
    assert len(got[0]) < len(prompts[0]) + NEW_TOKENS
    assert stats["active_slots"] == 0 and stats["in_flight_requests"] == 0


def test_prefix_cache_on_off_with_eviction(spec):
    """Aliasing is invisible in the tokens: cache ON (with LRU eviction
    forced by a 10-page pool contended by two prefix families) equals
    cache OFF equals generate() equals JAX's engine, and both pools
    drain completely."""
    rng = np.random.RandomState(SEED + 7)
    prefix_a = rng.randint(1, VOCAB, size=(8,)).tolist()
    prefix_b = rng.randint(1, VOCAB, size=(8,)).tolist()
    prompts = [fam + rng.randint(1, VOCAB, size=(5,)).tolist()
               for fam in (prefix_a, prefix_a, prefix_b, prefix_a,
                           prefix_b, prefix_a, prefix_b, prefix_a)]
    news = [6, 9, 5, 12, 8, 4, 10, 7]
    want = _generate_rows(spec, prompts, news)
    geometry = dict(slots=2, prefill_len=16, prefill_chunk_tokens=4,
                    kv_block_tokens=4, kv_pool_blocks=10)
    runs = {}
    for caching in (True, False):
        engine = _port_engine(spec, prefix_caching=caching, **geometry)
        try:
            outs = _serve(engine, prompts, news)
            engine._mgr.check_invariants()
            runs[caching] = (outs, engine.stats())
        finally:
            engine.close()
        assert engine._mgr.used_blocks() == 0
    twin, _ = _jax_twin(spec, prompts, news, **geometry)
    for caching, (outs, _) in runs.items():
        assert outs == want, f"cache {'ON' if caching else 'OFF'} drifted"
    assert twin == want == _jax_generate_rows(spec, prompts, news)
    on, off = runs[True][1], runs[False][1]
    assert on["prefix_hits"] >= 1 and on["prefix_evictions"] >= 1
    assert on["kv_block_evictions"] >= 1
    assert 0 < on["cached_token_ratio"] < 1
    assert off["prefix_hits"] == 0 and off["kv_blocks_used"] == 0


def test_shared_prefix_zero_copy_aliasing(spec):
    """The second of two requests sharing an 8-token (2-page) prefix
    aliases the first's physical pages and decodes as it would alone."""
    rng = np.random.RandomState(SEED + 13)
    common = rng.randint(1, VOCAB, size=(8,)).tolist()
    p1 = common + rng.randint(1, VOCAB, size=(4,)).tolist()
    p2 = common + rng.randint(1, VOCAB, size=(6,)).tolist()
    want = _generate_rows(spec, [p1, p2], [6, 6])
    engine = _port_engine(spec, slots=2, prefill_len=16,
                          prefill_chunk_tokens=8, kv_block_tokens=4)
    try:
        o1 = _submit(engine, {"tokens": np.asarray(p1, np.int32),
                            "max_new_tokens": 6})
        with engine._lock:
            published = list(list(engine._mgr._lru.values())[0].blocks)
        o2 = _submit(engine, {"tokens": np.asarray(p2, np.int32),
                            "max_new_tokens": 6, "return_timing": True})
        assert np.asarray(o1["tokens"])[0].tolist() == want[0]
        assert np.asarray(o2["tokens"])[0].tolist() == want[1]
        assert o2["cached_tokens"] == 8
        with engine._lock:
            recs = list(engine._mgr._lru.values())
        assert any(r.blocks[:2] == published[:2] and len(r.blocks) > 2
                   for r in recs)
        assert engine.stats()["prefix_hits"] == 1
        engine._mgr.check_invariants()
    finally:
        engine.close()
    assert engine._mgr.used_blocks() == 0


def test_pool_exhaustion_sheds_typed_overloaded(spec):
    engine = _port_engine(spec, slots=2, prefill_len=16,
                          kv_block_tokens=4, kv_pool_blocks=3)
    try:
        # 12 prompt + 12 budget = 6 pages > the 3-page pool.
        with pytest.raises(Overloaded):
            _submit(engine, {"tokens": np.arange(1, 13, dtype=np.int32)})
        stats = engine.stats()
        assert stats["shed"] == 1 and stats["kv_shed_no_blocks"] == 1
        out = _submit(engine, {"tokens": np.asarray([3, 4], np.int32),
                             "max_new_tokens": 4})
        assert np.asarray(out["tokens"]).shape == (1, 6)
        stats = engine.stats()
        assert stats["requests"] == 1
        assert stats["tokens_resident"] == stats["kv_blocks_used"] * 4
    finally:
        engine.close()


def test_deadline_expires_at_round_boundary_frees_slot(spec):
    """Under fused rounds a request expiring mid-round is retired at the
    next boundary; its slot serves a successor that matches generate()."""
    prompt_c, prompt_a, prompt_b = _prompts((6, 5, 7), SEED + 2)
    outs = {}
    with faults.injected("seed=1;engine.step:sleep=0.2"):
        engine = _port_engine(spec, slots=2, prefill_len=16,
                              decode_rounds=8)

        def client(key, prompt, deadline=None):
            try:
                outs[key] = np.asarray(_submit(
                    engine, {"tokens": np.asarray(prompt, np.int32)},
                    deadline=deadline)["tokens"])[0].tolist()
            except Exception as exc:  # noqa: BLE001 -- the point
                outs[key] = exc

        try:
            t_c = threading.Thread(target=client, args=("c", prompt_c))
            t_c.start()
            t_a = threading.Thread(target=client, args=(
                "a", prompt_a, faults.monotonic() + 0.1))
            t_a.start()
            t_a.join(timeout=WAIT_S)
            assert isinstance(outs["a"], DeadlineExceeded), outs["a"]
            client("b", prompt_b)
            t_c.join(timeout=WAIT_S)
            assert not t_c.is_alive()
            stats = engine.stats()
            assert stats["deadline_expired"] == 1
            assert stats["in_flight_requests"] == 0
        finally:
            engine.close()
    want = _generate_rows(spec, [prompt_c, prompt_b], [NEW_TOKENS] * 2)
    assert [outs["c"], outs["b"]] == want


def test_final_chunk_near_cache_end_stays_in_bounds(spec):
    """A cached-prefix resume whose final chunk window runs past the
    slot's max_len: prefill_len 16, max_len 18, chunk 8 and a 12-column
    cached prefix put the window at [12, 20)."""
    prompt = _prompts((15,), SEED + 11)[0]
    want = _generate_rows(spec, [prompt], [3])[0]
    engine = _port_engine(spec, slots=1, prefill_len=16, max_len=18,
                          prefill_chunk_tokens=8, kv_block_tokens=4)
    try:
        for _ in range(2):
            out = _submit(engine, {"tokens": np.asarray(prompt, np.int32),
                                 "max_new_tokens": 3})
            assert np.asarray(out["tokens"])[0].tolist() == want
        stats = engine.stats()
        assert stats["prefix_hits"] == 1
        assert stats["cached_prompt_tokens"] == 12
    finally:
        engine.close()


def test_padded_prompt_and_budget_clamp(spec):
    real = _prompts((5,), SEED + 9)[0]
    padded = np.zeros((24,), np.int32)
    padded[:5] = real
    want = _generate_rows(spec, [real], [6])[0]
    engine = _port_engine(spec, slots=1, prefill_len=16)
    try:
        assert engine.accepts({"tokens": padded})
        out = _submit(engine, {"tokens": padded, "max_new_tokens": 6})
        assert np.asarray(out["tokens"])[0].tolist() == want
        out = _submit(engine, {"tokens": padded, "prompt_len": 5,
                             "max_new_tokens": 6})
        assert np.asarray(out["tokens"])[0].tolist() == want
        assert not engine.accepts(
            {"tokens": np.arange(1, 25, dtype=np.int32)})
        out = _submit(engine, {"tokens": np.arange(1, 4, dtype=np.int32),
                             "max_new_tokens": 500})
        assert np.asarray(out["tokens"]).shape == (1, 3 + NEW_TOKENS)
    finally:
        engine.close()


def test_deterministic_shutdown(spec):
    engine = _port_engine(spec, slots=2, prefill_len=16)
    out = _submit(engine, {"tokens": np.arange(1, 6, dtype=np.int32),
                         "max_new_tokens": 4})
    assert np.asarray(out["tokens"]).shape == (1, 9)
    engine.close(drain_s=5.0)
    assert not engine._thread.is_alive()
    with pytest.raises(BatcherClosed):
        _submit(engine, {"tokens": np.arange(1, 6, dtype=np.int32)})
    engine.close()  # idempotent


def test_abort_resolves_retired_requests(spec, monkeypatch):
    """Engine death errors every waiter, also a request retired at
    dispatch whose lagged emission still sat in the pending stream."""
    real = pgen.decode_step
    calls = {"n": 0}

    def dies_on_second_step(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("device died")
        return real(*args, **kwargs)

    monkeypatch.setattr(pgen, "decode_step", dies_on_second_step)
    engine = _port_engine(spec, slots=2, prefill_len=16, sync_lag=4)
    try:
        outs = _serve(engine, [list(range(1, 5))] * 2, news=[2, 12])
        assert all(isinstance(o, RuntimeError) for o in outs), outs
    finally:
        engine.close()


def test_loop_thread_runs_programs_in_inference_mode(spec, monkeypatch):
    seen = []
    for name in ("prefill_chunk_into_slot", "decode_round_step"):
        real = getattr(pgen, name)

        def wrapped(*args, _real=real, **kwargs):
            seen.append(torch.is_inference_mode_enabled())
            return _real(*args, **kwargs)

        monkeypatch.setattr(pgen, name, wrapped)
    engine = _port_engine(spec, slots=2, prefill_len=16, decode_rounds=8)
    try:
        _serve(engine, _prompts((4, 7), SEED + 3))
    finally:
        engine.close()
    assert seen and all(seen), seen


def test_sampled_stream_repeats_alone_or_co_batched(spec):
    decode = dataclasses.replace(spec.decode, temperature=1.0, top_k=40)
    prompt = _prompts((6,), SEED + 5)[0]
    others = _prompts((4, 9), SEED + 6)

    def run(prompts, seeds, decode_rounds):
        engine = _port_engine(spec, decode, slots=3, prefill_len=16,
                              decode_rounds=decode_rounds)
        try:
            return _serve(engine, prompts, seeds=seeds)
        finally:
            engine.close()

    alone = run([prompt], [7], 8)[0]
    assert alone == run([prompt], [7], 8)[0]
    assert alone == run([prompt] + others, [7, 1, 2], 8)[0]
    assert alone == run([prompt] + others, [7, 3, 4], 1)[0]
    assert alone != run([prompt], [8], 8)[0]


# The mesh's one refusal: capture under a tensor mesh (the mesh itself
# is ported, tests/test_torch_serving_mesh.py).  It refuses before the
# mesh is read, and keeps the id of the mesh refusal it replaces.
@pytest.mark.parametrize("option,item", [
    ({"mesh": object(), "cuda_graphs": True}, 25),
], ids=["option3-6"])
def test_held_back_options_raise_not_ported(spec, option, item):
    with pytest.raises(NotPortedError, match=f"ROADMAP queue 1 item {item}"):
        _port_engine(spec, **option)


def test_host_spill_tier_builds_under_a_mesh(spec):
    """The host spill tier under a mesh (the job's one rank here; two in
    tests/test_torch_serving_mesh.py): the engine builds with it, a
    parked session's pages reach rank 0's host tier through the mesh's
    gather, and ``fetch_kv`` answers them."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import MeshSpec
    from kubeflow_tpu_torch.serving import lockstep

    before = dist.is_initialized()
    mesh = MeshSpec(data=1, tensor=1).build("cpu", timeout_s=60)
    try:
        lockstep.attach(mesh, 60)
        engine = _port_engine(spec, mesh=mesh, host_spill_blocks=16,
                              **GEOMETRY)
        try:
            prompt = np.asarray(_prompts([16], SEED)[0], np.int32)
            out = engine.submit({"tokens": prompt, "park_kv": True})
            st = engine.stats()
            fetched = engine.fetch_kv({"tokens": out["tokens"][0]})
        finally:
            engine.close()
        lockstep.channel(mesh).close()
    finally:
        if not before:  # the one-rank group this build started
            dist.destroy_process_group()
    assert st["host_spill_blocks"] == 16 and st["mesh_devices"] == 1
    assert st["parked_sessions"] == 1 and st["kv_spill_pages_out"] > 0
    assert fetched["tokens_covered"] == st["kv_spill_pages_out"] \
        * GEOMETRY["kv_block_tokens"]


def test_held_back_requests_raise_not_ported(spec):
    """Adapters are ported: a request naming one on an engine built
    without an adapter registry is refused with AdapterNotFound (a 404),
    never decoded with base weights, and the loop serves on."""
    engine = _port_engine(spec, slots=1, prefill_len=16)
    tokens = np.arange(1, 5, dtype=np.int32)
    try:
        with pytest.raises(AdapterNotFound, match="serves no adapters"):
            _submit(engine, {"tokens": tokens, "adapter": {"x": 1}})
        # The loop thread lives on and serves.
        t0 = time.monotonic()
        out = _submit(engine, {"tokens": tokens, "max_new_tokens": 2})
        assert np.asarray(out["tokens"]).shape == (1, 6)
        assert time.monotonic() - t0 < WAIT_S
    finally:
        engine.close()
