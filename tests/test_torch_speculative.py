"""The port's speculative decoding against the JAX package's.

``verify_step`` goes through both packages on the same paged state (the
same numpy weights, block tables and drafts) at float32 on the CPU: a
fully accepted draft, a fully rejected one, a draft clipped by its slot's
budget, an undrafted slot and a retired one in one call, then a second
call over the rejected columns; then EOS inside an accepted window.  The
pool and the window's logits agree within 1e-5; tokens, ``emit``,
``lengths``, ``last_token`` and ``done`` are equal.  ``_ngram_propose``
equals JAX's on seeded histories.  The engine's greedy tokens with
speculation on equal those with it off, the JAX engine's (speculating,
one request at a time) and ``generate()``'s on the mixed workload of
tests/test_lm_serving.py's speculative tests, with slot reuse, at
``decode_rounds`` 1 and 8, with drafts accepted and ``compiled_programs()``
equal to JAX's.  The throughput gate is timing-based, so its margin is
zeroed in both packages where acceptance is asserted, as the JAX tests
do: identity is what is under test."""

import dataclasses
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import kubeflow_tpu.serving.engine as jax_engine_mod
import kubeflow_tpu_torch.serving.engine as engine_mod
from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving.engine import DecodeEngine

SEED = 20261018
VOCAB, NEW_TOKENS, K = 128, 12, 4
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}
TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS, NB, BT, MB, W = 4, 32, 4, 8, 4
INTS = ("lengths", "stop_len", "last_token", "done")
WAIT_S = 60
# The engine geometry of tests/test_lm_serving.py's speculative tests.
GEOMETRY = dict(slots=2, prefill_len=16, prefill_chunk_tokens=8,
                kv_block_tokens=4)


@pytest.fixture(scope="module")
def spec():
    jcfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    variables = JaxTransformer(jcfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))
    params = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **OVERRIDES),
                    device="meta"),
        params_from_jax(params))
    return dataclasses.make_dataclass(
        "Spec", ["jcfg", "params", "model", "jdecode", "decode"])(
        jcfg, jax.device_put(params), model,
        jgen.DecodeConfig(max_new_tokens=NEW_TOKENS),
        pgen.DecodeConfig(max_new_tokens=NEW_TOKENS))


def _continuation(spec, prompt, decode=None):
    """The port's greedy generate() continuation of ``prompt``."""
    out, _ = pgen.generate(spec.model, torch.tensor([prompt]),
                           decode or spec.decode)
    return out[0, len(prompt):].tolist()


class Pair:
    """One JAX paged state and one port state, driven side by side."""

    def __init__(self, spec, **decode_kw):
        decode_kw.setdefault("max_new_tokens", NEW_TOKENS)
        self.spec = spec
        self.jdecode = jgen.DecodeConfig(**decode_kw)
        self.decode = pgen.DecodeConfig(**decode_kw)
        self.js = jgen.init_paged_state(spec.jcfg, SLOTS, NB, BT)
        self.ps = pgen.init_paged_state(spec.model.cfg, SLOTS, NB, BT,
                                        device="cpu")
        self.tables = np.full((SLOTS, MB), NB, np.int32)

    def prefill(self, slot, prompt, new):
        self.tables[slot] = np.arange(slot * MB, (slot + 1) * MB)
        for start in range(0, len(prompt), W):
            chunk = np.zeros((1, W), np.int32)
            seg = np.asarray(prompt[start:start + W], np.int32)
            chunk[0, :seg.shape[0]] = seg
            row = self.tables[slot:slot + 1]
            self.js, _ = jgen.prefill_chunk_into_slot(
                self.spec.jcfg, self.spec.params, self.js, self.jdecode,
                jnp.asarray(chunk), np.int32(start), np.int32(len(prompt)),
                np.int32(new), np.int32(slot), np.int32(0),
                jnp.asarray(row))
            with torch.inference_mode():
                self.ps, _ = pgen.prefill_chunk_into_slot(
                    self.spec.model, self.ps, self.decode,
                    torch.from_numpy(chunk), start, len(prompt), new, slot,
                    0, torch.from_numpy(row))

    def window_logits(self, draft):
        """Both packages' paged forward of the verify window on copies of
        the pools."""
        tokens = np.concatenate(
            [np.asarray(self.js["last_token"])[:, None], draft], axis=1)
        lengths = np.array(self.js["lengths"])
        jl, _ = jgen._forward_with_cache(
            self.spec.jcfg, self.spec.params, jnp.asarray(tokens),
            (jnp.array(self.js["cache_k"]), jnp.array(self.js["cache_v"])),
            jnp.asarray(lengths), tables=jnp.asarray(self.tables))
        scratch = pgen.init_paged_state(self.spec.model.cfg, SLOTS, NB, BT,
                                        device="cpu")
        for name in ("cache_k", "cache_v"):
            scratch[name].copy_(self.ps[name])
        with torch.inference_mode():
            pl = pgen._forward_with_cache(
                self.spec.model, torch.from_numpy(tokens).long(),
                (scratch["cache_k"], scratch["cache_v"]),
                torch.from_numpy(lengths), tables=torch.from_numpy(
                    self.tables))
        return np.asarray(jl), pl.numpy()

    def verify(self, draft, draft_len):
        # A slot with no page reads what each package reads past the
        # pool (JAX clamps, the port reads its scratch block): only rows
        # with pages are compared.
        jl, pl = self.window_logits(draft)
        paged = (self.tables < NB).any(axis=1)
        np.testing.assert_allclose(pl[paged], jl[paged], **TOL)
        self.js, jt, je = jgen.verify_step(
            self.spec.jcfg, self.spec.params, self.js, self.jdecode, K,
            jnp.asarray(draft), jnp.asarray(draft_len),
            jnp.asarray(self.tables))
        with torch.inference_mode():
            self.ps, pt, pe = pgen.verify_step(
                self.spec.model, self.ps, self.decode, K,
                torch.from_numpy(draft), torch.from_numpy(draft_len),
                torch.from_numpy(self.tables))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
        assert pt.dtype == pe.dtype == torch.int32
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(
                self.ps[name].numpy(), np.asarray(self.js[name]),
                err_msg=name, **TOL)
        for name in INTS:
            np.testing.assert_array_equal(
                self.ps[name].numpy(), np.asarray(self.js[name]),
                err_msg=name)
        return pt.numpy(), pe.numpy()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n).tolist()


def test_verify_step_mixed_drafts_match_jax(spec):
    """Slot 0 drafts the true continuation (full accept), slot 1 its
    shift by one (full rejection), slot 2 the true one past its budget
    (clipped), slot 3 is retired; then a second call drafts slot 1's
    true continuation over the rejected columns, slot 0 undrafted."""
    pair = Pair(spec)
    prompts = [_prompt(n, 10 + n) for n in (6, 9, 5)]
    for slot, (prompt, new) in enumerate(zip(prompts, (12, 12, 3))):
        pair.prefill(slot, prompt, new)
    conts = [_continuation(spec, p) for p in prompts]
    draft = np.zeros((SLOTS, K), np.int32)
    draft[0] = conts[0][1:1 + K]
    draft[1, :3] = (np.asarray(conts[1][1:4]) + 1) % VOCAB
    draft[2] = conts[2][1:1 + K]
    draft[3] = 7                        # a retired slot's garbage
    toks, emit = pair.verify(draft, np.asarray([K, 3, K, 2], np.int32))
    assert emit.tolist() == [K + 1, 1, 2, 0]
    assert toks[0].tolist() == conts[0][1:2 + K]
    assert toks[1].tolist() == [conts[1][1]] + [0] * K
    assert toks[2, :2].tolist() == conts[2][1:3]
    assert not toks[3].any()
    assert pair.ps["done"].tolist() == [False, False, True, True]
    draft = np.zeros((SLOTS, K), np.int32)
    draft[1] = conts[1][2:2 + K]
    toks, emit = pair.verify(draft, np.asarray([0, K, 0, 0], np.int32))
    assert emit.tolist() == [1, K + 1, 0, 0]
    assert toks[0, 0] == conts[0][K + 2]
    assert toks[1].tolist() == conts[1][2:3 + K]


def test_verify_step_eos_inside_an_accepted_window(spec):
    prompt = eos = idx = cont = None
    for seed in range(32):
        cand = _prompt(8, 100 + seed)
        cont = _continuation(spec, cand)
        # A token first emitted at index >= 2 of the window (the window
        # starts at cont[1], so index 0 is the pending last token).
        idx = next((i for i in range(3, K + 1)
                    if cont[i] not in cont[:i]), None)
        if idx is not None:
            prompt, eos = cand, cont[idx]
            break
    assert prompt is not None, "no prompt with a usable mid-window EOS"
    pair = Pair(spec, eos_token=eos)
    pair.prefill(0, prompt, NEW_TOKENS)
    draft = np.zeros((SLOTS, K), np.int32)
    draft[0] = cont[1:1 + K]
    toks, emit = pair.verify(draft, np.asarray([K, 0, 0, 0], np.int32))
    assert emit[0] == idx and toks[0, idx - 1] == eos
    assert not toks[0, idx:].any()
    assert bool(pair.ps["done"][0])


def _histories():
    """Periodic, random and too-short histories (>= 200 of them)."""
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(240):
        kind = i % 4
        if kind == 0:
            period = rng.integers(1, 6)
            pat = rng.integers(1, 9, period)
            n = int(rng.integers(period, 40))
            out.append(np.resize(pat, n))
        elif kind == 1:
            out.append(rng.integers(1, 6, int(rng.integers(3, 40))))
        elif kind == 2:
            out.append(rng.integers(1, VOCAB, int(rng.integers(3, 40))))
        else:
            out.append(rng.integers(1, 4, int(rng.integers(0, 3))))
    return [h.astype(np.int32) for h in out]


@pytest.mark.parametrize("k,nmax,nmin", [(4, 4, 2), (1, 4, 2), (6, 3, 1)])
def test_ngram_propose_matches_jax(k, nmax, nmin):
    hits = 0
    for history in _histories():
        want = jax_engine_mod._ngram_propose(history, k, nmax, nmin)
        got = engine_mod._ngram_propose(history, k, nmax, nmin)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        hits += bool(want.size)
    assert 20 < hits < 240


def _mixed_workload():
    """tests/test_lm_serving.py's speculative workload: pattern-tiled
    prompts (the drafter predicts them) between random ones."""
    rng = np.random.RandomState(SEED + 21)
    prompts, news = [], []
    for i in range(8):
        if i % 2 == 0:
            prompts.append(np.tile(rng.randint(1, VOCAB, size=(4,)),
                                   3).tolist())
        else:
            prompts.append(rng.randint(1, VOCAB, size=(10,)).tolist())
        news.append([12, 8, 10, 6][i % 4])
    return prompts, news


def _serve(engine, prompts, news, extra=None):
    outs = [None] * len(prompts)

    def client(i):
        inputs = {"tokens": np.asarray(prompts[i], np.int32),
                  "max_new_tokens": news[i], **(extra or {})}
        try:
            outs[i] = np.asarray(engine.submit(inputs)["tokens"])[0].tolist()
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


def _port_run(spec, prompts, news, decode=None, **kw):
    engine = DecodeEngine(spec.model, decode or spec.decode,
                          name=f"spec-port-{kw.get('speculative_tokens')}",
                          **kw)
    try:
        return (_serve(engine, prompts, news), engine.stats(),
                engine.compiled_programs())
    finally:
        engine.close()


def _sequential(engine, prompts, news):
    """Each request alone, in order: rows, stats and compiled_programs()
    then follow from the requests, not from thread timing."""
    try:
        rows = [np.asarray(engine.submit({
            "tokens": np.asarray(p, np.int32),
            "max_new_tokens": n})["tokens"])[0].tolist()
            for p, n in zip(prompts, news)]
        return rows, engine.stats(), engine.compiled_programs()
    finally:
        engine.close()


@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_engine_spec_on_off_jax_and_generate_agree(spec, decode_rounds,
                                                   monkeypatch):
    """Concurrent, the port's engine speculates (drafts accepted) and
    equals itself with speculation off and generate(); one request at a
    time, it equals the JAX engine's rows and compiled_programs() under
    the same flags (in fused mode neither then finds a draft that
    outlives its round)."""
    monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    monkeypatch.setattr(jax_engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    prompts, news = _mixed_workload()
    want = [p + _continuation(spec, p)[:n] for p, n in zip(prompts, news)]
    flags = dict(speculative_tokens=K, decode_rounds=decode_rounds,
                 **GEOMETRY)
    on, on_stats, on_programs = _port_run(spec, prompts, news, **flags)
    off, off_stats, _ = _port_run(spec, prompts, news,
                                  **dict(flags, speculative_tokens=0))
    alone, _, alone_programs = _sequential(
        DecodeEngine(spec.model, spec.decode, name="spec-alone", **flags),
        prompts, news)
    twin, _, jax_programs = _sequential(
        jax_engine_mod.DecodeEngine(spec.jcfg, spec.params, spec.jdecode,
                                    name="spec-jax", **flags),
        prompts, news)
    for i in range(len(prompts)):
        assert on[i] == want[i], f"spec ON drifted on request {i}"
        assert off[i] == want[i], f"spec OFF drifted on request {i}"
        assert alone[i] == want[i], f"spec ON alone drifted on request {i}"
        assert twin[i] == want[i], f"JAX's engine drifted on request {i}"
    assert on_stats["spec_steps"] > 0
    assert 0 < on_stats["spec_accepted"] <= on_stats["spec_drafted"]
    assert 0 < on_stats["spec_acceptance_rate"] <= 1
    assert on_stats["accepted_per_step"] > 0
    assert off_stats["spec_drafted"] == off_stats["spec_steps"] == 0
    assert alone_programs == jax_programs
    assert on_programs == dict(jax_programs, verify=1)
    assert on_stats["active_slots"] == on_stats["in_flight_requests"] == 0


def test_forced_full_rejection_rolls_back_through_slot_reuse(spec,
                                                             monkeypatch):
    """An always-wrong drafter: every draft rejects, and one slot serves
    three requests; the rolled-back columns never reach a later token."""
    monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    rng = np.random.RandomState(SEED + 23)
    pat = rng.randint(1, VOCAB, size=(4,))
    prompts = [np.tile(pat, 3).tolist(),
               rng.randint(1, VOCAB, size=(9,)).tolist(),
               np.tile(pat, 3).tolist()]
    news = [12, 10, 12]
    want = [p + _continuation(spec, p)[:n] for p, n in zip(prompts, news)]

    def always_wrong(history, k, *a, **kw):
        hist = history.tolist()
        for prompt, ref in zip(prompts, want):
            if hist[:len(prompt)] == prompt:
                at = len(hist)
                nxt = np.asarray(ref[at:at + k], np.int64)
                return ((nxt + 1) % VOCAB).astype(np.int32)
        return np.empty((0,), np.int32)

    monkeypatch.setattr(engine_mod, "_ngram_propose", always_wrong)
    engine = DecodeEngine(spec.model, spec.decode, speculative_tokens=K,
                          name="spec-reject", **dict(GEOMETRY, slots=1))
    try:
        got = [np.asarray(engine.submit({
            "tokens": np.asarray(p, np.int32),
            "max_new_tokens": n})["tokens"])[0].tolist()
            for p, n in zip(prompts, news)]
        stats = engine.stats()
    finally:
        engine.close()
    assert got == want
    assert stats["spec_drafted"] > 0 and stats["spec_accepted"] == 0


def test_engine_eos_inside_an_accepted_window(spec, monkeypatch):
    """An oracle drafter makes the window accept through EOS: the emission
    is cut at EOS, the slot frozen, and the next request reuses it."""
    monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    prompt = eos = idx = cont = None
    for seed in range(32):
        cand = _prompt(10, 300 + seed)
        cont = _continuation(spec, cand)
        idx = next((i for i in range(2, len(cont))
                    if cont[i] not in cont[:i]), None)
        if idx is not None:
            prompt, eos = cand, cont[idx]
            break
    assert prompt is not None
    decode = dataclasses.replace(spec.decode, eos_token=eos)

    def oracle(history, k, *a, **kw):
        at = len(history) - len(prompt)
        return np.asarray(cont[at:at + k], np.int32)

    monkeypatch.setattr(engine_mod, "_ngram_propose", oracle)
    engine = DecodeEngine(spec.model, decode, speculative_tokens=K,
                          name="spec-eos", **dict(GEOMETRY, slots=1))
    try:
        for _ in range(2):
            got = np.asarray(engine.submit(
                {"tokens": np.asarray(prompt, np.int32)})["tokens"])[0]
            assert got[len(prompt):].tolist() == cont[:idx + 1]
        assert engine.stats()["spec_accepted"] > 0
    finally:
        engine.close()


def test_resume_inside_a_speculative_window(spec, monkeypatch):
    """A resume whose delivered tokens end inside what a verify window
    covered continues with exactly the uninterrupted run's suffix."""
    monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    prompts, news = _mixed_workload()
    prompt = prompts[0]
    full = prompt + _continuation(spec, prompt)
    engine = DecodeEngine(spec.model, spec.decode, speculative_tokens=K,
                          name="spec-resume", **GEOMETRY)
    try:
        first = engine.submit({"tokens": np.asarray(prompt, np.int32)})
        assert np.asarray(first["tokens"])[0].tolist() == full
        assert engine.stats()["spec_accepted"] > 0
        for cut in (1, 2, 3, 4):
            out = engine.submit({
                "tokens": np.asarray(prompt, np.int32),
                "resume_tokens": full[len(prompt):len(prompt) + cut]})
            assert np.asarray(out["tokens"])[0].tolist() == full, cut
    finally:
        engine.close()


def test_sampling_export_disables_speculation(spec, caplog):
    decode = dataclasses.replace(spec.decode, temperature=0.7)
    with caplog.at_level(logging.WARNING):
        engine = DecodeEngine(spec.model, decode, speculative_tokens=K,
                              name="spec-sampled", **GEOMETRY)
    try:
        assert engine.speculative_tokens == 0 and engine.sync_lag == 2
        assert "greedy-only" in caplog.text
        out = _serve(engine, [[1, 2, 3, 4, 1, 2, 3, 4]], [6])[0]
        assert len(out) == 14
        stats = engine.stats()
        assert stats["spec_drafted"] == stats["spec_steps"] == 0
        assert engine.compiled_programs()["verify"] == 0
    finally:
        engine.close()
    # The width is also clamped to the budget less the free token.
    short = dataclasses.replace(spec.decode, max_new_tokens=3)
    engine = DecodeEngine(spec.model, short, speculative_tokens=8,
                          name="spec-clamped", **GEOMETRY)
    try:
        assert engine.speculative_tokens == 2 and engine.sync_lag == 0
    finally:
        engine.close()
