"""The port's int8 KV pool and int8 weights on the engine path against
the JAX package's.

The paged slot programs (``prefill_chunk_into_slot``, ``decode_step``,
``decode_rounds``, ``verify_step``) run over an int8 pool in both
packages from the same weights and block tables at float32 on the CPU:
the pools' int8 values are equal, their scales and the paged logits
within 1e-5, the integer state equal.  The ``DecodeEngine`` with int8
weights and an int8 pool gives the greedy tokens of the JAX engine (one
request at a time) and of the port's own int8 ``generate()``, at
``decode_rounds`` 1 and 8 with the prefix cache resuming, and with
speculation on; ``compiled_programs()`` equals JAX's.  An int8 pool's
handoff (``{"values", "scale"}`` sides) is byte-equal on the wire both
ways between the packages and resumes to the unified tokens; a pool of
one kind refuses a payload of the other."""

import json
import threading
from types import SimpleNamespace

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
from kubeflow_tpu.ops import quantize as jq
from kubeflow_tpu.serving import http as jhttp
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.ops import quantize as pq
from kubeflow_tpu_torch.serving import http as phttp
from kubeflow_tpu_torch.serving.engine import DecodeEngine

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

SEED = 20261020
VOCAB, NEW_TOKENS, K = 128, 10, 4
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}
TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS, NB, BT, MB, W = 3, 24, 4, 8, 4
INTS = ("lengths", "stop_len", "last_token", "done")
GEOMETRY = dict(slots=2, prefill_len=16, prefill_chunk_tokens=8,
                kv_block_tokens=BT)
WAIT_S = 60


@pytest.fixture(scope="module")
def spec():
    """One weight tree: its float32 models (for the programs) and its
    int8-weight models (for the engines) in both packages."""
    jcfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    variables = JaxTransformer(jcfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))
    tree = jax.tree.map(np.asarray, nn.unbox(variables)["params"])
    cfg = TransformerConfig(dtype=torch.float32, **OVERRIDES)

    def port(params):
        return load_params(Transformer(cfg, device="meta"), params)

    return SimpleNamespace(
        jcfg=jcfg, tree=jax.device_put(tree),
        jtree_q=jq.quantize_params(tree),
        model=port(params_from_jax(tree)),
        model_q=port(pq.quantize_params(params_from_jax(tree))),
        jdecode=jgen.DecodeConfig(max_new_tokens=NEW_TOKENS,
                                  kv_cache_dtype="int8"),
        decode=pgen.DecodeConfig(max_new_tokens=NEW_TOKENS,
                                 kv_cache_dtype="int8"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n).tolist()


# -- the paged slot programs on an int8 pool ---------------------------------

class Pair:
    """One JAX int8 paged state and one port state, stepped side by side
    (float32 weights)."""

    def __init__(self, spec):
        self.spec = spec
        self.js = jgen.init_paged_state(spec.jcfg, SLOTS, NB, BT, "int8")
        self.ps = pgen.init_paged_state(spec.model.cfg, SLOTS, NB, BT,
                                        "int8", device="cpu")
        self.tables = np.full((SLOTS, MB), NB, np.int32)

    def prefill(self, slot, prompt, new):
        self.tables[slot] = np.arange(slot * MB, (slot + 1) * MB)
        for start in range(0, len(prompt), W):
            chunk = np.zeros((1, W), np.int32)
            seg = np.asarray(prompt[start:start + W], np.int32)
            chunk[0, :seg.shape[0]] = seg
            row = self.tables[slot:slot + 1]
            self.js, jtok = jgen.prefill_chunk_into_slot(
                self.spec.jcfg, self.spec.tree, self.js, self.spec.jdecode,
                jnp.asarray(chunk), np.int32(start), np.int32(len(prompt)),
                np.int32(new), np.int32(slot), np.int32(0),
                jnp.asarray(row))
            with torch.inference_mode():
                self.ps, ptok = pgen.prefill_chunk_into_slot(
                    self.spec.model, self.ps, self.spec.decode,
                    torch.from_numpy(chunk), start, len(prompt), new, slot,
                    0, torch.from_numpy(row))
            np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        self.check()

    def check(self):
        for name in ("cache_k", "cache_v"):
            got, want = self.ps[name], self.js[name]
            assert isinstance(got, pq.QTensor)
            assert got.values.dtype == torch.int8
            np.testing.assert_array_equal(
                got.values.numpy(), np.asarray(want.values), err_msg=name)
            np.testing.assert_allclose(
                got.scale.numpy(), np.asarray(want.scale), err_msg=name,
                **TOL)
        for name in INTS:
            np.testing.assert_array_equal(
                self.ps[name].numpy(), np.asarray(self.js[name]),
                err_msg=name)

    def logits(self, tokens):
        """Both packages' paged forward at the slots' frontiers on copies
        of the pools; rows with pages only (a page-less row reads what
        each package reads past the pool)."""
        tokens = np.asarray(tokens, np.int32)
        lengths = np.array(self.js["lengths"])
        copy = (jax.tree.map(jnp.array, self.js["cache_k"]),
                jax.tree.map(jnp.array, self.js["cache_v"]))
        jl, _ = jgen._forward_with_cache(
            self.spec.jcfg, self.spec.tree, jnp.asarray(tokens), copy,
            jnp.asarray(lengths), tables=jnp.asarray(self.tables))
        scratch = pgen.init_paged_state(self.spec.model.cfg, SLOTS, NB, BT,
                                        "int8", device="cpu")
        for name in ("cache_k", "cache_v"):
            scratch[name].values.copy_(self.ps[name].values)
            scratch[name].scale.copy_(self.ps[name].scale)
        with torch.inference_mode():
            pl = pgen._forward_with_cache(
                self.spec.model, torch.tensor(tokens).long(),
                (scratch["cache_k"], scratch["cache_v"]),
                torch.from_numpy(lengths),
                tables=torch.from_numpy(self.tables))
        paged = (self.tables < NB).any(axis=1)
        np.testing.assert_allclose(pl.numpy()[paged], np.asarray(jl)[paged],
                                   **TOL)


def test_int8_state_matches_jax_layout(spec):
    js = jgen.init_paged_state(spec.jcfg, SLOTS, NB, BT, "int8")
    ps = pgen.init_paged_state(spec.model.cfg, SLOTS, NB, BT, "int8",
                               device="cpu")
    for name in ("cache_k", "cache_v"):
        for part in ("values", "scale"):
            got, want = getattr(ps[name], part), getattr(js[name], part)
            assert tuple(got.shape) == tuple(want.shape)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
        # The scratch block lies past the view, for scales as for values.
        full = pgen._pool_with_scratch(ps[name])
        assert full.values.shape[1] == full.scale.shape[1] == NB + 1
        assert full.scale.data_ptr() == ps[name].scale.data_ptr()


def test_int8_slot_programs_match_jax(spec):
    """Three slots prefill over several chunks, then two decode steps, a
    round of up to 4 and a verify call with mixed drafts, each against
    JAX's program on the same pool."""
    pair = Pair(spec)
    prompts = [_prompt(n, 30 + n) for n in (7, 11, 5)]
    for slot, (prompt, new) in enumerate(zip(prompts, (10, 10, 3))):
        pair.prefill(slot, prompt, new)
    pair.logits(np.asarray(pair.js["last_token"])[:, None])
    pair.js, jt = jgen.decode_step(spec.jcfg, spec.tree, pair.js,
                                   spec.jdecode, 2, jnp.asarray(pair.tables))
    with torch.inference_mode():
        pair.ps, pt = pgen.decode_step(spec.model, pair.ps, spec.decode, 2,
                                       torch.from_numpy(pair.tables))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    pair.check()
    pair.js, jt, jc, jn = jgen.decode_rounds(
        spec.jcfg, spec.tree, pair.js, spec.jdecode, 4,
        jnp.asarray(pair.tables), np.int32(3))
    with torch.inference_mode():
        pair.ps, pt, pc, pn = pgen.decode_rounds(
            spec.model, pair.ps, spec.decode, 4,
            torch.from_numpy(pair.tables), 3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert int(pn) == int(jn)
    pair.check()
    # Verify: slot 0 drafts its own greedy continuation, slot 1 a wrong
    # one; slot 2 is done (budget 3).
    cont, _ = pgen.generate(spec.model, torch.tensor(
        [prompts[0] + pt[0, :int(pc[0])].tolist()]), spec.decode)
    draft = np.zeros((SLOTS, K), np.int32)
    draft[0] = cont[0, -NEW_TOKENS + 1:][:K].numpy()
    draft[1] = 5
    draft_len = np.asarray([K, 2, 1], np.int32)
    pair.logits(np.concatenate(
        [np.asarray(pair.js["last_token"])[:, None], draft], axis=1))
    pair.js, jt, je = jgen.verify_step(
        spec.jcfg, spec.tree, pair.js, spec.jdecode, K, jnp.asarray(draft),
        jnp.asarray(draft_len), jnp.asarray(pair.tables))
    with torch.inference_mode():
        pair.ps, pt, pe = pgen.verify_step(
            spec.model, pair.ps, spec.decode, K, torch.from_numpy(draft),
            torch.from_numpy(draft_len), torch.from_numpy(pair.tables))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    assert int(pe[2]) == 0
    pair.check()


def test_int8_pages_import_and_gather_match_jax(spec):
    js = jgen.init_paged_state(spec.jcfg, 1, 10, BT, "int8")
    ps = pgen.init_paged_state(spec.model.cfg, 1, 10, BT, "int8",
                               device="cpu")
    rng = np.random.default_rng(4)
    shape = (2, 4, BT, 2, 8)
    vals = [rng.integers(-127, 128, shape).astype(np.int8) for _ in "kv"]
    scales = [rng.random(shape[:-1]).astype(np.float32) for _ in "kv"]
    ids = np.asarray([6, 1, 10, 10], np.int32)   # two pages, then padding
    js = jgen.import_kv_pages(
        js, *[jq.QTensor(jnp.asarray(v), jnp.asarray(s), (-1,))
              for v, s in zip(vals, scales)], jnp.asarray(ids))
    pgen.import_kv_pages(
        ps, *[pq.QTensor(torch.from_numpy(v), torch.from_numpy(s), (-1,))
              for v, s in zip(vals, scales)], torch.from_numpy(ids))
    for name in ("cache_k", "cache_v"):
        np.testing.assert_array_equal(ps[name].values.numpy(),
                                      np.asarray(js[name].values))
        np.testing.assert_array_equal(ps[name].scale.numpy(),
                                      np.asarray(js[name].scale))
    # The padding's pages landed on the scratch block, scales included.
    full = pgen._pool_with_scratch(ps["cache_k"])
    assert torch.equal(full.scale[:, 10], torch.from_numpy(scales[0][:, 3]))
    jpages = jgen.gather_kv_pages(js, [1, 6])
    ppages = pgen.gather_kv_pages(ps, [1, 6])
    for (jv, jsc), (pv, psc) in zip(jpages, ppages):
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(psc.numpy(), jsc)


# -- the engine ---------------------------------------------------------------

def _mixed_workload():
    """Tiled prompts (the drafter predicts them) between random ones; the
    second extends the first (a prefix-cache hit when they come in
    turn)."""
    rng = np.random.RandomState(SEED + 1)
    prompts, news = [], []
    for i in range(6):
        if i % 2 == 0:
            prompts.append(np.tile(rng.randint(1, VOCAB, size=(4,)),
                                   3).tolist())
        else:
            prompts.append(rng.randint(1, VOCAB, size=(9,)).tolist())
        news.append([10, 6, 8, 5][i % 4])
    prompts.insert(1, prompts[0] + [7])
    news.insert(1, 7)
    return prompts, news


def _serve(engine, prompts, news):
    outs = [None] * len(prompts)

    def client(i):
        try:
            outs[i] = np.asarray(engine.submit({
                "tokens": np.asarray(prompts[i], np.int32),
                "max_new_tokens": news[i]})["tokens"])[0].tolist()
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


def _sequential(engine, prompts, news):
    try:
        rows = [np.asarray(engine.submit({
            "tokens": np.asarray(p, np.int32),
            "max_new_tokens": n})["tokens"])[0].tolist()
            for p, n in zip(prompts, news)]
        return rows, engine.stats(), engine.compiled_programs()
    finally:
        engine.close()


@pytest.mark.parametrize("spec_tokens", [0, K], ids=["plain", "speculating"])
@pytest.mark.parametrize("decode_rounds", [1, 8])
def test_int8_engine_matches_jax_and_generate(spec, decode_rounds,
                                              spec_tokens, monkeypatch):
    """int8 weights over an int8 pool: the port's engine, concurrent and
    one request at a time, gives its int8 generate()'s tokens and the
    JAX engine's; compiled_programs() one at a time equals JAX's."""
    monkeypatch.setattr(engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    monkeypatch.setattr(jax_engine_mod, "_SPEC_RATE_MARGIN", 0.0)
    prompts, news = _mixed_workload()
    want = []
    for p, n in zip(prompts, news):
        out, _ = pgen.generate(spec.model_q, torch.tensor([p]), spec.decode)
        want.append(p + out[0, len(p):len(p) + n].tolist())
    flags = dict(decode_rounds=decode_rounds,
                 speculative_tokens=spec_tokens, **GEOMETRY)
    engine = DecodeEngine(spec.model_q, spec.decode, name="int8-port",
                          **flags)
    try:
        got = _serve(engine, prompts, news)
        stats = engine.stats()
    finally:
        engine.close()
    alone, alone_stats, programs = _sequential(
        DecodeEngine(spec.model_q, spec.decode, name="int8-alone", **flags),
        prompts, news)
    twin, _, jax_programs = _sequential(
        jax_engine_mod.DecodeEngine(spec.jcfg, spec.jtree_q, spec.jdecode,
                                    name="int8-jax", **flags),
        prompts, news)
    for i in range(len(prompts)):
        assert got[i] == want[i], f"request {i} drifted from generate()"
        assert alone[i] == want[i], f"request {i} drifted alone"
        assert twin[i] == want[i], f"JAX's engine drifted on request {i}"
    assert programs == jax_programs
    assert alone_stats["prefix_hits"] >= 1
    if spec_tokens:
        assert stats["spec_steps"] > 0 and stats["spec_accepted"] > 0
    assert stats["active_slots"] == stats["in_flight_requests"] == 0


def _tokens(out):
    return np.asarray(out["tokens"])[0].tolist()


def _closing(engine, fn):
    try:
        return fn(engine)
    finally:
        engine.close()


def _wire_json(encode, payload):
    return json.dumps(encode(payload), sort_keys=False)


def test_int8_handoff_wire_is_byte_equal_both_ways(spec):
    prompt = _prompt(14, 8)
    tokens = np.asarray(prompt, np.int32)
    pout = _closing(DecodeEngine(spec.model_q, spec.decode, name="int8-pre",
                                 **GEOMETRY),
                    lambda e: e.prefill_export({"tokens": tokens}))
    jout = _closing(jax_engine_mod.DecodeEngine(
        spec.jcfg, spec.jtree_q, spec.jdecode, name="int8-jpre",
        **GEOMETRY), lambda e: e.prefill_export({"tokens": tokens}))
    unified = _closing(DecodeEngine(spec.model_q, spec.decode,
                                    name="int8-uni", **GEOMETRY),
                       lambda e: _tokens(e.submit({"tokens": tokens})))
    ho = pout["kv_handoff"]
    assert set(ho["k"]) == {"values", "scale"}
    assert ho["k"]["values"].dtype == torch.int8
    assert tuple(ho["k"]["scale"].shape) == (2, 3, BT, 2)
    for side in ("k", "v"):
        np.testing.assert_array_equal(
            ho[side]["values"].numpy(), jout["kv_handoff"][side]["values"])
    # JAX -> port: decoded and re-encoded to the same bytes, imported
    # into an int8 pool, the unified tokens.
    wire = _wire_json(jhttp.encode_kv_handoff, jout["kv_handoff"])
    payload = phttp.decode_kv_handoff(json.loads(wire))
    assert _wire_json(phttp.encode_kv_handoff, dict(
        payload, tokens_covered=jout["kv_handoff"]["tokens_covered"])) == wire

    def decode(engine):
        got = _tokens(engine.submit({"tokens": tokens,
                                     "kv_handoff": payload}))
        return got, pgen.gather_kv_pages(engine._state,
                                         engine._tables[0][:3])

    got, (k, v) = _closing(DecodeEngine(
        spec.model_q, spec.decode, slots=1, prefill_len=16,
        prefill_chunk_tokens=8, kv_block_tokens=BT, prefix_caching=False,
        name="int8-dec"), decode)
    assert torch.equal(k[0], payload["k"]["values"])
    assert torch.equal(k[1], payload["k"]["scale"])
    assert torch.equal(v[1], payload["v"]["scale"])
    assert got == unified
    # Port -> JAX: the same, the other way.
    wire = _wire_json(phttp.encode_kv_handoff, ho)
    jpayload = jhttp.decode_kv_handoff(json.loads(wire))
    assert str(jpayload["k"]["values"].dtype) == "int8"
    assert _wire_json(jhttp.encode_kv_handoff, dict(
        jpayload, tokens_covered=ho["tokens_covered"])) == wire
    jgot = _closing(jax_engine_mod.DecodeEngine(
        spec.jcfg, spec.jtree_q, spec.jdecode, prefix_caching=False,
        name="int8-jdec", **GEOMETRY), lambda e: _tokens(e.submit(
            {"tokens": tokens, "kv_handoff": jpayload})))
    assert jgot == unified


def test_pools_refuse_a_payload_of_the_other_kind(spec):
    tokens = np.asarray(_prompt(13, 9), np.int32)
    int8_ho = _closing(DecodeEngine(spec.model_q, spec.decode,
                                    name="int8-kind", **GEOMETRY),
                       lambda e: e.prefill_export({"tokens": tokens})
                       )["kv_handoff"]
    fp_decode = pgen.DecodeConfig(max_new_tokens=NEW_TOKENS)
    fp_ho = _closing(DecodeEngine(spec.model, fp_decode, name="fp-kind",
                                  **GEOMETRY),
                     lambda e: e.prefill_export({"tokens": tokens})
                     )["kv_handoff"]
    engine = DecodeEngine(spec.model, fp_decode, name="fp-refuses",
                          **GEOMETRY)
    try:
        with pytest.raises(ValueError, match="got a quantized payload"):
            engine.submit({"tokens": tokens, "kv_handoff": int8_ho})
    finally:
        engine.close()
    engine = DecodeEngine(spec.model_q, spec.decode, name="int8-refuses",
                          **GEOMETRY)
    try:
        with pytest.raises(ValueError, match="payload needs values"):
            engine.submit({"tokens": tokens, "kv_handoff": fp_ho})
        bad = dict(int8_ho, k=dict(int8_ho["k"],
                                   scale=int8_ho["k"]["scale"][..., :1]))
        with pytest.raises(ValueError, match="minus the trailing dim"):
            engine.submit({"tokens": tokens, "kv_handoff": bad})
    finally:
        engine.close()
