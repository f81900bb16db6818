"""The port's host spill tier (session park, pressure spill, re-import,
``fetch_kv``) against the JAX package's: twins of tests/test_kv_spill.py
on the port's ``DecodeEngine``, on the same tiny LM (the JAX weights
carried across with ``params_from_jax``) at float32 on the CPU, with the
JAX package's ``generate()`` as the reference.

  - pool pressure spills idle records instead of destroy-evicting them,
    nothing sheds, and every parked session's second turn re-imports its
    pages and gives the reference's tokens;
  - re-import runs fewer prefill chunks than the cold prefill;
  - the ``engine.spill`` fault at re-import sheds a typed 429 with no page
    leaked in either tier, and at spill-out degrades gracefully;
  - a ``fetch_kv`` payload, through the wire codec, resumes on a peer
    bit-identically; a miss is clean; ``engine.fetch`` fires; the gauges
    read 0 after close.

Across the packages: a payload from the JAX engine's ``fetch_kv`` resumes
on the port's engine and the reverse, at float32 and with int8 pools,
with the reference's tokens; the two engines' ``stats()`` have the same
keys after the same spill run, and equal spill counters."""

import json

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

import kubeflow_tpu.serving.engine as jax_engine_mod
from kubeflow_tpu.models.generate import DecodeConfig as JaxDecode
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving import http as jhttp
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.runtime.prom import REGISTRY
from kubeflow_tpu_torch.serving import http as phttp
from kubeflow_tpu_torch.serving.engine import (
    HOST_TIER_GAUGE,
    KV_SPILLED_GAUGE,
    DecodeEngine,
)
from kubeflow_tpu_torch.serving.errors import Overloaded
from kubeflow_tpu_torch.testing import faults

SEED = 20260807
VOCAB, NEW_TOKENS = 96, 10
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}


@pytest.fixture(scope="module")
def lm():
    """The JAX cfg and params, the port's model over the same weights,
    both decode configs, and reference(prompt) -> the JAX package's full
    greedy token list (prompt + emitted)."""
    cfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    params = jax.tree.map(np.asarray, nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32)))["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **OVERRIDES),
                    device="meta"), params_from_jax(params))
    jdecode = JaxDecode(max_new_tokens=NEW_TOKENS, temperature=0.0)
    decode = pgen.DecodeConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    cache = {}

    def reference(prompt):
        key = np.asarray(prompt, np.int32).tobytes()
        if key not in cache:
            out, _ = jax_generate(cfg, params,
                                  np.asarray(prompt, np.int32)[None],
                                  jdecode)
            cache[key] = np.asarray(out)[0].tolist()
        return cache[key]

    return cfg, params, model, jdecode, decode, reference


GEOMETRY = dict(slots=2, prefill_len=32, prefill_chunk_tokens=8,
                kv_block_tokens=4)


def _engine(lm, **kw):
    _, _, model, _, decode, _ = lm
    return DecodeEngine(model, kw.pop("decode", decode),
                        **dict(GEOMETRY, **kw))


def _jax_engine(lm, **kw):
    cfg, params, _, jdecode, _, _ = lm
    return jax_engine_mod.DecodeEngine(cfg, params, kw.pop("decode", jdecode),
                                       **dict(GEOMETRY, **kw))


def _prompt(n, lo=1):
    rng = np.random.RandomState(SEED + n)
    return rng.randint(lo, VOCAB, size=(n,)).astype(np.int32)


def _drop_device_records(engine):
    """Drop every device prefix record (the tests' stand-in for churn
    having spilled them), so that a resume goes through the host tier."""
    with engine._lock:
        while engine._mgr._lru:
            _, rec = engine._mgr._lru.popitem(last=False)
            engine._mgr._drop_record(rec, count=False)


class TestSpillTier:
    def test_pressure_spills_never_sheds_and_resume_is_identical(self, lm):
        reference = lm[5]
        eng = _engine(lm, kv_pool_blocks=12, host_spill_blocks=48,
                      name="p-spill-core")
        try:
            sessions = []
            for i in range(5):
                p = _prompt(9 + i)
                out = eng.submit({"tokens": p, "park_kv": True})
                turn1 = out["tokens"][0].tolist()
                assert turn1 == reference(p)
                sessions.append((p, turn1))
            st = eng.stats()
            mgr = eng._mgr.stats()
            assert st["shed"] == 0
            assert st["kv_spill_pages_out"] > 0
            assert st["parked_sessions"] == 5
            assert mgr["evictions"] == 0, (
                "destructive eviction while spillable mass existed")
            assert mgr["block_evictions"] == 0
            assert st["host_tier_used"] > 0
            assert st["kv_spill_ratio"] > 0
            assert st["tokens_addressable"] == (12 + 48) * 4
            eng._mgr.check_invariants()
            for p, turn1 in sessions:
                turn2 = np.concatenate(
                    [np.asarray(turn1, np.int32), _prompt(3, lo=90)])
                got = eng.submit({"tokens": turn2})
                assert got["tokens"][0].tolist() == \
                    reference(turn2.tolist()), "resumed turn diverged"
            st = eng.stats()
            assert st["kv_spill_pages_in"] > 0, (
                "no session resumed through the re-import path")
            assert st["shed"] == 0
            assert eng._mgr.stats()["evictions"] == 0
            assert eng.compiled_programs()["kv_import"] == 1
            timing = eng.spill_timing
            assert timing["out_s"] > 0 and timing["in_s"] > 0
            assert 0 < timing["out_pages"] <= st["kv_spill_pages_out"]
            assert timing["in_pages"] == st["kv_spill_pages_in"]
            eng._mgr.check_invariants()
        finally:
            eng.close()

    def test_reimport_skips_prefill_compute(self, lm):
        eng = _engine(lm, kv_pool_blocks=10, host_spill_blocks=32,
                      name="p-spill-ttft")
        cold = _engine(lm, kv_pool_blocks=32, name="p-spill-cold")
        try:
            p = _prompt(16)
            out = eng.submit({"tokens": p, "park_kv": True})
            ctx = out["tokens"][0].tolist()  # 26 tokens
            chunks_before = eng.stats()["prefill_chunks"]
            _drop_device_records(eng)
            got = eng.submit({"tokens": np.asarray(ctx, np.int32)})
            warm_chunks = eng.stats()["prefill_chunks"] - chunks_before
            cold.submit({"tokens": np.asarray(ctx, np.int32)})
            cold_chunks = cold.stats()["prefill_chunks"]
            assert eng.stats()["kv_spill_pages_in"] > 0
            assert warm_chunks < cold_chunks, (
                f"re-import ran {warm_chunks} prefill chunks vs "
                f"{cold_chunks} cold")
            assert got["tokens"][0].tolist() == \
                cold.submit({"tokens": np.asarray(ctx, np.int32)}
                            )["tokens"][0].tolist()
        finally:
            eng.close()
            cold.close()

    def test_spill_in_fault_sheds_typed_429_with_no_leak(self, lm):
        reference = lm[5]
        eng = _engine(lm, kv_pool_blocks=10, host_spill_blocks=32,
                      name="p-spill-fault")
        try:
            p = _prompt(16)
            ctx = eng.submit({"tokens": p, "park_kv": True}
                             )["tokens"][0].tolist()
            _drop_device_records(eng)
            host_before = eng._mgr.host_used_blocks()
            used_before = eng._mgr.used_blocks()
            inj = faults.parse("engine.spill:raise")
            faults.install(inj)
            try:
                with pytest.raises(Overloaded):
                    eng.submit({"tokens": np.asarray(ctx, np.int32)})
            finally:
                faults.install(None)
            assert inj.fired("engine.spill") >= 1
            st = eng.stats()
            assert st["shed"] == 1
            assert eng._mgr.used_blocks() == used_before, (
                "device pages leaked by the shed path")
            assert eng._mgr.host_used_blocks() == host_before, (
                "host pages destroyed by the shed path")
            eng._mgr.check_invariants()
            got = eng.submit({"tokens": np.asarray(ctx, np.int32)})
            assert got["tokens"][0].tolist() == reference(ctx)
            assert eng.stats()["kv_spill_pages_in"] > 0
        finally:
            eng.close()

    def test_spill_out_fault_is_graceful(self, lm):
        reference = lm[5]
        eng = _engine(lm, kv_pool_blocks=12, host_spill_blocks=48,
                      name="p-spill-out-fault")
        try:
            inj = faults.parse("engine.spill:raise")
            faults.install(inj)
            try:
                for i in range(4):
                    p = _prompt(10 + i)
                    got = eng.submit({"tokens": p, "park_kv": True})
                    assert got["tokens"][0].tolist() == reference(p)
            finally:
                faults.install(None)
            st = eng.stats()
            assert st["shed"] == 0
            assert st["kv_spill_pages_out"] == 0  # every spill faulted
            eng._mgr.check_invariants()
        finally:
            eng.close()


class TestFetchResume:
    def test_fetch_payload_resumes_on_a_peer_bit_identical(self, lm):
        reference = lm[5]
        a = _engine(lm, kv_pool_blocks=16, host_spill_blocks=32,
                    name="p-fetch-a")
        b = _engine(lm, kv_pool_blocks=16, host_spill_blocks=32,
                    name="p-fetch-b")
        try:
            p = _prompt(12)
            a.submit({"tokens": p, "park_kv": True})
            want = reference(p)
            delivered = want[len(p):len(p) + 4]
            context = np.asarray(list(p) + delivered, np.int32)
            fetched = a.fetch_kv({"tokens": context})
            assert fetched["tokens_covered"] > 0
            assert a.stats()["kv_fetches"] == 1
            wire = phttp.encode_kv_handoff(fetched["kv_handoff"])
            got = b.submit({
                "tokens": p, "resume_tokens": delivered,
                "kv_handoff": phttp.decode_kv_handoff(
                    json.loads(json.dumps(wire)))})
            assert got["tokens"][0].tolist() == want, (
                "fetch-resume diverged from control")
            assert b.stats()["handoff_pages_in"] > 0
        finally:
            a.close()
            b.close()

    def test_fetch_misses_cleanly(self, lm):
        eng = _engine(lm, kv_pool_blocks=16, host_spill_blocks=16,
                      name="p-fetch-miss")
        try:
            out = eng.fetch_kv({"tokens": _prompt(12)})
            assert out == {"kv_handoff": None, "tokens_covered": 0}
        finally:
            eng.close()

    def test_fetch_fault_site_fires(self, lm):
        eng = _engine(lm, kv_pool_blocks=16, host_spill_blocks=16,
                      name="p-fetch-fault")
        try:
            eng.submit({"tokens": _prompt(12), "park_kv": True})
            inj = faults.parse("engine.fetch:raise")
            faults.install(inj)
            try:
                with pytest.raises(faults.FaultInjected):
                    eng.fetch_kv({"tokens": _prompt(12)})
            finally:
                faults.install(None)
            assert inj.fired("engine.fetch") == 1
        finally:
            eng.close()

    def test_spill_gauges_zeroed_on_close(self, lm):
        name = "p-spill-gauge"
        eng = _engine(lm, kv_pool_blocks=10, host_spill_blocks=32,
                      name=name)
        eng.submit({"tokens": _prompt(16), "park_kv": True})

        def value(gauge):
            return REGISTRY.gauge(gauge).value(engine=name)

        assert value(KV_SPILLED_GAUGE) > 0
        assert value(HOST_TIER_GAUGE) == 32
        eng.close()
        assert value(KV_SPILLED_GAUGE) == 0
        assert value(HOST_TIER_GAUGE) == 0


# -- across the packages ------------------------------------------------------

def _int8(lm):
    """The int8-pool decode configs of both packages."""
    _, _, _, jdecode, decode, _ = lm
    return (JaxDecode(max_new_tokens=NEW_TOKENS, kv_cache_dtype="int8"),
            pgen.DecodeConfig(max_new_tokens=NEW_TOKENS,
                              kv_cache_dtype="int8"))


@pytest.mark.parametrize("pool", ["model", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_fetch_resumes_across_the_packages(lm, pool, direction):
    """A session parked on one package's engine, fetched over the wire
    codec and resumed with ``resume_tokens`` on the other's: the
    exporter's uninterrupted tokens."""
    kw = dict(kv_pool_blocks=16, host_spill_blocks=32)
    if pool == "int8":
        jdecode, decode = _int8(lm)
        jkw, pkw = dict(kw, decode=jdecode), dict(kw, decode=decode)
    else:
        jkw, pkw = dict(kw), dict(kw)
    src, dst = ((_jax_engine(lm, name="x-src", **jkw),
                 _engine(lm, name="x-dst", **pkw))
                if direction == "jax-to-port" else
                (_engine(lm, name="x-src", **pkw),
                 _jax_engine(lm, name="x-dst", **jkw)))
    encode, decode_wire = ((jhttp.encode_kv_handoff, phttp.decode_kv_handoff)
                           if direction == "jax-to-port" else
                           (phttp.encode_kv_handoff,
                            jhttp.decode_kv_handoff))
    try:
        p = _prompt(14)
        want = np.asarray(src.submit({"tokens": p, "park_kv": True})
                          ["tokens"])[0].tolist()
        delivered = want[len(p):len(p) + 5]
        fetched = src.fetch_kv(
            {"tokens": np.asarray(list(p) + delivered, np.int32)})
        assert fetched["tokens_covered"] == 16
        side = fetched["kv_handoff"]["k"]
        assert isinstance(side, dict) == (pool == "int8")
        wire = json.dumps(encode(fetched["kv_handoff"]))
        got = dst.submit({"tokens": p, "resume_tokens": delivered,
                          "kv_handoff": decode_wire(json.loads(wire))})
        assert np.asarray(got["tokens"])[0].tolist() == want
        assert dst.stats()["handoff_pages_in"] == 4
        if pool == "model":
            assert want == lm[5](p)
    finally:
        src.close()
        dst.close()


def test_stats_keys_and_spill_counters_agree_with_jax(lm):
    """The same parked sessions and second turns through both engines:
    the same stats() keys, and equal spill, park and fetch counters."""
    def run(engine):
        try:
            turns = [np.asarray(engine.submit({
                "tokens": _prompt(9 + i), "park_kv": True})["tokens"])[0]
                for i in range(5)]
            for turn in turns:
                engine.submit({"tokens": np.concatenate(
                    [turn, _prompt(2, lo=90)])})
            engine.fetch_kv({"tokens": _prompt(9)})
            return engine.stats()
        finally:
            engine.close()

    port = run(_engine(lm, kv_pool_blocks=12, host_spill_blocks=40,
                       name="keys-port"))
    jax_ = run(_jax_engine(lm, kv_pool_blocks=12, host_spill_blocks=40,
                           name="keys-jax"))
    assert set(port) == set(jax_)
    for key in ("host_spill_blocks", "host_tier_used", "kv_spill_pages_out",
                "kv_spill_pages_in", "parked_sessions", "kv_fetches",
                "tokens_addressable", "kv_spill_ratio", "mesh_devices",
                "shed", "prefix_hits", "requests", "tokens"):
        assert port[key] == jax_[key], key
    assert port["kv_spill_pages_out"] > 0 and port["kv_spill_pages_in"] > 0


# -- over REST ----------------------------------------------------------------

def _request(port, path, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("pool", ["model", "int8"])
def test_rest_park_and_fetch_kv(lm, tmp_path, pool):
    """``park_kv`` through :predict and ``:fetch_kv``'s JAX answer: the
    engine's host-tier pages as a wire ``kv_handoff`` (int8 values and
    scales for an int8 pool), a miss as null, an ``engine.fetch`` fault
    as a 500."""
    from kubeflow_tpu.serving.export import export as jax_export
    from kubeflow_tpu_torch.serving import main as serving_main

    _, params, _, _, _, _ = lm
    config = {"model": dict(OVERRIDES, dtype="float32"),
              "max_new_tokens": NEW_TOKENS}
    if pool == "int8":
        config["kv_cache"] = "int8"
    base = tmp_path / "lm"
    jax_export(base, 1, {"params": params},
               loader="kubeflow_tpu.serving.loaders:lm_generate",
               config=config,
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base), "--port", "0",
        "--grpc_port", "-1",
        "--host", "127.0.0.1", "--device", "cpu", "--poll_interval_s", "60",
        "--kv_block_tokens", "4", "--prefill_chunk_tokens", "8",
        "--lm_buckets", "32", "--host_spill_blocks", "32"])
    port = httpd.server_address[1]
    try:
        p = _prompt(13).tolist()
        status, body = _request(port, "/model/lm:predict", {
            "instances": [{"tokens": p, "park_kv": True}]})
        assert status == 200
        context = body["predictions"][0]["tokens"][:len(p) + 3]
        status, body = _request(port, "/model/lm:fetch_kv",
                                {"tokens": context})
        assert status == 200 and body["tokens_covered"] == 16
        engine = server._batchers["lm"]
        want = engine.fetch_kv({"tokens": np.asarray(context, np.int32)})
        assert body == json.loads(json.dumps({
            "kv_handoff": phttp.encode_kv_handoff(want["kv_handoff"]),
            "tokens_covered": 16}))
        side = body["kv_handoff"]["k"]
        if pool == "int8":
            assert side["values"]["dtype"] == "int8"
            assert side["scale"]["dtype"] == "float32"
        else:
            assert side["dtype"] == "float32"
        assert _request(port, "/model/lm:fetch_kv",
                        {"tokens": _prompt(11).tolist()}) == (
            200, {"kv_handoff": None, "tokens_covered": 0})
        with faults.injected("engine.fetch:raise"):
            status, body = _request(port, "/model/lm:fetch_kv",
                                    {"tokens": context})
        assert status == 500 and "FaultInjected" in body["error"]
        assert engine.stats()["parked_sessions"] == 1
    finally:
        serving_main.shutdown(server, httpd)
