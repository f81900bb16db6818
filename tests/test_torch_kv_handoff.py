"""The port's disaggregated prefill/decode tiers against the JAX package's.

``gather_kv_pages`` and ``import_kv_pages`` go through both packages on
the same paged state.  One LM is exported once per dtype (float32 and
bfloat16) and loaded by each package's own loader; prefill-tier exports
of one package are imported by decode-tier engines of both:

  - at every page-coverage cut, the tiered tokens equal the unified
    engine's and ``generate()``'s (tests/test_sharding.py's handoff
    cuts);
  - across the packages, both ways, the wire JSON is byte-equal, the
    imported pages equal the exported bytes, and the decode tier gives
    the unified tokens of the exporting package, which equal the other
    package's at both dtypes;
  - a geometry or dtype mismatch is a ValueError (400 over REST), a
    prompt shorter than one page plus a token exports nothing, and the
    fault site ``engine.kv_handoff`` fires on both sides;
  - ``submit_stream`` yields exactly the suffix, and over REST the
    :prefill route, the NDJSON :generate route (with and without a
    payload), ``role`` on /readyz and a :fetch_kv miss (the host spill
    tier's fetch is tests/test_torch_kv_spill.py's)."""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving import http as jhttp
from kubeflow_tpu.serving.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.export import load_version as jax_load_version
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.models import generate as pgen
from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
from kubeflow_tpu_torch.models.transformer import Transformer, TransformerConfig
from kubeflow_tpu_torch.serving import http as phttp
from kubeflow_tpu_torch.serving import main as serving_main
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.export import load_version
from kubeflow_tpu_torch.testing import faults

SEED = 20261019
VOCAB, NEW = 128, 8
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64}
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
BT = 4
GEOMETRY = dict(slots=2, prefill_len=32, prefill_chunk_tokens=8,
                kv_block_tokens=BT)
WAIT_S = 60


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, n).tolist()


_EXPORTS = {}


def _exported(tmp_path_factory, dtype):
    """One export per dtype, loaded by both packages' loaders."""
    if dtype in _EXPORTS:
        return _EXPORTS[dtype]
    overrides = dict(OVERRIDES, dtype=dtype)
    cfg = jax_model_config(overrides)
    variables = jax.tree.map(np.asarray, nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))))
    base = tmp_path_factory.mktemp(f"handoff-{dtype}") / "lm"
    jax_export(base, 1, variables, loader=JAX_LOADER,
               config={"model": overrides, "max_new_tokens": NEW},
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    jpredict, _ = jax_load_version(base, 1)
    ppredict, _ = load_version(base, 1, device="cpu")
    _EXPORTS[dtype] = {"dtype": dtype, "base": base,
                       "jax": jpredict.engine_spec,
                       "port": ppredict.engine_spec}
    return _EXPORTS[dtype]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request, tmp_path_factory):
    return _exported(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def lm32(tmp_path_factory):
    return _exported(tmp_path_factory, "float32")


def _port_engine(lm, **kw):
    spec = lm["port"]
    return DecodeEngine(spec["model"], spec["decode"],
                        **dict(GEOMETRY, **kw))


def _jax_engine(lm, **kw):
    spec = lm["jax"]
    kw.setdefault("name", "jax-handoff")
    return JaxDecodeEngine(spec["cfg"], spec["params"], spec["decode"],
                           **dict(GEOMETRY, **kw))


def _tokens(out):
    return np.asarray(out["tokens"])[0].tolist()


def _closing(engine, fn):
    try:
        return fn(engine)
    finally:
        engine.close()


def _wire_json(encode, payload):
    return json.dumps(encode(payload), sort_keys=False)


# -- the page programs ------------------------------------------------------

def test_gather_and_import_pages_match_jax():
    jcfg = jax_model_config(dict(OVERRIDES, dtype="float32"))
    tree = jax.tree.map(np.asarray, nn.unbox(JaxTransformer(jcfg).init(
        jax.random.key(1), np.zeros((1, 8), np.int32)))["params"])
    model = load_params(
        Transformer(TransformerConfig(dtype=torch.float32, **OVERRIDES),
                    device="meta"), params_from_jax(tree))
    nb = 10
    js = jgen.init_paged_state(jcfg, 1, nb, BT)
    ps = pgen.init_paged_state(model.cfg, 1, nb, BT, device="cpu")
    rng = np.random.default_rng(2)
    shape = (OVERRIDES["n_layers"], 5, BT, OVERRIDES["n_kv_heads"],
             OVERRIDES["head_dim"])
    pages_k = rng.standard_normal(shape).astype(np.float32)
    pages_v = rng.standard_normal(shape).astype(np.float32)
    # Three real ids, then the sentinel padding of a span of five.
    ids = np.asarray([7, 2, 4, nb, nb], np.int32)
    js = jgen.import_kv_pages(js, jnp.asarray(pages_k), jnp.asarray(pages_v),
                              jnp.asarray(ids))
    pgen.import_kv_pages(ps, torch.from_numpy(pages_k),
                         torch.from_numpy(pages_v), torch.from_numpy(ids))
    for name in ("cache_k", "cache_v"):
        np.testing.assert_array_equal(ps[name].numpy(),
                                      np.asarray(js[name]))
    untouched = [b for b in range(nb) if b not in (7, 2, 4)]
    assert not ps["cache_k"][:, untouched].any()
    (jk, _), (jv, _) = jgen.gather_kv_pages(js, [4, 7])
    (pk, ks), (pv, vs) = pgen.gather_kv_pages(ps, [4, 7])
    assert ks is None and vs is None
    np.testing.assert_array_equal(pk.numpy(), jk)
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(pk.numpy(), pages_k[:, [2, 0]])


# -- one package's tiers ------------------------------------------------------

def test_import_identity_at_every_coverage_cut(lm):
    prompt = _prompt(16, 3)             # 4-token pages: up to 3 full pages
    unified = _closing(_port_engine(lm, name="uni"), lambda e: _tokens(
        e.submit({"tokens": np.asarray(prompt, np.int32)})))
    if lm["dtype"] == "float32":
        want, _ = pgen.generate(lm["port"]["model"], torch.tensor([prompt]),
                                lm["port"]["decode"])
        assert unified == want[0].tolist()

    def export(engine):
        out = engine.prefill_export({"tokens": np.asarray(prompt, np.int32)})
        return out, engine.stats()

    out, stats = _closing(_port_engine(lm, name="pre"), export)
    ho = out["kv_handoff"]
    assert ho["tokens_covered"] == 12 and ho["block_tokens"] == BT
    assert tuple(ho["k"].shape) == (2, 3, BT, 2, 8)
    assert ho["k"].dtype == lm["port"]["model"].cfg.dtype
    assert len(_tokens(out)) == len(prompt) + 1
    assert stats["handoff_pages_out"] == 3
    for n in range(1, 4):
        cut = {"block_tokens": BT, "tokens_covered": n * BT,
               "k": ho["k"][:, :n], "v": ho["v"][:, :n]}

        def decode(engine):
            got = _tokens(engine.submit({
                "tokens": np.asarray(prompt, np.int32), "kv_handoff": cut}))
            return got, engine.stats(), engine.compiled_programs()

        got, dstats, programs = _closing(
            _port_engine(lm, prefix_caching=False, name=f"dec{n}"), decode)
        assert got == unified, f"handoff diverged at {n}-page coverage"
        assert dstats["handoff_pages_in"] == n
        assert programs["kv_import"] == 1


def test_imported_pages_are_the_exported_bytes(lm):
    prompt = _prompt(15, 4)
    out = _closing(_port_engine(lm, name="pre-bytes"), lambda e:
                   e.prefill_export({"tokens": np.asarray(prompt, np.int32)}))
    ho = out["kv_handoff"]
    engine = _port_engine(lm, slots=1, prefix_caching=False,
                          name="dec-bytes")
    try:
        engine.submit({"tokens": np.asarray(prompt, np.int32),
                       "max_new_tokens": 1, "kv_handoff": ho})
        # The delivered request's table row and pages stay as they were
        # until the slot's next admission.
        (k, _), (v, _) = pgen.gather_kv_pages(engine._state,
                                              engine._tables[0][:3])
    finally:
        engine.close()
    assert torch.equal(k, ho["k"]) and torch.equal(v, ho["v"])


def test_short_prompt_exports_nothing_and_mismatches_raise(lm):
    engine = _port_engine(lm, name="short")
    try:
        out = engine.prefill_export({"tokens": np.arange(1, 5,
                                                         dtype=np.int32)})
        assert "kv_handoff" not in out
        assert engine.stats()["handoff_pages_out"] == 0
        prompt = np.asarray(_prompt(13, 5), np.int32)
        ho = engine.prefill_export({"tokens": prompt})["kv_handoff"]
        good = {"block_tokens": BT, "k": ho["k"], "v": ho["v"]}
        bad = [
            dict(good, block_tokens=8),
            dict(good, k=ho["k"][:1]),
            dict(good, v=ho["v"][:, :2]),
            dict(good, k=ho["k"].to(torch.int32)),
            dict(good, k={"values": ho["k"], "scale": ho["k"][..., 0]}),
            "not an object",
        ]
        for payload in bad:
            with pytest.raises(ValueError):
                engine.submit({"tokens": prompt, "kv_handoff": payload})
        # A payload covering nothing importable (a one-page prompt).
        out = engine.submit({"tokens": prompt[:4],
                             "kv_handoff": good, "max_new_tokens": 2})
        assert len(_tokens(out)) == 6
        assert engine.stats()["handoff_pages_in"] == 0
    finally:
        engine.close()
    # The JAX engine refuses the same geometry mismatches.
    jengine = _jax_engine(lm)
    try:
        for payload in bad[:3]:
            jpayload = {key: (val.float().numpy()
                              if isinstance(val, torch.Tensor) else val)
                        for key, val in payload.items()}
            with pytest.raises(ValueError):
                jengine.submit({"tokens": prompt, "kv_handoff": jpayload})
    finally:
        jengine.close()


def test_fault_site_fires_on_export_and_import(lm):
    prompt = np.asarray(_prompt(14, 6), np.int32)
    engine = _port_engine(lm, name="faulty")
    try:
        with faults.injected("engine.kv_handoff:sleep=0.001") as inj:
            ho = engine.prefill_export({"tokens": prompt})["kv_handoff"]
            engine.submit({"tokens": prompt, "kv_handoff": ho})
            assert inj.fired("engine.kv_handoff") == 2
    finally:
        engine.close()
    engine = _port_engine(lm, name="faulty-raise")
    try:
        with faults.injected("engine.kv_handoff:raise*1"):
            with pytest.raises(faults.FaultInjected):
                engine.submit({"tokens": prompt, "kv_handoff": ho})
    finally:
        engine.close()


def test_submit_stream_yields_exactly_the_suffix(lm):
    prompt = _prompt(11, 7)
    engine = _port_engine(lm, name="stream")
    try:
        full = _tokens(engine.submit({"tokens": np.asarray(prompt,
                                                           np.int32)}))
        meta, stream = engine.submit_stream(
            {"tokens": np.asarray(prompt, np.int32)})
        chunks = list(stream)
        assert meta == {"resumable": True, "seeded": False,
                        "prompt_tokens": 11, "max_new_tokens": NEW}
        assert [t for c in chunks for t in c] == full[len(prompt):]
        assert all(chunks)
        meta, stream = engine.submit_stream(
            {"tokens": np.asarray(prompt, np.int32),
             "resume_tokens": full[11:14]})
        assert meta["max_new_tokens"] == NEW - 3
        assert [t for c in stream for t in c] == full[14:]
    finally:
        engine.close()


# -- across the packages ----------------------------------------------------

def test_jax_prefill_tier_to_port_decode_tier(lm):
    prompt = _prompt(14, 8)
    jout = _closing(_jax_engine(lm), lambda e: e.prefill_export(
        {"tokens": np.asarray(prompt, np.int32)}))
    jax_unified = _closing(_jax_engine(lm, name="jax-uni"), lambda e: _tokens(
        e.submit({"tokens": np.asarray(prompt, np.int32)})))
    port_unified = _closing(_port_engine(lm, name="port-uni"), lambda e:
                            _tokens(e.submit({"tokens": np.asarray(
                                prompt, np.int32)})))
    wire = _wire_json(jhttp.encode_kv_handoff, jout["kv_handoff"])
    payload = phttp.decode_kv_handoff(json.loads(wire))
    # The port re-encodes the decoded pages to the same bytes.
    assert _wire_json(phttp.encode_kv_handoff, dict(
        payload, tokens_covered=jout["kv_handoff"]["tokens_covered"])) == wire
    assert payload["k"].dtype == lm["port"]["model"].cfg.dtype

    def decode(engine):
        got = _tokens(engine.submit({"tokens": np.asarray(prompt, np.int32),
                                     "kv_handoff": payload}))
        (k, _), (v, _) = pgen.gather_kv_pages(engine._state,
                                              engine._tables[0][:3])
        return got, k, v

    got, k, v = _closing(_port_engine(lm, slots=1, prefix_caching=False,
                                      name="port-dec"), decode)
    assert torch.equal(k, payload["k"]) and torch.equal(v, payload["v"])
    assert port_unified == jax_unified
    assert got == jax_unified


def test_port_prefill_tier_to_jax_decode_tier(lm):
    prompt = _prompt(13, 9)
    pout = _closing(_port_engine(lm, name="port-pre"), lambda e:
                    e.prefill_export({"tokens": np.asarray(prompt,
                                                           np.int32)}))
    port_unified = _closing(_port_engine(lm, name="port-uni2"), lambda e:
                            _tokens(e.submit({"tokens": np.asarray(
                                prompt, np.int32)})))
    jax_unified = _closing(_jax_engine(lm, name="jax-uni2"), lambda e:
                           _tokens(e.submit({"tokens": np.asarray(
                               prompt, np.int32)})))
    wire = _wire_json(phttp.encode_kv_handoff, pout["kv_handoff"])
    payload = jhttp.decode_kv_handoff(json.loads(wire))
    assert str(payload["k"].dtype) == lm["dtype"]
    assert _wire_json(jhttp.encode_kv_handoff, dict(
        payload, tokens_covered=pout["kv_handoff"]["tokens_covered"])) == wire
    got = _closing(_jax_engine(lm, prefix_caching=False, name="jax-dec"),
                   lambda e: (_tokens(e.submit({
                       "tokens": np.asarray(prompt, np.int32),
                       "kv_handoff": payload})), e.stats()))
    assert got[1]["handoff_pages_in"] == 3
    assert jax_unified == port_unified
    assert got[0] == port_unified


# -- over REST ----------------------------------------------------------------

def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        if resp.getheader("Content-Type") == "application/x-ndjson":
            return resp.status, [json.loads(line)
                                 for line in raw.splitlines() if line]
        return resp.status, json.loads(raw)
    finally:
        conn.close()


def _start(base, role):
    return serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base), "--port", "0",
        "--grpc_port", "-1",
        "--host", "127.0.0.1", "--device", "cpu", "--poll_interval_s", "60",
        "--kv_block_tokens", str(BT), "--prefill_chunk_tokens", "8",
        "--lm_buckets", "32", "--role", role])


def test_rest_tiers(lm32):
    lm = lm32
    prompt = _prompt(14, 10)
    pre, pre_httpd = _start(lm["base"], "prefill")
    dec, dec_httpd = _start(lm["base"], "decode")
    pre_port = pre_httpd.server_address[1]
    dec_port = dec_httpd.server_address[1]
    try:
        for port, role in ((pre_port, "prefill"), (dec_port, "decode")):
            status, body = _request(port, "GET", "/readyz")
            assert status == 200 and body["role"] == role
        status, unified = _request(dec_port, "POST", "/model/lm:predict",
                                   {"instances": [{"tokens": prompt}]})
        assert status == 200
        unified = unified["predictions"][0]["tokens"]
        status, body = _request(pre_port, "POST", "/model/lm:prefill",
                                {"tokens": prompt})
        assert status == 200 and body["tokens_covered"] == 12
        assert body["kv_handoff"]["k"]["dtype"] == "float32"
        status, lines = _request(dec_port, "POST", "/model/lm:generate",
                                 {"tokens": prompt,
                                  "kv_handoff": body["kv_handoff"]})
        assert status == 200
        assert lines[0]["meta"]["prompt_tokens"] == len(prompt)
        assert lines[-1] == {"done": True, "tokens_emitted": NEW}
        streamed = [t for line in lines[1:-1] for t in line["tokens"]]
        assert prompt + streamed == unified
        # Streaming without a payload, and a short prompt's null export.
        status, lines = _request(dec_port, "POST", "/model/lm:generate",
                                 {"tokens": prompt})
        assert [t for line in lines[1:-1] for t in line["tokens"]] \
            == unified[len(prompt):]
        status, body = _request(pre_port, "POST", "/model/lm:prefill",
                                {"tokens": prompt[:3]})
        assert status == 200 and body == {"kv_handoff": None,
                                          "tokens_covered": 0}
        stats = _request(dec_port, "GET", "/model/lm:stats")[1]["batcher"]
        assert stats["handoff_pages_in"] == 3
        assert stats["compiled_programs"]["kv_import"] == 1
        # Typed errors: a mismatched payload is a 400 before any token, an
        # unknown model a 404; a server without a host spill tier answers
        # :fetch_kv with a miss.
        status, body = _request(dec_port, "POST", "/model/lm:generate", {
            "tokens": prompt, "kv_handoff": {"block_tokens": 8}})
        assert status == 400
        status, body = _request(dec_port, "POST", "/model/lm:fetch_kv",
                                {"tokens": prompt})
        assert status == 200 and body == {"kv_handoff": None,
                                          "tokens_covered": 0}
        assert _request(dec_port, "POST", "/model/nope:generate",
                        {"tokens": prompt})[0] == 404
    finally:
        serving_main.shutdown(pre, pre_httpd)
        serving_main.shutdown(dec, dec_httpd)

