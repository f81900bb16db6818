"""The port's ``model@adapter`` wire against the JAX package's.

The twins of tests/test_adapters.py's TestModelAdapterRouting at its toy
size (vocab 96, d_model 32, 2 layers, float32, rank 4), one JAX export
and one adapter directory (written by the JAX package's
``save_adapter``) served by both packages' ``ModelServer`` on the
continuous-batching engine: ``lm@alpha`` resolves through ModelServer to
the engine (:predict and streaming) with JAX's tokens, unknown adapters
and models answer 404, and a request naming an adapter never falls
through to base weights, on the direct path or the static batcher.  Over
REST, ``python -m kubeflow_tpu_torch.serving.main --device cpu
--adapters_dir`` serves ``:predict``, ``:generate`` and ``:prefill``
under ``lm@adapter``, and ``/readyz`` advertises the resident
adapters."""

import http.client
import json
import threading

import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving import adapters as jad
from kubeflow_tpu.serving import main as jax_main
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu.serving.model_server import ModelServer as JaxModelServer
from kubeflow_tpu_torch.serving import main as serving_main
from kubeflow_tpu_torch.serving.adapters import AdapterNotFound
from kubeflow_tpu_torch.serving.model_server import ModelServer

SEED = 20260807
VOCAB, NEW_TOKENS = 96, 10
RANK = 4
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64, "dtype": "float32"}
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
WAIT_S = 60


def _prompt(n, seed):
    return np.random.RandomState(SEED + seed).randint(
        1, VOCAB, size=(n,)).astype(np.int32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = jax_model_config(OVERRIDES)
    variables = jax.tree.map(np.asarray, nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(SEED), np.zeros((1, 8), np.int32))))
    base = tmp_path_factory.mktemp("adapter-models") / "lm"
    jax_export(base, 1, variables, loader=JAX_LOADER,
               config={"model": OVERRIDES, "max_new_tokens": NEW_TOKENS,
                       "temperature": 0.0},
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    adir = tmp_path_factory.mktemp("adapters")
    for i, name in enumerate(("alpha", "beta")):
        jad.save_adapter(str(adir / f"{name}.npz"),
                         jad.random_adapter_factors(cfg, RANK,
                                                    SEED + 100 + i,
                                                    scale=0.5))
    return base, adir


def _factory_kw(adir):
    return dict(micro_batch_size=0, batch_timeout_s=0.005, lm_engine=True,
                lm_engine_slots=2, lm_engine_prefill_len=16,
                prefill_chunk_tokens=4, kv_block_tokens=4,
                adapters_dir=str(adir), adapter_slots=4, adapter_rank=RANK)


@pytest.fixture(scope="module")
def servers(exported):
    """The port's ModelServer and JAX's over the same export and adapter
    directory, each on its engine."""
    base, adir = exported
    port = ModelServer(device="cpu")
    port.add_model("lm", str(base))
    port.enable_batching("lm", serving_main.batcher_factory(
        **_factory_kw(adir)))
    jax_server = JaxModelServer()
    jax_server.add_model("lm", str(base))
    jax_server.enable_batching("lm", jax_main.batcher_factory(
        **_factory_kw(adir)))
    yield port, jax_server
    port.stop()
    jax_server.stop()


def _tokens(out):
    return np.asarray(out["tokens"])[0].tolist()


class TestModelAdapterRouting:
    @pytest.mark.parametrize("name", ["lm@alpha", "lm@beta", "lm"])
    def test_predict_resolves_adapter_and_matches_jax(self, servers, name):
        port, jax_server = servers
        prompt = _prompt(9, 17)
        got = _tokens(port.predict(name, {"tokens": prompt[None]}))
        want = _tokens(jax_server.predict(name, {"tokens": prompt[None]}))
        assert got == want
        if name != "lm":
            assert got != _tokens(port.predict("lm",
                                               {"tokens": prompt[None]}))

    def test_mixed_concurrent_traffic_matches_jax(self, servers):
        """Base and both variants at once through one engine: each
        request's tokens equal JAX's for it, served one at a time."""
        port, jax_server = servers
        work = [(name, _prompt(n, 20 + i)) for i, (name, n) in enumerate(
            [("lm", 7), ("lm@alpha", 12), ("lm@beta", 4), ("lm@alpha", 9),
             ("lm", 14), ("lm@beta", 11)])]
        outs = [None] * len(work)

        def call(i):
            name, prompt = work[i]
            outs[i] = _tokens(port.predict(name, {"tokens": prompt[None]}))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        for (name, prompt), out in zip(work, outs):
            assert out == _tokens(jax_server.predict(
                name, {"tokens": prompt[None]})), name

    def test_unknown_adapter_is_404(self, servers):
        port, _ = servers
        prompt = _prompt(5, 1)
        with pytest.raises(AdapterNotFound):
            port.predict("lm@ghost", {"tokens": prompt[None]})
        with pytest.raises(KeyError):
            port.predict("nope@alpha", {"tokens": prompt[None]})

    def test_has_model_and_readyz_advertisement(self, servers):
        port, jax_server = servers
        prompt = _prompt(6, 2)
        for server in servers:
            server.predict("lm@alpha", {"tokens": prompt[None]})
        assert port.has_model("lm@anything") and port.has_model("lm")
        assert not port.has_model("nope@alpha")
        info = port.adapter_info()
        theirs = jax_server.adapter_info()
        assert "alpha" in {a["name"] for a in info["lm"]}
        assert {(a["name"], a["digest"]) for a in info["lm"]} == \
            {(a["name"], a["digest"]) for a in theirs["lm"]}

    def test_generate_stream_carries_adapter(self, servers):
        port, jax_server = servers
        prompt = _prompt(10, 19)
        meta, stream = port.generate_stream("lm@beta", {"tokens": prompt})
        toks = [t for chunk in stream for t in chunk]
        assert meta["resumable"]
        assert prompt.tolist() + toks == _tokens(jax_server.predict(
            "lm@beta", {"tokens": prompt[None]}))

    def test_fetch_kv_drops_the_adapter_name(self, servers):
        port, _ = servers
        assert port.fetch_kv("lm@alpha", {"tokens": _prompt(8, 3)}) == {
            "kv_handoff": None, "tokens_covered": 0}


def test_direct_path_never_serves_base_for_adapter(exported):
    """A model without the engine refuses ``model@adapter`` (404) rather
    than decode base weights for a tenant."""
    base, _ = exported
    server = ModelServer(device="cpu")
    server.add_model("lm", str(base))
    try:
        prompt = _prompt(5, 4)
        with pytest.raises(AdapterNotFound):
            server.predict("lm@alpha", {"tokens": prompt[None]})
        assert len(_tokens(server.predict(
            "lm", {"tokens": prompt[None]}))) == 5 + NEW_TOKENS
    finally:
        server.stop()


def test_static_batcher_never_serves_base_for_adapter(exported):
    base, adir = exported
    server = ModelServer(device="cpu")
    server.add_model("lm", str(base))
    server.enable_batching("lm", serving_main.batcher_factory(
        micro_batch_size=2, batch_timeout_s=0.005, lm_buckets="16",
        lm_engine=False, adapters_dir=str(adir)))
    try:
        prompt = _prompt(5, 5)
        with pytest.raises(AdapterNotFound):
            server.predict("lm@alpha", {"tokens": prompt[None]})
        assert server.batcher_stats("lm")["batches"] == 0
        assert len(_tokens(server.predict(
            "lm", {"tokens": prompt[None]}))) == 5 + NEW_TOKENS
    finally:
        server.stop()


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


def test_rest_model_at_adapter(exported, servers):
    """``--adapters_dir`` over REST: :predict, the NDJSON :generate and a
    :prefill handoff resumed under ``lm@alpha`` give JAX's tokens,
    ``/readyz`` lists the resident adapters, and an unknown adapter
    answers 404."""
    base, adir = exported
    _, jax_server = servers
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base), "--port", "0",
        "--host", "127.0.0.1", "--device", "cpu", "--poll_interval_s", "60",
        "--lm_buckets", "16", "--kv_block_tokens", "4",
        "--prefill_chunk_tokens", "4", "--adapters_dir", str(adir),
        "--adapter_slots", "4", "--adapter_rank", str(RANK)])
    port = httpd.server_address[1]
    try:
        prompt = _prompt(11, 30)
        want = {name: _tokens(jax_server.predict(
            name, {"tokens": prompt[None]})) for name in ("lm", "lm@alpha")}
        assert want["lm"] != want["lm@alpha"]
        for name in ("lm@alpha", "lm"):
            status, body = _request(port, "POST", f"/model/{name}:predict",
                                    {"instances": [{"tokens":
                                                    prompt.tolist()}]})
            assert status == 200, body
            assert body["predictions"][0]["tokens"] == want[name]
        status, lines = _request(port, "POST", "/model/lm@alpha:generate",
                                 {"tokens": prompt.tolist()})
        assert status == 200 and lines[-1]["done"]
        assert prompt.tolist() + [t for line in lines[1:-1]
                                  for t in line["tokens"]] == want["lm@alpha"]
        status, handoff = _request(port, "POST", "/model/lm@alpha:prefill",
                                   {"tokens": prompt.tolist()})
        assert status == 200 and handoff["tokens_covered"] == 8
        status, lines = _request(port, "POST", "/model/lm@alpha:generate",
                                 {"tokens": prompt.tolist(),
                                  "kv_handoff": handoff["kv_handoff"]})
        assert status == 200
        assert prompt.tolist() + [t for line in lines[1:-1]
                                  for t in line["tokens"]] == want["lm@alpha"]
        status, body = _request(port, "GET", "/readyz")
        assert status == 200
        assert {a["name"] for a in body["adapters"]["lm"]} == {"alpha"}
        status, body = _request(port, "POST", "/model/lm@ghost:predict",
                                {"instances": [{"tokens": [1, 2, 3]}]})
        assert status == 404 and "ghost" in body["error"]
        assert _request(port, "POST", "/model/lm@ghost:generate",
                        {"tokens": [1, 2, 3]})[0] == 404
        stats = _request(port, "GET", "/model/lm:stats")[1]["batcher"]
        assert stats["adapters"]["adapters_resident"] == 1
        assert stats["compiled_programs"]["chunked_prefill"] == 1
    finally:
        serving_main.shutdown(server, httpd)
