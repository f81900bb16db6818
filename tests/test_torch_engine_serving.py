"""The port's serving entry point on the DecodeEngine, over REST.

A JAX export served by ``kubeflow_tpu_torch.serving.main`` on the CPU
answers :predict through the continuous-batching engine by default, with
the tokens JAX generate() gives each prompt alone; prompts wider than the
engine's prefill width take the direct path; ``:stats`` returns the
engine's ``stats()``; ``--lm_static_batcher`` restores the static
bucketed batcher; the factory declines the engine when the export leaves
no prompt room; ``--mesh`` answers ``NotPortedError``; and a request
naming an adapter on a server without ``--adapters_dir`` answers 404."""

import http.client
import json
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models.generate import DecodeConfig as JaxDecodeConfig
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.serving import main as serving_main

VOCAB, NEW = 128, 6
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64, "dtype": "float32", "attention": "flash"}
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
WAIT_S = 60


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = jax_model_config(OVERRIDES)
    variables = jax.tree.map(np.asarray, nn.unbox(JaxTransformer(cfg).init(
        jax.random.key(5), np.zeros((1, 8), np.int32))))
    base = tmp_path_factory.mktemp("engine-serving") / "lm"
    jax_export(base, 1, variables, loader=JAX_LOADER,
               config={"model": OVERRIDES, "max_new_tokens": NEW},
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    return base, cfg, variables["params"]


def _jax_tokens(cfg, params, prompt):
    out, _ = jax_generate(cfg, params, jnp.asarray([prompt], jnp.int32),
                          JaxDecodeConfig(max_new_tokens=NEW))
    return np.asarray(out)[0].tolist()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _start(base, *flags):
    return serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base), "--port", "0",
        "--host", "127.0.0.1", "--device", "cpu", "--poll_interval_s", "60",
        *flags])


def _predict_all(port, prompts):
    results = [None] * len(prompts)

    def call(i):
        results[i] = _request(port, "POST", "/model/lm:predict",
                              {"instances": [{"tokens": prompts[i]}]})

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    return results


def test_predict_through_the_engine_by_default(exported):
    base, cfg, params = exported
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, VOCAB, n).tolist() for n in (3, 14, 7, 27)]
    server, httpd = _start(base, "--lm_buckets", "8,16,32",
                           "--kv_block_tokens", "4",
                           "--prefill_chunk_tokens", "8")
    port = httpd.server_address[1]
    try:
        for prompt, (status, body) in zip(prompts,
                                          _predict_all(port, prompts)):
            assert status == 200, body
            assert body["predictions"][0]["tokens"] == _jax_tokens(
                cfg, params, prompt)
        # A prompt wider than the prefill width (the largest bucket, 32)
        # takes the direct generate() path.
        wide = rng.integers(1, VOCAB, 40).tolist()
        status, body = _request(port, "POST", "/model/lm:predict",
                                {"instances": [{"tokens": wide}]})
        assert status == 200
        assert body["predictions"][0]["tokens"] == _jax_tokens(
            cfg, params, wide)
        # The same prompt again resumes from its cached prefix.
        _predict_all(port, prompts[1:2])
        status, stats = _request(port, "GET", "/model/lm:stats")
        assert status == 200
        assert stats["model_spec"] == {"name": "lm", "version": "1"}
        engine = stats["batcher"]
        assert engine["requests"] == len(prompts) + 1
        assert engine["slots"] == 8 and engine["decode_rounds"] == 8
        assert engine["prefix_hits"] >= 1
        assert engine["compiled_programs"] == {
            "chunked_prefill": 1, "step": 0, "verify": 0,
            "decode_rounds": 1}
        assert _request(port, "GET", "/model/nope:stats")[0] == 404
        # A request naming an adapter on a server without an adapter
        # directory: 404 (never base weights), and the engine serves on.
        status, body = _request(port, "POST", "/model/lm:predict", {
            "instances": [{"tokens": prompts[0], "adapter": "tenant"}]})
        assert status == 404 and "serves no adapters" in body["error"]
        status, body = _request(port, "POST", "/model/lm@tenant:predict", {
            "instances": [{"tokens": prompts[0]}]})
        assert status == 404 and "serves no adapters" in body["error"]
        assert _predict_all(port, prompts[:1])[0][0] == 200
    finally:
        serving_main.shutdown(server, httpd)


def test_static_batcher_flag_restores_bucketed_batching(exported):
    base, cfg, params = exported
    prompts = [list(range(1, 6)), list(range(3, 14))]
    server, httpd = _start(base, "--lm_static_batcher", "--lm_buckets",
                           "8,16", "--micro_batch_size", "4",
                           "--batch_timeout_ms", "50")
    port = httpd.server_address[1]
    try:
        for prompt, (status, body) in zip(prompts,
                                          _predict_all(port, prompts)):
            assert status == 200, body
            assert body["predictions"][0]["tokens"] == _jax_tokens(
                cfg, params, prompt)
        status, stats = _request(port, "GET", "/model/lm:stats")
        assert status == 200
        assert stats["batcher"]["batches"] >= 1
        assert "slots" not in stats["batcher"]
    finally:
        serving_main.shutdown(server, httpd)


def test_static_batcher_flag_alone_serves_direct(exported):
    base, cfg, params = exported
    server, httpd = _start(base, "--lm_static_batcher")
    port = httpd.server_address[1]
    try:
        status, body = _request(port, "POST", "/model/lm:predict",
                                {"instances": [{"tokens": [5, 6, 7]}]})
        assert status == 200
        assert body["predictions"][0]["tokens"] == _jax_tokens(
            cfg, params, [5, 6, 7])
        assert _request(port, "GET", "/model/lm:stats")[1]["batcher"] \
            is None
    finally:
        serving_main.shutdown(server, httpd)


def test_factory_declines_engine_without_prompt_room():
    def predict(inputs):
        return inputs

    predict.engine_spec = {
        "cfg": SimpleNamespace(max_seq_len=64),
        "decode": SimpleNamespace(max_new_tokens=64),
        "model": None,
    }
    model = SimpleNamespace(name="lm", version=1, predict=predict,
                            meta={"loader": JAX_LOADER})
    factory = serving_main.batcher_factory(micro_batch_size=0,
                                           batch_timeout_s=0.01)
    assert factory(model) is None  # direct path, no crash


# The id the case had beside the --speculative_tokens, --host_spill_blocks
# and --adapters_dir cases, which left with the refusals they checked.
@pytest.mark.parametrize("flags,item", [
    (["--mesh", "tensor=2"], 6),
], ids=["flags3-6"])
def test_later_slice_flags_raise_not_ported(exported, flags, item):
    with pytest.raises(NotPortedError, match=f"ROADMAP queue 1 item {item}"):
        _start(exported[0], *flags)
