"""The port's serving path: export format, loader, and the REST server.

A version exported by the JAX package loads in the port; a port export
restores under flax; and the port's server (``--device cpu``, the
continuous-batching engine by default, its prefill width the largest
bucket) answers concurrent mixed-length :predict requests with the
tokens JAX generate() gives each prompt alone, then hot-swaps to a new
version dropped into its base path (rebuilding the engine around it).
The same burst and swap run through --lm_static_batcher's bucketed
static batcher."""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from kubeflow_tpu.models.generate import DecodeConfig as JaxDecodeConfig
from kubeflow_tpu.models.generate import generate as jax_generate
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.serving.export import export as jax_export
from kubeflow_tpu.serving.loaders import _model_config as jax_model_config
from kubeflow_tpu_torch.serving import export as port_export
from torch_lockcheck import lockcheck_order  # noqa: F401

# One intra-op thread a process: the suite runs as several processes on
# shared cores, where torch's OpenMP threads spin against each other.
torch.set_num_threads(1)

VOCAB, NEW = 128, 6
OVERRIDES = {"vocab_size": VOCAB, "d_model": 32, "n_layers": 2,
             "n_heads": 4, "n_kv_heads": 2, "d_ff": 64, "head_dim": 8,
             "max_seq_len": 64, "dtype": "float32", "attention": "flash"}
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
REPO = Path(__file__).resolve().parents[1]


def _variables(seed):
    cfg = jax_model_config(OVERRIDES)
    variables = JaxTransformer(cfg).init(jax.random.key(seed),
                                         np.zeros((1, 8), np.int32))
    return cfg, jax.tree.map(np.asarray, nn.unbox(variables))


def _export_jax(base, version, seed):
    cfg, variables = _variables(seed)
    jax_export(base, version, variables, loader=JAX_LOADER,
               config={"model": OVERRIDES, "max_new_tokens": NEW},
               signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    return cfg, variables["params"]


def _jax_tokens(cfg, params, prompt):
    out, _ = jax_generate(cfg, params, jnp.asarray([prompt], jnp.int32),
                          JaxDecodeConfig(max_new_tokens=NEW))
    return np.asarray(out)[0].tolist()


def _prompt(rng, n):
    return rng.integers(1, VOCAB, n).tolist()


def test_jax_export_loads_in_port(tmp_path):
    cfg, params = _export_jax(tmp_path / "lm", 1, seed=1)
    predict, meta = port_export.load_version(tmp_path / "lm", 1,
                                             device="cpu")
    assert meta["loader"] == JAX_LOADER and meta["version"] == 1
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, 9), _prompt(rng, 9)]
    got = predict({"tokens": np.asarray(prompts)})["tokens"]
    assert got.dtype == np.int32
    for row, prompt in zip(got.tolist(), prompts):
        assert row == _jax_tokens(cfg, params, prompt)


def test_port_export_restores_under_flax(tmp_path):
    _, variables = _variables(seed=2)
    tree = {"extra": {"a": torch.arange(6.0).reshape(2, 3),
                      "b": torch.ones(3, dtype=torch.bfloat16) * 1.5,
                      "c": np.arange(4, dtype=np.int32)},
            **variables}
    port_export.export(tmp_path / "m", 3, tree, loader=JAX_LOADER,
                       signature={"inputs": ["tokens"]})
    raw = (tmp_path / "m" / "3" / port_export.PARAMS_FILE).read_bytes()
    restored = serialization.msgpack_restore(raw)
    np.testing.assert_array_equal(restored["extra"]["a"],
                                  np.arange(6.0).reshape(2, 3))
    assert str(restored["extra"]["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(restored["extra"]["b"], np.float32), [1.5] * 3)
    np.testing.assert_array_equal(restored["extra"]["c"], np.arange(4))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        np.testing.assert_array_equal(
            _get(restored["params"], path), leaf)
    # ...and the port's own decoder reads back what flax would write.
    again = port_export.msgpack_restore(serialization.msgpack_serialize(
        restored))
    assert again["extra"]["b"].dtype == torch.bfloat16
    meta = json.loads((tmp_path / "m" / "3" / "model.json").read_text())
    assert meta["format"] == "kubeflow-tpu/1"


def _get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_loader_allowlist(tmp_path):
    with pytest.raises(PermissionError):
        port_export.resolve_loader("os:system")
    port_export.export(tmp_path / "x", 1, {"params": {}}, loader="os:system")
    with pytest.raises(PermissionError):
        port_export.load_version(tmp_path / "x", 1, device="cpu")


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture
def server(request, tmp_path):
    """The port's serving entry point in its own process, on the CPU;
    an indirect parameter adds flags to its command line."""
    extra = list(getattr(request, "param", []))
    base = tmp_path / "lm"
    cfg, params = _export_jax(base, 1, seed=3)
    log_path = tmp_path / "server.log"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
             "--model_name", "lm", "--model_base_path", str(base),
             "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
             "--device", "cpu",
             "--lm_buckets", "8,16,32", "--micro_batch_size", "4",
             "--batch_timeout_ms", "50", "--poll_interval_s", "0.2"]
            + extra,
            stderr=log, stdout=subprocess.DEVNULL, env=env, cwd=REPO)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            assert proc.poll() is None, log_path.read_text()
            for line in log_path.read_text().splitlines():
                if line.startswith("KFT_SERVING_READY"):
                    port = int(line.split("rest=")[1].split()[0])
            time.sleep(0.1)
        assert port is not None, log_path.read_text()
        yield port, base, cfg, params
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_rest_server_batches_and_hot_swaps(server):
    _batches_and_hot_swaps(server)


@pytest.mark.parametrize("server", [["--lm_static_batcher"]],
                         ids=["static"], indirect=True)
def test_static_batcher_batches_and_hot_swaps(server):
    """The same burst and swap through the bucketed static batcher: six
    prompts over the three buckets, and a batcher rebuilt around
    version 2."""
    _batches_and_hot_swaps(server)


def _batches_and_hot_swaps(server):
    port, base, cfg, params = server
    rng = np.random.default_rng(4)
    prompts = [_prompt(rng, n) for n in (3, 14, 7, 27, 9, 20)]
    results = [None] * len(prompts)

    def call(i):
        results[i] = _request(port, "POST", "/model/lm:predict",
                              {"instances": [{"tokens": prompts[i]}]})

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for prompt, (status, body) in zip(prompts, results):
        assert status == 200, body
        assert body["predictions"][0]["tokens"] == _jax_tokens(
            cfg, params, prompt)

    status, meta = _request(port, "GET", "/model/lm:metadata")
    assert status == 200
    assert meta["model_spec"]["version"] == "1"
    assert meta["metadata"]["signature"] == {"inputs": ["tokens"],
                                             "outputs": ["tokens"]}
    assert _request(port, "GET", "/readyz")[0] == 200
    assert _request(port, "GET", "/model/nope:metadata")[0] == 404
    assert _request(port, "POST", "/model/lm:predict", {})[0] == 400

    cfg2, params2 = _export_jax(base, 2, seed=4)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if _request(port, "GET", "/model/lm:metadata")[1][
                "model_spec"]["version"] == "2":
            break
        time.sleep(0.2)
    else:
        pytest.fail("watcher did not pick up version 2")
    status, body = _request(port, "POST", "/model/lm:predict",
                            {"instances": [{"tokens": prompts[1]}]})
    assert status == 200
    assert body["predictions"][0]["tokens"] == _jax_tokens(
        cfg2, params2, prompts[1])
